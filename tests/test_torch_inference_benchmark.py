"""The PyTorch port's inference benchmark against the JAX package's
(``neuronx_distributed_tpu/inference/benchmark.py``): the latency report
and the JSON line exactly equal on the same latencies and suite, the decode
suite's keys, and the command line on the CPU."""

import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import benchmark as jb
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import benchmark as tb
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 20), (3, 101)])
def test_latency_report_equals_jax(seed, n):
    secs = np.random.RandomState(seed).exponential(0.01, n)
    j, t = jb.LatencyCollector(), tb.LatencyCollector()
    for s in secs:
        j.record(float(s))
        t.record(float(s))
    assert t.report() == j.report()
    assert t.percentile(75) == j.percentile(75)
    assert t.latencies_ms == j.latencies_ms


@pytest.mark.parametrize("platform", ["", "gpu", "cpu"])
def test_json_line_equals_jax(platform):
    rng = np.random.RandomState(5)
    suite = {"greedy": {"n": 3, "mean_ms": float(rng.rand()) * 100,
                        "p50_ms": 12.3456789, "p90_ms": 20.0,
                        "p99_ms": float(rng.rand()), "tokens_per_sec":
                        1234.56789, "ttft_ms": 3.14159, "ttft_p99_ms": 9.0},
             "speculative": {"n": 3, "mean_ms": 50.00001, "p50_ms": 49.0,
                             "p90_ms": 51.0, "p99_ms": 52.5,
                             "tokens_per_sec": 2000.004}}
    js, ts = io.StringIO(), io.StringIO()
    assert (tb.emit_json_line(suite, platform, stream=ts)
            == jb.emit_json_line(suite, platform, stream=js))
    assert ts.getvalue() == js.getvalue()
    assert ts.getvalue().count("\n") == 1


def test_benchmark_times_every_run():
    calls = []
    rep = tb.benchmark(lambda: calls.append(1), n_runs=5, warmup=2)
    assert len(calls) == 7
    assert rep["n"] == 5 and rep["p50_ms"] >= 0
    assert set(rep) == {"n", "mean_ms", "p50_ms", "p90_ms", "p99_ms"}


def test_decode_suite_keys_equal_jax():
    """JAX's smoke case (tests/test_inference.py, slow-marked there) on
    both packages at the smallest size: the same entries and fields."""
    ps.initialize_model_parallel()
    cfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                         num_layers=1)
    params = meta.unbox(jl.LlamaForCausalLM(cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    kw = dict(batch=1, prompt_len=8, new_tokens=2, n_runs=1, buckets=(8,))
    jrep = jb.decode_benchmark_suite(cfg, params, draft_cfg=cfg,
                                     draft_params=params, **kw)
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    sd = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    trep = tb.decode_benchmark_suite(tcfg, sd, draft_cfg=tcfg,
                                     draft_params=sd, device="cpu", **kw)
    assert set(trep) == set(jrep) == {"greedy", "speculative"}
    for name in trep:
        assert set(trep[name]) == set(jrep[name]), name
        assert trep[name]["tokens_per_sec"] > 0
    with pytest.raises(ValueError, match="together"):
        tb.decode_benchmark_suite(tcfg, sd, draft_cfg=tcfg, device="cpu")


def test_cli_prints_one_line_on_the_cpu(capsys):
    tb.main(["--device", "cpu", "--n-runs", "1", "--new-tokens", "2",
             "--prompt-len", "8", "--layers", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "decode_tokens_per_sec_cpu"
    assert line["unit"] == "tokens/sec" and line["value"] > 0
    assert set(line["aux"]) == {f"greedy_{k}_cpu" for k in (
        "n", "mean_ms", "p50_ms", "p90_ms", "p99_ms", "tokens_per_sec",
        "ttft_ms", "ttft_p99_ms")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tb.main([])
