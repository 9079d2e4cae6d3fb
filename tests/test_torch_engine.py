"""The PyTorch port's ServingEngine against the JAX package's: identical
greedy token ids per request and identical step counters in every
scenario (solo, late arrival, preemption, EOS, int8 pool, a queue longer
than the slots, disaggregated prefill and decode workers), fixed step
shapes across load changes, admission rejection, CUDA-by-default, and a
port that imports nothing of JAX (serving and ``generate`` run in a
process that refuses it)."""

import itertools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_FIELDS = ("steps", "completed", "preempted", "prefill_tokens",
               "tokens_generated")


@pytest.fixture(scope="module")
def models():
    """The tests/test_engine.py tiny model, as JAX params and the port's
    state dict."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    return jcfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


def _ecfg(mod, **kw):
    base = dict(block_size=4, num_blocks=16, max_slots=2,
                max_blocks_per_seq=8, token_budget=8)
    base.update(kw)
    return mod.EngineConfig(**base)


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _prompt(seed, n, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (n,)).tolist()


def _drive(eng, early, late=(), steps_before_late=0):
    for uid, seed, n, new in early:
        eng.submit(_prompt(seed, n), new, uid=uid)
    for _ in range(steps_before_late):
        eng.step()
    for uid, seed, n, new in late:
        eng.submit(_prompt(seed, n), new, uid=uid)
    res = eng.run()
    return ({u: (r.status, r.tokens) for u, r in res.items()},
            {f: getattr(eng.stats, f) for f in STAT_FIELDS})


def _both(models, scenario, **ekw):
    jcfg, params, tcfg, sd = models
    ps.initialize_model_parallel()
    jkw = dict(ekw)
    jkw.setdefault("kv_dtype", None if ekw.get("quantized") else jnp.float32)
    jeng = je.ServingEngine(jcfg, params, _ecfg(je, **jkw), clock=_clock())
    teng = te.ServingEngine(tcfg, sd, _ecfg(te, **ekw), clock=_clock(),
                            device="cpu")
    return _drive(jeng, **scenario), _drive(teng, **scenario), teng


SCENARIOS = {
    "solo": (dict(early=[("a", 0, 7, 8)]), {}),
    "late_arrival": (dict(early=[("a", 3, 9, 6)], late=[("b", 4, 5, 6)],
                          steps_before_late=3), {}),
    "preemption": (dict(early=[("a", 10, 8, 6), ("b", 11, 8, 6)]),
                   dict(num_blocks=5, max_blocks_per_seq=4)),
    "int8_pool": (dict(early=[("a", 13, 6, 4), ("b", 14, 9, 5)],
                       late=[("c", 15, 3, 6)], steps_before_late=2),
                  dict(quantized=True)),
    "queue_longer_than_slots": (
        dict(early=[("a", 20, 11, 5), ("b", 21, 4, 7), ("c", 22, 6, 3),
                    ("d", 23, 2, 6)]), {}),
    # three slots over a 7-block pool, a one-token prompt, late arrivals
    # while others are preempted and restarted
    "crowded_small_pool": (
        dict(early=[("a", 30, 9, 7), ("b", 31, 5, 8), ("c", 32, 12, 4)],
             late=[("d", 33, 3, 9), ("e", 34, 7, 5), ("f", 35, 1, 6)],
             steps_before_late=4),
        dict(num_blocks=7, max_slots=3, max_blocks_per_seq=5,
             token_budget=6)),
    # two workers of their own widths: prefill 8 (token_budget), decode 2
    "disaggregated": (
        dict(early=[("a", 40, 9, 6), ("b", 41, 4, 7)],
             late=[("c", 42, 11, 4)], steps_before_late=2),
        dict(disaggregated=True)),
    # a prefill budget below the token budget, three slots, preemption
    "disaggregated_crowded": (
        dict(early=[("a", 50, 9, 7), ("b", 51, 5, 8), ("c", 52, 12, 4)],
             late=[("d", 53, 3, 9)], steps_before_late=3),
        dict(disaggregated=True, prefill_budget=5, num_blocks=7, max_slots=3,
             max_blocks_per_seq=5)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax(models, name):
    scenario, ekw = SCENARIOS[name]
    (jres, jstats), (tres, tstats), teng = _both(models, scenario, **ekw)
    assert {s for s, _ in tres.values()} == {"completed"}
    assert tres == jres
    assert tstats == jstats
    if name in ("preemption", "crowded_small_pool",
                "disaggregated_crowded"):
        assert tstats["preempted"] >= 1
    assert teng.allocator.num_allocated == 0
    assert (teng._tables == -1).all()
    assert teng.compile_count() == 1
    if ekw.get("disaggregated"):
        assert teng.worker_compile_counts() == {"prefill": 1, "decode": 1}
        assert min(teng.worker_runs.values()) > 0
    if name == "int8_pool":
        assert teng.cache.k.dtype == torch.int8


def test_eos_retires_early_like_jax(models):
    jcfg, params, tcfg, sd = models
    probe = te.ServingEngine(tcfg, sd, _ecfg(te), device="cpu")
    probe.submit(_prompt(12, 6), 8, uid="x")
    toks = probe.run()["x"].tokens
    eos = toks[2]
    (jres, jstats), (tres, tstats), _ = _both(
        models, dict(early=[("a", 12, 6, 8)]), eos_id=eos)
    assert tres == jres and tstats == jstats
    assert tres["a"][1] == toks[:toks.index(eos) + 1]
    assert len(tres["a"][1]) < 8


def test_step_shapes_fixed_across_load_changes(models):
    """1, then 2, then 0, then 1 live requests: one step signature."""
    _, _, tcfg, sd = models
    eng = te.ServingEngine(tcfg, sd, _ecfg(te), device="cpu")
    eng.submit(_prompt(5, 6), 4, uid="a")
    eng.step()
    eng.submit(_prompt(6, 3), 4, uid="b")
    eng.run()
    eng.submit(_prompt(7, 11), 3, uid="c")
    res = eng.run()
    assert {r.status for r in res.values()} == {"completed"}
    assert eng.compile_count() == 1
    rep = eng.stats.report()
    assert rep["completed"] == 3 and rep["tokens_generated"] == 11


def test_oversize_request_rejected_at_submit(models):
    _, _, tcfg, sd = models
    eng = te.ServingEngine(tcfg, sd, _ecfg(te), device="cpu")
    with pytest.raises(te.RequestRejected) as exc:
        eng.submit(_prompt(9, 30), 10, uid="big")
    assert exc.value.reason == "never_fits"
    assert eng.results["big"].status == "rejected"
    with pytest.raises(te.RequestRejected):
        eng.submit([], 4, uid="empty")
    assert eng.stats.rejected == 2 and not eng.has_work()


def test_engine_config_has_no_later_slice_fields():
    with pytest.raises(TypeError):
        te.EngineConfig(cp=2)


def test_entry_points_default_to_cuda(models):
    _, _, tcfg, sd = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.ServingEngine(tcfg, sd)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.LlamaForCausalLM(tcfg)


_ISOLATED = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "ml_dtypes",
                                      "neuronx_distributed_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    import neuronx_distributed_tpu_torch as pkg
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for m in mods:
        importlib.import_module(m)
    for m in ("config", "ops.flash_attention", "parallel.loss_functions",
              "trainer.optimizer", "trainer.schedules", "trainer.trainer",
              "ops.blockwise_moe", "modules.moe", "modules.moe.blockwise",
              "modules.moe.expert_mlps", "modules.moe.model",
              "modules.moe.routing", "models.mixtral",
              "inference.generation", "modules.moe.config_validator",
              "modules.moe.token_shuffling", "quantization",
              "quantization.quantization_utils",
              "quantization.microscaling",
              "quantization.quantization_layers",
              "quantization.mx_layers", "quantization.serving",
              "quantization.quantize", "inference.aot_cache",
              "inference.model_builder", "inference.benchmark",
              "pipeline", "pipeline.schedules", "pipeline.spmd_engine",
              "pipeline.engine_1f1b", "models.llama_pipeline",
              "models.mixtral_pipeline"):
        assert pkg.__name__ + "." + m in mods, m
    from neuronx_distributed_tpu_torch.inference import engine as te
    from neuronx_distributed_tpu_torch.models import llama as tl
    cfg = tl.tiny_config(dtype=torch.float32)
    sd = tl.init_state_dict(cfg, seed=0, device="cpu")
    eng = te.ServingEngine(cfg, sd, te.EngineConfig(
        block_size=4, num_blocks=16, max_slots=2, max_blocks_per_seq=8,
        token_budget=8), device="cpu")
    eng.submit([1, 2, 3, 4, 5], 4, uid="a")
    assert len(eng.run()["a"].tokens) == 4
    from neuronx_distributed_tpu_torch.inference import generation
    out = generation.generate(tl.build_model(cfg, sd, "cpu"),
                              [[1, 2, 3, 4, 5], [6, 7, 0, 0, 0]], [5, 2], 4,
                              buckets=(8,))
    assert tuple(out.shape) == (2, 4), out.shape
    from neuronx_distributed_tpu_torch.models import mixtral as tm
    mcfg = tm.tiny_moe_config(dtype=torch.float32, moe_dispatch="blockwise",
                              moe_block_size=8)
    eng = te.ServingEngine(mcfg, tm.init_state_dict(mcfg, device="cpu"),
                           te.EngineConfig(block_size=4, num_blocks=16,
                                           max_slots=2, max_blocks_per_seq=8,
                                           token_budget=8,
                                           disaggregated=True), device="cpu")
    eng.submit([1, 2, 3, 4, 5], 4, uid="m")
    eng.submit([6, 7], 3, uid="n")
    res = eng.run()
    assert [len(res[u].tokens) for u in "mn"] == [4, 3]
    assert eng.worker_compile_counts() == {"prefill": 1, "decode": 1}
    for fmt in ("int8", "mxfp4"):
        eng = te.ServingEngine(
            tm.tiny_moe_config(dtype=torch.float32), tm.init_state_dict(
                tm.tiny_moe_config(), device="cpu"),
            te.EngineConfig(block_size=4, num_blocks=16, max_slots=2,
                            max_blocks_per_seq=8, token_budget=8,
                            weight_quant=fmt), device="cpu")
        eng.submit([1, 2, 3, 4, 5], 4, uid="q")
        assert len(eng.run()["q"].tokens) == 4
    from neuronx_distributed_tpu_torch.inference import speculative as sp
    for m in ("inference.speculative", "utils.bfloat16"):
        assert pkg.__name__ + "." + m in mods, m
    spec = te.EngineConfig(block_size=4, num_blocks=32, max_slots=2,
                           max_blocks_per_seq=8, token_budget=8,
                           speculation=sp.SpeculationConfig(2, 2))
    plain = te.ServingEngine(cfg, sd, te.EngineConfig(
        block_size=4, num_blocks=32, max_slots=2, max_blocks_per_seq=8,
        token_budget=8), device="cpu")
    plain.submit([1, 2, 3, 4, 5], 6, uid="a")
    want = plain.run()["a"].tokens
    eng = te.ServingEngine(cfg, sd, spec, device="cpu")
    eng.submit([1, 2, 3, 4, 5], 6, uid="a")
    assert eng.run()["a"].tokens == want
    assert eng.stats.spec_rounds > 0
    src = te.ServingEngine(cfg, sd, spec, device="cpu", name="src")
    dst = te.ServingEngine(cfg, sd, spec, device="cpu", name="dst")
    src.submit([1, 2, 3, 4, 5], 6, uid="a")
    for _ in range(2):
        src.step()
    dst.import_session(te.SessionTicket.from_bytes(
        src.export_session("a").to_bytes()))
    assert dst.run()["a"].tokens == want
    model = tl.build_model(cfg, sd, "cpu")
    toks, _ = sp.speculative_generate(model, model, [[1, 2, 3, 4, 5]], [5],
                                      4, speculation_length=2, buckets=(8,))
    assert toks[0].tolist() == want[:4], toks
    for m in ("inference.router", "inference.transport",
              "parallel.wire_codec"):
        assert pkg.__name__ + "." + m in mods, m
    from neuronx_distributed_tpu_torch.inference import router as rt
    d = rt.chaos_drill(cfg, sd, te.EngineConfig(
        block_size=4, num_blocks=16, max_slots=2, max_blocks_per_seq=8,
        token_budget=8), clock=lambda: 0.0, device="cpu")
    assert d["router_availability"] == 1.0, d
    assert d["router_greedy_match_ref"] == 1.0, d
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "ml_dtypes", "neuronx_distributed_tpu")]
    assert not bad, bad
    print("isolated", len(mods))
""")


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("isolated")
