"""Inference latency and throughput benchmark (counterpart of
``neuronx_distributed_tpu/inference/benchmark.py``): time any callable
over N runs, synchronized with the card, and the decode paths against each
other.

    python -m neuronx_distributed_tpu_torch.inference.benchmark [--device cpu]

prints ONE JSON line (``emit_json_line``); it runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass
class LatencyCollector:
    """Accumulates per-call latencies (reference ``LatencyCollector``)."""

    latencies_ms: List[float] = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.latencies_ms.append(seconds * 1e3)

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.latencies_ms, p))

    def report(self) -> Dict[str, float]:
        arr = np.asarray(self.latencies_ms)
        return {
            "n": int(arr.size),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p99_ms": float(np.percentile(arr, 99)),
        }


def _sync() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable[[], Any], n_runs: int = 20,
              warmup: int = 2) -> Dict[str, float]:
    """Warm-up runs, then ``n_runs`` timed runs, each ended by a
    ``torch.cuda.synchronize`` on the card (reference ``Benchmark``)."""
    for _ in range(warmup):
        fn()
        _sync()
    col = LatencyCollector()
    for _ in range(n_runs):
        t0 = time.perf_counter()
        fn()
        _sync()
        col.record(time.perf_counter() - t0)
    return col.report()


def decode_benchmark_suite(cfg, params, draft_cfg=None, draft_params=None,
                           batch: int = 1, prompt_len: int = 128,
                           new_tokens: int = 64, n_runs: int = 5,
                           buckets=(128, 512, 2048),
                           device: DeviceLike = None) -> Dict[str, Dict]:
    """The decode paths against each other on ``device`` (None: the
    card): greedy :func:`.generation.generate` and, when a draft model is
    given, :func:`.speculative.speculative_generate`. ``params`` and
    ``draft_params`` are state dicts. Each entry reports latency
    percentiles plus ``tokens_per_sec``; greedy also its time to first
    token."""
    from .engine import _family
    from .generation import generate
    from .speculative import speculative_generate

    if (draft_cfg is None) != (draft_params is None):
        raise ValueError(
            "draft_cfg and draft_params must be passed together")
    dev = resolve_device(device)
    family, _ = _family(cfg)
    model = family.build_model(cfg, params, dev)
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                      (batch, prompt_len)))
    plen = torch.full((batch,), prompt_len, dtype=torch.int32)
    out: Dict[str, Dict] = {}

    def with_tps(report):
        report["tokens_per_sec"] = (batch * new_tokens
                                    / (report["mean_ms"] / 1e3))
        return report

    out["greedy"] = with_tps(benchmark(
        lambda: generate(model, ids, plen, new_tokens, buckets=buckets),
        n_runs=n_runs))
    # TTFT = prefill + first sampled token (what a user waits before the
    # stream starts)
    ttft = benchmark(
        lambda: generate(model, ids, plen, 1, buckets=buckets),
        n_runs=n_runs)
    out["greedy"]["ttft_ms"] = ttft["p50_ms"]
    out["greedy"]["ttft_p99_ms"] = ttft["p99_ms"]
    if draft_cfg is not None:
        dfamily, _ = _family(draft_cfg)
        draft = dfamily.build_model(draft_cfg, draft_params, dev)
        out["speculative"] = with_tps(benchmark(
            lambda: speculative_generate(model, draft, ids, plen,
                                         new_tokens, buckets=buckets)[0],
            n_runs=n_runs))
    return out


def emit_json_line(suite: Dict[str, Dict], platform: str = "",
                   stream=None) -> str:
    """Serialize a :func:`decode_benchmark_suite` result as exactly ONE
    JSON line in the ``bench.py`` convention: ``{"metric", "value",
    "unit", "vs_baseline", "aux"}`` with the greedy decode rate as the
    headline and everything else nested under ``aux``."""
    import json
    import sys

    tag = f"_{platform}" if platform else ""
    aux = {}
    for name, rep in suite.items():
        for field_name, val in rep.items():
            aux[f"{name}_{field_name}{tag}"] = round(float(val), 4)
    line = json.dumps({
        "metric": f"decode_tokens_per_sec{tag}",
        "value": round(float(suite["greedy"]["tokens_per_sec"]), 2),
        "unit": "tokens/sec",
        "vs_baseline": 1.0,
        "aux": aux,
    })
    print(line, file=stream or sys.stdout, flush=True)
    return line


def main(argv=None) -> None:
    """CLI: benchmark greedy decode on a small Llama (random weights, seed
    0) and print ONE JSON line; the platform tag is ``gpu`` on the card,
    ``cpu`` with ``--device cpu``."""
    import argparse

    from ..models import llama

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--n-runs", type=int, default=3)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = llama.tiny_config(num_layers=args.layers, dtype=torch.float32,
                            param_dtype=torch.float32)
    params = llama.init_state_dict(cfg, seed=0, device=dev)
    suite = decode_benchmark_suite(
        cfg, params, batch=args.batch, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, n_runs=args.n_runs,
        buckets=(args.prompt_len,), device=dev)
    emit_json_line(suite, platform="gpu" if dev.type == "cuda" else "cpu")


if __name__ == "__main__":
    main()
