"""Where the serving step's time goes on one CUDA card.

    python3 -m neuronx_distributed_tpu_torch.scripts.profile_serving
    python3 -m neuronx_distributed_tpu_torch.scripts.profile_serving --mixtral

Serves ``chip_smoke.py``'s phase-4 workload (Llama-3-8B at full width, all
32 layers, bf16, random weights; 8 requests of 128-1024 prompt tokens and
64 new tokens each) through the port's ``ServingEngine`` and traces two
windows with ``torch.profiler``: the first prefill-heavy steps, and steady
decode once every request is decoding. With ``--mixtral`` the model is
phase 11's, Mixtral 8x7B's widths at 8 layers with blockwise dispatch,
block 64 (add ``--disaggregated`` for phase 12's two workers). For each
window it prints one JSON line: host wall time per step, device busy time
per step, the device's idle share, the kernels by device time and the
busy time by group (paged attention K1, the grouped GLU K5 and K6,
cuBLAS products, the rest), each of the port's kernels by name (K1's
``tc::paged_attention_wgmma`` and ``tc::paged_combine`` apart); and the
wall time per decode step without the profiler. It also counts, over decode
steps, how many pool key entries the attention kernel walked for real rows
and for the step's pad rows (pad rows carry the last slot's block table,
as in the JAX model, and their output is discarded).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from .profile_train import port_kernels


# kernel groups by name, first match wins: K1 (the bf16 tensor-core
# kernel with its split combine, or the CUDA-core kernel), K6 and K5 (both
# passes each; fp32 K6 runs K5's kernels, so it counts under grouped_glu),
# cuBLAS products
GROUPS = {"paged_attention": ("paged_attention", "paged_combine"),
          "grouped_glu_decode": ("glu_act_wgmma<true>",
                                 "glu_down_wgmma<true>"),
          "grouped_glu": ("glu_act", "glu_down"),
          "cublas_products": ("nvjet", "gemm", "sm90_xmma", "cutlass"),
          "other": ()}


def group_of(name: str) -> str:
    return next((g for g, keys in GROUPS.items()
                 if any(k in name for k in keys)), "other")


def trace(eng, steps: int, label: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.device_time_total
    busy_ms = sum(kernels.values()) / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    groups = {g: 0.0 for g in GROUPS}
    for k, v in kernels.items():
        groups[group_of(k)] += v / 1e3 / steps
    print(json.dumps({
        "window": label, "steps": steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
        "paged_attention_share_of_busy": (
            groups["paged_attention"] / busy_ms if kernels else None),
        "busy_ms_per_step_by_group": groups,
        # each kernel of the port's groups (not cuBLAS, not "other") by name
        "port_kernels_ms_per_step": port_kernels(
            kernels, steps,
            lambda k: group_of(k) not in ("cublas_products", "other")),
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / steps]
                                    for k, v in top]}), flush=True)


def time_steps(eng, steps: int, label: str) -> None:
    """Host wall time per step without the profiler, for the idle share:
    1 - (profiled device busy time) / (this wall time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    print(json.dumps({"window": label, "steps": steps, "wall_ms_per_step":
                      (time.perf_counter() - t0) * 1e3 / steps}), flush=True)


def count_walked(eng, steps: int) -> None:
    """Pool key entries the attention kernel walks, real rows vs pad
    rows, over ``steps`` decode steps (untimed)."""
    from ..models import llama

    real_fn, pad_pos = llama.paged_attention, eng.model_cfg.max_seq_len - 1
    walked = {"real": 0, "pad": 0}

    def counting(q, k_pool, v_pool, pool_pos, tables, q_pos, **kw):
        per_row = (tables >= 0).sum(1) * k_pool.shape[1]
        pad = q_pos == pad_pos
        walked["pad"] += int(per_row[pad].sum())
        walked["real"] += int(per_row[~pad].sum())
        return real_fn(q, k_pool, v_pool, pool_pos, tables, q_pos, **kw)

    llama.paged_attention = counting
    try:
        for _ in range(steps):
            eng.step()
    finally:
        llama.paged_attention = real_fn
    total = walked["real"] + walked["pad"]
    print(json.dumps({"window": "decode_key_entries", "steps": steps,
                      **walked, "pad_share": walked["pad"] / total}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mixtral", action="store_true",
                    help="Mixtral 8x7B widths at 8 layers, blockwise")
    ap.add_argument("--disaggregated", action="store_true",
                    help="two workers: decode 4 wide, prefill 512 wide")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: CUDA is not available")
    from ..inference.engine import EngineConfig, ServingEngine
    from ..models import llama, mixtral

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    family = mixtral if args.mixtral else llama
    base = (dataclasses.replace(mixtral.MIXTRAL_8X7B, num_layers=8,
                                moe_dispatch="blockwise", moe_block_size=64)
            if args.mixtral else llama.LLAMA3_8B)
    # serving holds bf16 weights: make them in bf16
    cfg = dataclasses.replace(base, param_dtype=base.dtype)
    ecfg = EngineConfig(block_size=16, num_blocks=2048, max_slots=8,
                        max_blocks_per_seq=128, token_budget=512)
    if args.disaggregated:
        ecfg = dataclasses.replace(ecfg, disaggregated=True, max_slots=4,
                                   prefill_budget=512)
    eng = ServingEngine(cfg, family.init_state_dict(cfg, seed=0, std=0.02),
                        ecfg)
    rng = np.random.RandomState(0)
    for i, n in enumerate(rng.randint(128, 1025, 8)):
        eng.submit(rng.randint(0, cfg.vocab_size, n).tolist(), 64,
                   uid=f"r{i}")
    eng.step()                          # first use: kernel build and load
    trace(eng, 1, "profiler_warmup")    # the first trace pays CUPTI's start
    trace(eng, 3, "prefill")
    while any(s is not None and not s.decoding for s in eng._slots):
        eng.step()
    count_walked(eng, 3)
    time_steps(eng, 5, "decode_unprofiled")
    trace(eng, 5, "decode")
    eng.run()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
