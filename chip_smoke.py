"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line of its own; any failure raises, so the
script exits non-zero and prints no result:

1. device: refuses to run without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build: compiles every kernel under ``neuronx_distributed_tpu_torch/csrc``
   from source (one ``nvcc`` per file, in parallel) and prints the seconds.
3. kernel_vs_plain: each kernel's wrapper at the serving step's shapes
   (T=512, N=32, KV=8, D=128, BS=16, maxb=128) against its plain PyTorch
   version on the same inputs — fp32 pools within 1e-4, bf16 and int8
   within 2e-2 — plus D=64 and BS=32; times the kernel, the plain version
   and one PyTorch library call, and computes the card's bound.
4. serve: ``ServingEngine`` with Llama-3-8B at full width and all 32 layers
   in bf16 (random weights, seed 0, std 0.02): 8 requests of 128-1024
   prompt tokens and 64 new tokens each, two admitted mid-flight. Asserts
   every request completes, one step shape, and ``launches == layers x
   steps``.
5. serve_int8: the same with an int8 pool at 4 layers.
6. cross_check: one packed step at full width, 2 layers, fp32, on the card
   and on the port's CPU path; logits within 1e-3 x max|logit|.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense, per the q dtype
KERNEL_SOURCE = "neuronx_distributed_tpu_torch/csrc/paged_attention.cu"
KERNEL_REPLACES = "neuronx_distributed_tpu/ops/paged_attention.py:95"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 25, flush: torch.Tensor = None) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each, after warm-up; ``flush`` is overwritten before each run so the
    50 MB L2 holds no pool data, as for a layer of the real step."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(seed, t=512, n=32, kv=8, d=128, bs=16, maxb=128, nb=2048,
               n_seq=8, dtype=torch.bfloat16, quantized=False):
    """A packed step's attention inputs: ``n_seq`` sequences own disjoint
    random pool blocks; each token carries its sequence's table row (so
    tokens share blocks) and a valid position; a few table entries are
    -1 and the unfilled tail of each sequence is -1 / PAD_POSITION."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import (
        PAD_POSITION, quantize_kv)

    rng = np.random.RandomState(seed)
    lens = rng.randint(bs, maxb * bs // 2, n_seq)
    perm = rng.permutation(nb)
    seq_tables = np.full((n_seq, maxb), -1, np.int32)
    pool_pos = np.full((nb, bs), PAD_POSITION, np.int32)
    used = 0
    for s, ln in enumerate(lens):
        nblk = -(-ln // bs)
        blocks = perm[used:used + nblk]
        used += nblk
        seq_tables[s, :nblk] = blocks
        p = np.arange(nblk * bs).reshape(nblk, bs)
        pool_pos[blocks] = np.where(p < ln, p, PAD_POSITION)
    seq_of = rng.randint(0, n_seq, t)
    tables = seq_tables[seq_of].copy()
    holes = rng.rand(t, maxb) < 0.05
    holes[:, 0] = False              # every token keeps a valid key
    tables[holes] = -1
    q_pos = rng.randint(0, lens[seq_of]).astype(np.int32)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = randn(t, n, d).to(dtype)
    k, v = randn(nb, bs, kv, d), randn(nb, bs, kv, d)
    ks = vs = None
    if quantized:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(dtype), v.to(dtype)

    def dev_i32(a):
        return torch.from_numpy(a).to(dev)

    return (q, k, v, dev_i32(pool_pos), dev_i32(tables), dev_i32(q_pos), ks,
            vs)


def paged_bound(args):
    """Least time for the call: the larger of the bytes it must move (q
    and out once, each distinct referenced pool block's K/V, scales and
    positions once, the tables) over HBM bandwidth, and its multiply-adds
    (QK^T and PV over every valid table entry of every token) over the
    peak rate for q's dtype."""
    q, k, v, pool_pos, tables, q_pos, ks, vs = args
    t, n, d = q.shape
    nb, bs, kv, _ = k.shape
    valid = tables[tables >= 0]
    distinct = torch.unique(valid).numel()
    per_block = 2 * bs * kv * d * k.element_size() + bs * 4
    if ks is not None:
        per_block += 2 * bs * kv * 4
    nbytes = (2 * q.numel() * q.element_size() + distinct * per_block
              + tables.numel() * 4 + q_pos.numel() * 4)
    flops = 4.0 * valid.numel() * bs * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def sdpa_on_gathered(args):
    """One PyTorch library call computing the same function, given K/V
    already gathered to dense per-token rows (the gather is excluded from
    its time): ``scaled_dot_product_attention`` with a boolean mask."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION

    q, k, v, pool_pos, tables, q_pos, _, _ = args
    t, n, d = q.shape
    nb, bs, kv, _ = k.shape
    safe = tables.long().clamp(0, nb - 1)
    length = tables.shape[1] * bs
    kg = k[safe].reshape(t, length, kv, d).transpose(1, 2).contiguous()
    vg = v[safe].reshape(t, length, kv, d).transpose(1, 2).contiguous()
    pg = pool_pos[safe].masked_fill(tables[:, :, None] < 0, PAD_POSITION)
    mask = (q_pos[:, None] >= pg.reshape(t, length))[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)


def phase_kernel_vs_plain():
    from neuronx_distributed_tpu_torch.ops import paged_attention as pa

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = [
        ("fp32", dict(dtype=torch.float32), 1e-4),
        ("bf16", dict(dtype=torch.bfloat16), 2e-2),
        ("int8_q_fp32", dict(dtype=torch.float32, quantized=True), 2e-2),
        ("int8_q_bf16", dict(dtype=torch.bfloat16, quantized=True), 2e-2),
        ("bf16_d64", dict(dtype=torch.bfloat16, d=64), 2e-2),
        ("bf16_bs32", dict(dtype=torch.bfloat16, bs=32, maxb=64, nb=1024),
         2e-2),
    ]
    results = []
    for i, (name, kw, tol) in enumerate(cases):
        args = paged_case(100 + i, **kw)
        got = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(*args)
        err = (got.float() - ref.float()).abs().max().item()
        if not (err <= tol) or not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention {name}: max abs error "
                                 f"{err} above {tol}")
        res = dict(case=name, max_err=err, tol=tol)
        if name in ("bf16", "fp32", "int8_q_bf16"):
            bound, by, nbytes, flops = paged_bound(args)
            res.update(
                kernel_ms=time_ms(lambda: pa.paged_attention_cuda(*args),
                                  flush=flush),
                plain_ms=time_ms(lambda: pa.paged_attention_plain(*args),
                                 reps=20, flush=flush),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            if name == "bf16":
                lib = sdpa_on_gathered(args)
                res["library_ms"] = time_ms(lib, flush=flush)
                res["library"] = ("F.scaled_dot_product_attention on K/V "
                                  "pre-gathered to dense, masked; gather "
                                  "excluded")
        results.append(res)
        del args, got, ref
        torch.cuda.empty_cache()
    emit("kernel_vs_plain", cases=results)
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the serving engine
# ---------------------------------------------------------------------------

def serve(cfg, ecfg, label):
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    torch.cuda.reset_peak_memory_stats()
    sd = init_state_dict(cfg, seed=0, std=0.02)
    eng = ServingEngine(cfg, sd, ecfg)
    del sd
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, 8)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 64
    torch.cuda.synchronize()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    for i in range(6):
        eng.submit(prompts[i], new, uid=f"r{i}")
    while eng.stats.tokens_generated == 0:
        eng.step()
    for i in (6, 7):                  # admitted mid-flight
        eng.submit(prompts[i], new, uid=f"r{i}")
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    steps = eng.stats.steps
    bad = [u for u, r in res.items()
           if r.status != "completed" or len(r.tokens) != new]
    if len(res) != 8 or bad:
        raise AssertionError(f"{label}: requests not completed: {bad}")
    if eng.compile_count() != 1:
        raise AssertionError(f"{label}: {eng.compile_count()} step shapes")
    if launches != cfg.num_layers * steps or launches == 0:
        raise AssertionError(f"{label}: {launches} kernel launches for "
                             f"{steps} steps x {cfg.num_layers} layers")
    rep = eng.stats.report()
    emit(label, layers=cfg.num_layers, dtype=str(cfg.dtype),
         quantized_pool=ecfg.quantized, requests=len(res),
         prompt_tokens=int(lens.sum()), new_tokens=8 * new, steps=steps,
         paged_attention_launches=launches,
         output_tok_per_s=8 * new / wall, wall_s=wall,
         engine_tok_per_s=rep["tokens_per_s"],
         ttft_p50_ms=rep["ttft_p50_ms"], ttft_p99_ms=rep["ttft_p99_ms"],
         step_latency_p50_ms=rep["step_latency_p50_ms"],
         step_latency_p99_ms=rep["step_latency_p99_ms"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_cross_check(base_cfg):
    """One packed step (two prompts, pad rows) then one decode step, at
    full width with 2 layers in fp32, on the card and on the CPU path."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
    from neuronx_distributed_tpu_torch.inference.paging import (
        init_paged_kv_cache)
    from neuronx_distributed_tpu_torch.models.llama import (
        build_model, init_state_dict, llama_forward_with_cache)

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    width, bs, nb, maxb = 64, 16, 64, 8
    sd = init_state_dict(cfg, seed=1, std=0.02)
    sides = {}
    for dev in ("cuda", "cpu"):
        sides[dev] = (build_model(cfg, sd, dev), init_paged_kv_cache(
            cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim_, 2, maxb,
            dtype=torch.float32, device=dev))
    del sd
    tables = np.full((2, maxb), -1, np.int32)
    tables[0, :3] = [17, 3, 40]
    tables[1, :2] = [8, 62]
    rng = np.random.RandomState(2)
    steps = [(list(range(40)) + list(range(20)), [0] * 40 + [1] * 20),
             ([40, 20], [0, 1])]
    worst = 0.0
    for pos, slots in steps:
        n = len(pos)
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab_size, n)
        p = np.full((1, width), PAD_POSITION, np.int32)
        p[0, :n] = pos
        s = np.full((width,), 2, np.int32)
        s[:n] = slots
        out = {}
        for dev, (model, cache) in sides.items():
            cache.block_tables.copy_(torch.from_numpy(tables))
            logits, _ = llama_forward_with_cache(
                model, torch.from_numpy(toks).to(dev),
                torch.from_numpy(p).to(dev), cache,
                torch.from_numpy(s).to(dev))
            out[dev] = logits[0, :n].float().cpu()
        diff = (out["cuda"] - out["cpu"]).abs().max().item()
        scale = out["cpu"].abs().max().item()
        worst = max(worst, diff / scale)
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"cross_check: max |diff| {diff} above "
                                 f"1e-3 x max|logit| ({scale})")
    emit("cross_check", layers=cfg.num_layers, width=width,
         max_rel_diff=worst, tol=1e-3)
    del sides
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    from neuronx_distributed_tpu_torch.inference.engine import EngineConfig
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(libs))

    cases = phase_kernel_vs_plain()

    ecfg = EngineConfig(block_size=16, num_blocks=2048, max_slots=8,
                        max_blocks_per_seq=128, token_budget=512)
    launches = serve(LLAMA3_8B, ecfg, "serve")
    serve(dataclasses.replace(LLAMA3_8B, num_layers=4),
          dataclasses.replace(ecfg, quantized=True), "serve_int8")
    phase_cross_check(LLAMA3_8B)

    main_case = next(c for c in cases if c["case"] == "bf16")
    summary = {"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(c["max_err"] for c in cases),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "max_err": max(c["max_err"] for c in cases)}]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
