"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line of its own; any failure raises, so the
script exits non-zero and prints no result:

1. device: refuses to run without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build: compiles every kernel under ``neuronx_distributed_tpu_torch/csrc``
   from source (one ``nvcc`` per file, in parallel) and prints the seconds.
3. kernel_vs_plain: K1's wrapper at the serving step's shapes (T=512,
   N=32, KV=8, D=128, BS=16, maxb=128) against its plain PyTorch version
   on the same inputs — fp32 pools within 1e-4, bf16 and int8 within 2e-2
   — on random tables, plus D=64 and BS=32, and on three bf16 steps shaped
   like the main path's (``packed_step``): a packed prefill step (3-4
   chunks), a packed decode step (8 decode rows, 504 pad rows on the last
   slot's table) and the T=4 decode worker; in bf16 over a bf16 pool
   (the tensor-core kernel) a second launch equal to the first bit for
   bit; times the kernel, the plain version and one PyTorch library call,
   and computes the card's bound.
4. serve: ``ServingEngine`` with Llama-3-8B at full width and all 32 layers
   in bf16 (random weights, seed 0, std 0.02): 8 requests of 128-1024
   prompt tokens and 64 new tokens each, two admitted mid-flight. Asserts
   every request completes, one step shape, and ``launches == layers x
   steps``.
5. serve_int8: the same with an int8 pool at 4 layers.
6. cross_check: one packed step at full width, 2 layers, fp32, on the card
   and on the port's CPU path; logits within 1e-3 x max|logit|.
7. flash_vs_plain: the flash kernels K2 (forward), K3 (dq) and K4 (dk/dv)
   against their plain versions at the train step's shapes (B=1, S=4096,
   N=32, KV=8, D=128, causal), element by element (``flash_rel_err``):
   bf16 within 2e-2 and fp32 within 1e-4 of |ref| + rms(ref's row) + 1e-3
   max|ref|, in bf16 also dropout 0.1, D=64, n_rep=1, non-causal and
   S=1000; the kernel's dropout mask equal to the plain mask bit for bit
   (bf16 and fp32); in bf16 (where K2, K3 and K4 run on the tensor cores)
   a second launch of each equal to the first bit for bit; times each
   kernel, its plain version and SDPA's forward (K2) and backward
   (K3+K4), and prints each kernel's TFLOP/s, K2 against SDPA's forward
   (``flash_fwd_k2``) and the K3+K4 factor against SDPA's backward
   (``flash_bwd_pair``) on lines of their own.
8. train: ``make_train_step`` on Llama-3-8B widths at 4 layers, fp32
   params, bf16 compute, flash attention (random weights, seed 0, std
   0.02), B=1, S=4096, AdamW lr 1e-4 clipped at 1.0, 5 steps on one batch.
   Asserts finite losses and grad norms, a falling loss, ``step == 5`` and
   each flash kernel launched layers x steps = 20 times.
9. train_cross_check: two fp32 train steps at full width, 2 layers,
   S=256, on the card and on the port's CPU path from the same weights and
   batch: each step's loss within 1e-4 relative and grad norm within 1e-3,
   and each parameter's update within 1e-3 of its norm.
10. moe_vs_plain: the grouped-GLU kernels against their plain versions at
   Mixtral 8x7B's widths (E=8, top-2, H=4096, I=14336, block 64): K5 at the
   packed step's shapes (512 tokens, P=1536) and K6 at the decode worker's
   (4 tokens, sentinel metadata), fp32 element by element within 1e-4, bf16
   against the plain version in fp32 on the same bf16 inputs, rounded once,
   within 1e-2 (``flash_rel_err``); in bf16 (where K5 and K6 run on the
   tensor cores) a second launch of each equal to the first bit for bit;
   times each kernel, its plain version and cuBLAS over the same rows
   expert by expert, computes the bound, and prints each bf16 kernel's
   TFLOP/s and its factor against cuBLAS.
11. serve_mixtral: ``ServingEngine`` with ``MIXTRAL_8X7B``'s widths cut to
   8 layers, bf16, blockwise dispatch with block 64 (random weights, seed
   0, std 0.02), phase 4's engine config and requests. Asserts every
   request completes, one step shape, paged_attention and grouped_glu
   launches = layers x steps, and no grouped_glu_decode launch.
12. serve_mixtral_disagg: the same, disaggregated, ``max_slots=4``,
   ``prefill_budget=512``: grouped_glu launches = layers x prefill runs,
   grouped_glu_decode launches = layers x decode runs, one step shape per
   worker.
13. mixtral_cross_check: one packed step (width 64) and one decode-worker
   step (width 4) at full width, 2 layers, fp32, blockwise, on the card and
   on the port's CPU path; logits within 1e-3 x max|logit|.
14. moe_bwd_vs_plain: the grouped GLU's backward kernels K7 (dx), K8 (dW)
   and the pair behind one shared first pass against the plain backward at
   the train step's shapes (Mixtral 8x7B widths, 4096 tokens top-2, block
   64, P=8704), fp32 (CUDA cores) within 1e-4 and bf16 (tensor cores,
   ``wgmma``) within 1e-2 element by element (``flash_rel_err``, bf16
   against the plain version in fp32 on the same inputs, rounded once); an
   expert that owns no block gets exact zeros of dW; in bf16 a second
   launch of the pair equal to the first bit for bit; times each entry,
   its plain version and cuBLAS expert by expert, and computes the bound;
   holds K5 (the forward) at the same shape in bf16 to its plain version
   in fp32 within 1e-2 element by element, and times it beside its cuBLAS
   yardstick and bound.
15. train_mixtral: ``make_train_step`` on Mixtral 8x7B widths cut to 2
   layers, fp32 params, bf16 compute, flash attention, blockwise dispatch
   with block 64, router coefficients 0.02 and 0.001, otherwise phase 8's
   settings; asserts finite losses and grad norms, a falling loss, ``step
   == 5``, K2-K5, K7 and K8 each launched layers x steps = 10 times and K6
   never.
16. mixtral_train_cross_check: phase 9 for Mixtral at full width, 1 layer,
   blockwise with block 64; both sides must first route every token to the
   same experts.

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
FLASH_SOURCE = "neuronx_distributed_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = (   # dispatcher (and its launch count), TPU kernel replaced
    ("flash_fwd", "neuronx_distributed_tpu/ops/flash_attention.py:229"),
    ("flash_bwd_dq", "neuronx_distributed_tpu/ops/flash_attention.py:426"),
    ("flash_bwd_dkv", "neuronx_distributed_tpu/ops/flash_attention.py:474"),
)
# each kernel's design (csrc/paged_attention.cu, csrc/flash_attention.cu)
K1_DESIGN = {
    "tensor_cores": "bf16 q over a bf16 pool: wgmma (tensor cores), one kv "
                    "head and 64 // n_rep tokens a CTA, each run of equal "
                    "table rows streamed once through a cp.async ring, the "
                    "table split across CTAs where the card would idle",
    "cuda_cores": "fp32 FMAs (CUDA cores), one CTA per (token, kv head)"}
FLASH_DESIGN = {torch.bfloat16: "wgmma (tensor cores)",
                torch.float32: "fp32 FMAs (CUDA cores)"}
MOE_SOURCE = "neuronx_distributed_tpu_torch/csrc/blockwise_moe.cu"
MOE_KERNELS = (
    ("grouped_glu", "neuronx_distributed_tpu/ops/blockwise_moe.py:64"),
    ("grouped_glu_decode", "neuronx_distributed_tpu/ops/blockwise_moe.py:208"),
)
MOE_BWD_KERNELS = (
    ("grouped_glu_dx", "neuronx_distributed_tpu/ops/blockwise_moe.py:91"),
    ("grouped_glu_dw", "neuronx_distributed_tpu/ops/blockwise_moe.py:123"),
)
# the bf16 forward's design per entry (csrc/blockwise_moe.cu; fp32 runs
# on the CUDA cores)
MOE_FWD_DESIGN = {
    "grouped_glu": "wgmma (tensor cores), 64-row tiles in pairs",
    "grouped_glu_decode": "wgmma (tensor cores), one 64-row tile a CTA, "
                          "its columns split between the warpgroups"}
# the backward's design per input type (csrc/blockwise_moe.cu)
MOE_BWD_DESIGN = {torch.bfloat16: "wgmma (tensor cores)",
                  torch.float32: "fp32 FMAs (CUDA cores)"}
# per grouped-GLU entry: (FLOP per live row in units of H I, [P, H] tensors
# read or written, whether it writes the E experts' dW)
MOE_WORK = {"grouped_glu": (6, 2, False), "grouped_glu_decode": (6, 2, False),
            "grouped_glu_dx": (10, 3, False),
            "grouped_glu_dw": (12, 2, True),
            "grouped_glu_bwd": (16, 3, True)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 25, flush: torch.Tensor = None,
            warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each, after ``warmup`` runs; ``flush`` is overwritten before each run
    so the 50 MB L2 holds no pool data, as for a layer of the real step."""
    for _ in range(warmup):
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

def packed_step(seed, kind, t, bs, maxb, nb, max_pos):
    """Pool positions ``[nb, bs]``, block tables ``[t, maxb]`` and query
    positions ``[t]`` (int32 numpy) of one packed step, each sequence on
    its own random pool blocks, filled to its length:

    * ``random``: every token carries one of 8 sequences' table rows at
      random (so no two neighbours need share one), 5% of the entries -1
      (never the first), at a random position the sequence holds;
    * ``prefill``: chunks of 3-4 sequences' prompts fill the rows in turn,
      each chunk's rows carrying its sequence's table at rising positions
      up to the chunk's end, which the pool holds (a step writes its K/V
      before it attends);
    * ``decode``: 8 decode rows, one per sequence of 128-1088 tokens, then
      pad rows carrying the last sequence's table at position ``max_pos``,
      as the engine's pad rows do;
    * ``worker``: ``t`` decode rows, one per sequence (the disaggregated
      decode worker)."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION

    rng = np.random.RandomState(seed)
    cap = maxb * bs
    lens = rng.randint(bs, cap // 2, 8) if kind == "random" else None
    perm = rng.permutation(nb)
    pool_pos = np.full((nb, bs), PAD_POSITION, np.int32)
    used = 0

    def sequence(length):
        """A table row over fresh blocks holding positions [0, length)."""
        nonlocal used
        nblk = -(-length // bs)
        if used + nblk > nb or nblk > maxb:
            raise ValueError(f"packed_step: {length} tokens do not fit")
        blocks = perm[used:used + nblk]
        used += nblk
        row = np.full(maxb, -1, np.int32)
        row[:nblk] = blocks
        p = np.arange(nblk * bs).reshape(nblk, bs)
        pool_pos[blocks] = np.where(p < length, p, PAD_POSITION)
        return row

    if kind == "random":
        rows = np.stack([sequence(n) for n in lens])
        seq_of = rng.randint(0, 8, t)
        tables = rows[seq_of]
        holes = rng.rand(t, maxb) < 0.05
        holes[:, 0] = False
        tables[holes] = -1
        q_pos = rng.randint(0, lens[seq_of])
    elif kind == "prefill":
        n_seq = rng.randint(3, 5)
        cuts = np.sort(rng.choice(np.arange(1, t), n_seq - 1, replace=False))
        tables, q_pos = [], []
        for c in np.diff(np.concatenate([[0], cuts, [t]])):
            start = rng.randint(0, max(1, min(cap // 2, cap - c + 1)))
            tables += [sequence(start + c)] * c
            q_pos += list(range(start, start + c))
    elif kind in ("decode", "worker"):
        n_seq = 8 if kind == "decode" else t
        top = min(cap, 1088)
        lens = rng.randint(min(128, top), top + 1, n_seq)
        rows = [sequence(n) for n in lens]
        tables = rows + [rows[-1]] * (t - n_seq)
        q_pos = list(lens - 1) + [max_pos] * (t - n_seq)
    else:
        raise ValueError(f"packed_step: no kind {kind!r}")
    return (pool_pos, np.asarray(tables, np.int32).reshape(t, maxb),
            np.asarray(q_pos, np.int32))


def paged_case(seed, t=512, n=32, kv=8, d=128, bs=16, maxb=128, nb=2048,
               dtype=torch.bfloat16, quantized=False, kind="random",
               max_pos=4095):
    """A packed step's attention inputs on the card: random q, pools of
    ``nb`` blocks (int8 with scales when ``quantized``), and the tables and
    positions of :func:`packed_step`'s ``kind`` (pad rows at ``max_pos``,
    Llama-3-8B's ``max_seq_len - 1``, as the engine puts them)."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import quantize_kv

    pool_pos, tables, q_pos = packed_step(seed, kind, t, bs, maxb, nb,
                                          max_pos)
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
    # (case, paged_case arguments, limit); the last three are shaped like
    # the main path's steps (chip_smoke.packed_step)
    cases = [
        ("fp32", dict(dtype=torch.float32), 1e-4),
        ("bf16", dict(dtype=torch.bfloat16), 2e-2),
        ("int8_q_fp32", dict(dtype=torch.float32, quantized=True), 2e-2),
        ("int8_q_bf16", dict(dtype=torch.bfloat16, quantized=True), 2e-2),
        ("bf16_d64", dict(dtype=torch.bfloat16, d=64), 2e-2),
        ("bf16_bs32", dict(dtype=torch.bfloat16, bs=32, maxb=64, nb=1024),
         2e-2),
        ("packed_prefill", dict(kind="prefill"), 2e-2),
        ("packed_decode", dict(kind="decode"), 2e-2),
        ("decode_worker", dict(kind="worker", t=4), 2e-2),
    ]
    timed = ("bf16", "fp32", "int8_q_bf16", "packed_prefill",
             "packed_decode", "decode_worker")
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
        res = dict(case=name, max_err=err, tol=tol, tokens=args[0].shape[0])
        if args[0].dtype == args[1].dtype == torch.bfloat16:
            # the tensor-core kernel: each run's sums in one CTA, splits
            # merged in a fixed order, so a second launch gives the same bits
            again = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: two launches "
                                     "on the same inputs differ")
            res.update(deterministic=True, design=K1_DESIGN["tensor_cores"],
                       splits=pa.tc_splits(
                           args[0].shape[0], args[0].shape[1],
                           args[1].shape[2], torch.cuda.get_device_properties(
                               0).multi_processor_count))
            del again
        else:
            res["design"] = K1_DESIGN["cuda_cores"]
        if name in timed:
            bound, by, nbytes, flops = paged_bound(args)
            res.update(
                kernel_ms=time_ms(lambda: pa.paged_attention_cuda(*args),
                                  flush=flush),
                plain_ms=time_ms(lambda: pa.paged_attention_plain(*args),
                                 reps=20, flush=flush),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            if args[0].dtype == args[1].dtype == torch.bfloat16:
                lib = sdpa_on_gathered(args)
                res["library_ms"] = time_ms(lib, flush=flush)
                res["library"] = ("F.scaled_dot_product_attention on K/V "
                                  "pre-gathered to dense, masked; gather "
                                  "excluded")
                del lib
        results.append(res)
        del args, got, ref
        torch.cuda.empty_cache()
    emit("kernel_vs_plain", cases=results)
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the serving engine
# ---------------------------------------------------------------------------

def serve(cfg, ecfg, label):
    """Serve 8 requests through ``ServingEngine`` and check the launch
    counts: K1 once per layer per worker run; for Mixtral K5 once per layer
    per packed or prefill run and K6 once per layer per decode run."""
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models import llama, mixtral
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    moe = isinstance(cfg, mixtral.MixtralConfig)
    torch.cuda.reset_peak_memory_stats()
    # serving holds its weights in the compute dtype: make them there
    sd = (mixtral if moe else llama).init_state_dict(
        dataclasses.replace(cfg, param_dtype=cfg.dtype), seed=0, std=0.02)
    eng = ServingEngine(cfg, sd, ecfg)
    del sd
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, 8)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 64
    torch.cuda.synchronize()
    paged_attention.launches = 0
    bm.grouped_glu.launches = bm.grouped_glu_decode.launches = 0
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
    launches = {"paged_attention": paged_attention.launches,
                "grouped_glu": bm.grouped_glu.launches,
                "grouped_glu_decode": bm.grouped_glu_decode.launches}
    steps = eng.stats.steps
    runs = dict(eng.worker_runs)
    bad = [u for u, r in res.items()
           if r.status != "completed" or len(r.tokens) != new]
    if len(res) != 8 or bad:
        raise AssertionError(f"{label}: requests not completed: {bad}")
    if set(eng.worker_compile_counts().values()) != {1}:
        raise AssertionError(f"{label}: step shapes per worker "
                             f"{eng.worker_compile_counts()}")
    nl = cfg.num_layers
    wide = runs.get("packed", 0) + runs.get("prefill", 0)
    want = {"paged_attention": nl * sum(runs.values()),
            "grouped_glu": nl * wide if moe else 0,
            "grouped_glu_decode": nl * runs.get("decode", 0) if moe else 0}
    if launches != want or launches["paged_attention"] == 0 or (
            moe and launches["grouped_glu"] == 0):
        raise AssertionError(f"{label}: launches {launches}, want {want} "
                             f"(layers x worker runs {runs})")
    rep = eng.stats.report()
    emit(label, layers=cfg.num_layers, dtype=str(cfg.dtype),
         quantized_pool=ecfg.quantized,
         disaggregated=ecfg.disaggregated, requests=len(res),
         prompt_tokens=int(lens.sum()), new_tokens=8 * new, steps=steps,
         worker_runs=runs, launches=launches,
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


# ---------------------------------------------------------------------------
# phases 10-13: Mixtral and the grouped-GLU kernels
# ---------------------------------------------------------------------------

def moe_case(seed, tokens, weights, sentinel_empty, k=2, bs=64, avoid=None):
    """The expert-sorted blocks of ``tokens`` random tokens routed top-``k``
    by random router logits over the experts of ``weights`` (``gate_up``,
    ``down``), laid out by the port's block metadata; no token goes to
    expert ``avoid``."""
    from neuronx_distributed_tpu_torch.modules.moe import blockwise as bw

    gate_up, down = weights
    e, h = gate_up.shape[0], gate_up.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((tokens, e), generator=gen, device="cuda")
    if avoid is not None:
        logits[:, avoid] = -float("inf")
    idx = logits.topk(k)[1]
    _, src, dest, be, _, padded = bw.compute_block_metadata(
        idx, e, bs, sentinel_empty=sentinel_empty)
    x = torch.randn((tokens, h), generator=gen, device="cuda")
    xs = bw.scatter_to_blocks(x.to(gate_up.dtype), src, dest, padded)
    return xs, gate_up, down, be, bs


def moe_bound(xs, gate_up, down, be, bs, kind="grouped_glu"):
    """Least time for one call of the grouped-GLU entry ``kind``: the
    larger of its bytes (each ``[P, H]`` tensor it reads or writes once:
    xs and ys forward, xs, dy and dx for dx; the weights of each expert
    some live block uses, once; the dW of all E experts written once, in
    the weights' type; the block table) over HBM bandwidth, and its
    products over the live blocks' rows over the peak rate for the dtype:
    x Wg, x Wu, a Wd forward (6 H I FLOP per row); g, u, da = dy Wd^T, dg
    Wg^T, du Wu^T for dx (10); g, u, da and a^T dy, x^T dg, x^T du for dW
    (12); all eight for the pair (16)."""
    per_row, tensors, writes_dw = MOE_WORK[kind]
    e, h, _, i = gate_up.shape
    live = be[be < e]
    hit = torch.unique(live).numel()
    es = xs.element_size()
    nbytes = (tensors * xs.numel() * es + hit * 3 * h * i * es
              + be.numel() * 4 + (e * 3 * h * i * es if writes_dw else 0))
    flops = float(per_row) * live.numel() * bs * h * i
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[xs.dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, hit_experts=hit,
                live_blocks=live.numel())


def moe_rates(t):
    """TFLOP/s of a timed kernel (its bound's operations over its time)
    and its factor against the cuBLAS yardstick."""
    return dict(tflops=t["flops"] / t["kernel_ms"] / 1e9,
                factor_vs_library=t["kernel_ms"] / t["library_ms"])


def expert_runs(be, e, bs):
    """``[expert, first row, end row]`` of each run of one expert's
    consecutive live blocks."""
    runs = []
    for b, x in enumerate(be.tolist()):
        if x >= e:
            continue
        if runs and runs[-1][0] == x and runs[-1][2] == b * bs:
            runs[-1][2] = (b + 1) * bs
        else:
            runs.append([x, b * bs, (b + 1) * bs])
    return runs


def moe_library(xs, gate_up, down, be, bs):
    """The yardstick, several PyTorch calls: per run of one expert's live
    blocks, cuBLAS ``x @ gate_up[e]`` (gate and up in one product),
    ``silu(g) * u`` and ``a @ down[e]``. Timed only."""
    e, h, _, i = gate_up.shape
    runs = expert_runs(be, e, bs)

    def call():
        for x, r0, r1 in runs:
            gu = xs[r0:r1] @ gate_up[x].reshape(h, 2 * i)
            _ = (F.silu(gu[:, :i]) * gu[:, i:]) @ down[x]
    return call


def moe_bwd_library(xs, gate_up, down, be, bs, dy, kind):
    """The backward's yardstick, several PyTorch calls per run of one
    expert's live blocks: cuBLAS ``x @ gate_up[e]`` (g and u in one
    product) and ``dy @ down[e].T``, the elementwise dg, du (and a), then
    for dx ``[dg | du] @ gate_up[e]^T`` (dg Wg^T + du Wu^T in one product),
    for dW ``x^T @ [dg | du]`` and ``a^T @ dy``, for the pair all three.
    Timed only."""
    e, h, _, i = gate_up.shape
    runs = expert_runs(be, e, bs)

    def call():
        for x, r0, r1 in runs:
            w = gate_up[x].reshape(h, 2 * i)
            gu = xs[r0:r1] @ w
            g, u = gu[:, :i], gu[:, i:]
            da = dy[r0:r1] @ down[x].T
            s = torch.sigmoid(g)
            sg = g * s
            dgdu = torch.cat([da * u * (s * (1 + g * (1 - s))), da * sg], 1)
            if kind != "grouped_glu_dw":
                _ = dgdu @ w.T
            if kind != "grouped_glu_dx":
                _ = xs[r0:r1].T @ dgdu
                _ = (sg * u).T @ dy[r0:r1]
    return call


def phase_moe_vs_plain():
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    cfg = MIXTRAL_8X7B
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(300)
    w32 = (torch.randn((e, h, 2, i), generator=gen, device="cuda") * 0.02,
           torch.randn((e, i, h), generator=gen, device="cuda") * 0.02)
    weights = {torch.float32: w32,
               torch.bfloat16: tuple(w.bfloat16() for w in w32)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernels = {"grouped_glu": (bm.grouped_glu_cuda, bm.grouped_glu_plain),
               "grouped_glu_decode": (bm.grouped_glu_decode_cuda,
                                      bm.grouped_glu_decode_plain)}
    # (case, kernel, tokens, dtype, sentinel metadata, tolerance)
    cases = [("k5_bf16", "grouped_glu", 512, torch.bfloat16, False, 1e-2),
             ("k5_fp32", "grouped_glu", 512, torch.float32, False, 1e-4),
             ("k6_bf16", "grouped_glu_decode", 4, torch.bfloat16, True, 1e-2),
             ("k6_fp32", "grouped_glu_decode", 4, torch.float32, True, 1e-4)]
    bi = min(512, i)
    results = []
    for n, (case, name, tokens, dtype, sentinel, tol) in enumerate(cases):
        args = moe_case(400 + n, tokens, weights[dtype], sentinel)
        xs, gate_up, down, be, bs = args
        kernel, plain = kernels[name]
        got = kernel(*args, bi)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            # every sum stays in one CTA in a fixed order: a second launch
            # on the same inputs gives the same bits
            again = kernel(*args, bi)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{case}: two launches on the same "
                                     "inputs differ")
            del again
        # bf16: the kernel sums over I in fp32 and rounds once, so it is
        # held to the plain version in fp32 on the same inputs, rounded once
        ref = plain(xs.float(), gate_up.float(), down.float(), be, bs,
                    bi).to(dtype)
        rel = flash_rel_err(got, ref)
        sent = torch.repeat_interleave(be >= e, bs)
        if not (rel <= tol) or not torch.isfinite(got).all() \
                or got[sent].any():
            raise AssertionError(f"{case}: error {rel} of |ref| + rms(row) "
                                 f"above {tol}, or sentinel rows not zero")
        res = dict(case=case, kernel=name, tokens=tokens, dtype=str(dtype),
                   rows=xs.shape[0], blocks=be.numel(), tol=tol,
                   max_rel_err=rel,
                   max_abs_err=(got.float() - ref.float()).abs().max().item(),
                   kernel_ms=time_ms(lambda: kernel(*args, bi), reps=10,
                                     flush=flush),
                   plain_ms=time_ms(lambda: plain(*args, bi), reps=3,
                                    flush=flush),
                   **moe_bound(*args, kind=name))
        if dtype == torch.bfloat16:
            res["library_ms"] = time_ms(moe_library(*args), reps=10,
                                        flush=flush)
            res["library"] = ("several calls: per run of one expert's live "
                              "blocks, torch.matmul (cuBLAS) x @ gate_up[e], "
                              "silu(g) * u, and @ down[e]")
            res.update(deterministic=True, design=MOE_FWD_DESIGN[name],
                       **moe_rates(res))
        results.append(res)
        del args, xs, got, ref
        torch.cuda.empty_cache()
    del weights, w32
    torch.cuda.empty_cache()
    emit("moe_vs_plain", cases=results)
    return results


def phase_mixtral_cross_check(base_cfg):
    """One packed step (two prompts and pad rows, width 64: K5) and one
    decode-worker step (two decode rows, width 4: K6) at full width, 2
    layers, fp32, blockwise with block 64, on the card and the CPU path."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
    from neuronx_distributed_tpu_torch.inference.paging import (
        init_paged_kv_cache)
    from neuronx_distributed_tpu_torch.models.mixtral import (
        build_model, init_state_dict, mixtral_forward_with_cache)
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32,
                              moe_dispatch="blockwise", moe_block_size=64)
    bs, nb, maxb = 16, 64, 8
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
    steps = [(64, list(range(40)) + list(range(20)), [0] * 40 + [1] * 20,
              "grouped_glu"),
             (4, [40, 20], [0, 1], "grouped_glu_decode")]
    worst, cpu_s = 0.0, 0.0
    for width, pos, slots, kernel in steps:
        n = len(pos)
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab_size, n)
        p = np.full((1, width), PAD_POSITION, np.int32)
        p[0, :n] = pos
        s = np.full((width,), 2, np.int32)
        s[:n] = slots
        out = {}
        for dev, (model, cache) in sides.items():
            before = getattr(bm, kernel).launches
            t0 = time.perf_counter()
            cache.block_tables.copy_(torch.from_numpy(tables))
            logits, _ = mixtral_forward_with_cache(
                model, torch.from_numpy(toks).to(dev),
                torch.from_numpy(p).to(dev), cache,
                torch.from_numpy(s).to(dev))
            out[dev] = logits[0, :n].float().cpu()
            if dev == "cpu":
                cpu_s += time.perf_counter() - t0
            elif getattr(bm, kernel).launches - before != cfg.num_layers:
                raise AssertionError(f"mixtral_cross_check: width {width} "
                                     f"did not launch {kernel} per layer")
        diff = (out["cuda"] - out["cpu"]).abs().max().item()
        scale = out["cpu"].abs().max().item()
        worst = max(worst, diff / scale)
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"mixtral_cross_check: width {width} max "
                                 f"|diff| {diff} above 1e-3 x max|logit| "
                                 f"({scale})")
    emit("mixtral_cross_check", layers=cfg.num_layers, widths=[64, 4],
         max_rel_diff=worst, tol=1e-3, cpu_s=cpu_s)
    del sides
    torch.cuda.empty_cache()


def phase_moe_bwd_vs_plain(tokens=4096):
    """K7 and K8, and the pair behind one pass 1, against the plain
    backward at the train step's shapes (Mixtral 8x7B widths, ``tokens``
    tokens top-2 over 8 experts, block 64, training metadata: every block
    live), fp32 and bf16, element by element (``flash_rel_err``): fp32
    within 1e-4, bf16 against the plain version in fp32 on the same bf16
    inputs, rounded once, within 1e-2. A third case routes no token to
    expert 5 and then hands its padding block to expert 4 and reverses the
    table, so expert 5 owns no block: its dW must be exact zeros. In bf16
    (the tensor-core design) a second launch of the pair must give the
    same bits. Times each entry, its plain version (bf16) and cuBLAS over
    the same rows expert by expert, and computes the bound; times K5 at the
    same shape (the train step's forward), its cuBLAS yardstick and its
    bound."""
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    cfg = MIXTRAL_8X7B
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(310)
    w32 = (torch.randn((e, h, 2, i), generator=gen, device="cuda") * 0.02,
           torch.randn((e, i, h), generator=gen, device="cuda") * 0.02)
    weights = {torch.float32: w32,
               torch.bfloat16: tuple(w.bfloat16() for w in w32)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    entries = ("grouped_glu_dx", "grouped_glu_dw", "grouped_glu_bwd")
    outputs = {"grouped_glu_dx": (0,), "grouped_glu_dw": (1, 2),
               "grouped_glu_bwd": (0, 1, 2)}
    bi = min(512, i)
    results = []
    for n, (case, dtype, tol) in enumerate((
            ("bf16", torch.bfloat16, 1e-2), ("fp32", torch.float32, 1e-4),
            ("bf16_empty_expert", torch.bfloat16, 1e-2))):
        empty = case == "bf16_empty_expert"
        xs, gate_up, down, be, bs = moe_case(600 + n, tokens, weights[dtype],
                                             False, avoid=5 if empty else None)
        if empty:
            be = torch.where(be == 5, 4, be).flip(0).contiguous()
        dy = torch.randn(xs.shape, generator=gen, device="cuda").to(dtype)
        args = (xs, gate_up, down, be, dy, bs, bi)
        # the kernels sum over I in fp32 and round once: held to the plain
        # version in fp32 on the same inputs, rounded once
        ref = bm.grouped_glu_bwd_plain(*(t.float() for t in args[:3]), be,
                                       dy.float(), bs, bi)
        ref = [r.to(dtype) for r in ref]
        res = dict(case=case, dtype=str(dtype), rows=xs.shape[0],
                   blocks=be.numel(), tol=tol, max_rel_err={},
                   max_abs_err={}, design=MOE_BWD_DESIGN[dtype])
        for name in entries:
            got = getattr(bm, f"{name}_cuda")(*args)
            got = (got,) if name == "grouped_glu_dx" else got
            torch.cuda.synchronize()
            if name == "grouped_glu_bwd" and dtype == torch.bfloat16:
                # every sum stays in one CTA in a fixed order: a second
                # launch on the same inputs gives the same bits
                again = bm.grouped_glu_bwd_cuda(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"moe_bwd {case}: two launches of "
                                         "the pair on the same inputs differ")
                res["pair_deterministic"] = True
                del again
            for k, g in zip(outputs[name], got):
                rel = flash_rel_err(g, ref[k])
                label = f"{name}.{('dx', 'dgate_up', 'ddown')[k]}"
                if not (rel <= tol) or not torch.isfinite(g).all():
                    raise AssertionError(f"moe_bwd {case} {label}: error "
                                         f"{rel} of |ref| + rms(row) above "
                                         f"{tol}")
                res["max_rel_err"][label] = rel
                res["max_abs_err"][label] = (g.float() - ref[k].float()
                                             ).abs().max().item()
                if k and empty and g[5].any():
                    raise AssertionError(f"moe_bwd {label}: expert 5 owns "
                                         "no block, its dW is not zero")
            del got
        if not empty:
            timing = {}
            for name in entries:
                kern = getattr(bm, f"{name}_cuda")
                plain = getattr(bm, f"{name}_plain")
                t = dict(kernel_ms=time_ms(lambda: kern(*args), reps=5,
                                           flush=flush),
                         **moe_bound(*args[:4], bs, kind=name))
                if dtype == torch.bfloat16:
                    t["plain_ms"] = time_ms(lambda: plain(*args), reps=2,
                                            flush=flush, warmup=1)
                    t["library_ms"] = time_ms(
                        moe_bwd_library(xs, gate_up, down, be, bs, dy, name),
                        reps=5, flush=flush)
                timing[name] = t
            res["timing"] = timing
            if dtype == torch.bfloat16:
                res["library"] = ("several calls per run of one expert's live "
                                  "blocks: torch.matmul (cuBLAS) x @ "
                                  "gate_up[e] and dy @ down[e].T, the "
                                  "elementwise dg, du, a, then [dg|du] @ "
                                  "gate_up[e].T (dx) and x.T @ [dg|du], "
                                  "a.T @ dy (dW)")
                # K5 where the train step runs it: the same rows forward,
                # its largest grid, with the most pairs of two experts
                got = bm.grouped_glu_cuda(xs, gate_up, down, be, bs, bi)
                want = bm.grouped_glu_plain(
                    *(t.float() for t in (xs, gate_up, down)), be, bs,
                    bi).to(dtype)
                rel = flash_rel_err(got, want)
                if not (rel <= tol) or not torch.isfinite(got).all():
                    raise AssertionError(f"moe_bwd {case}: K5 at the train "
                                         f"shape, error {rel} of |ref| + "
                                         f"rms(row) above {tol}")
                k5 = dict(max_rel_err=rel,
                          max_abs_err=(got.float() - want.float()
                                       ).abs().max().item(),
                          kernel_ms=time_ms(lambda: bm.grouped_glu_cuda(
                              xs, gate_up, down, be, bs, bi), reps=5,
                              flush=flush),
                          library_ms=time_ms(moe_library(
                              xs, gate_up, down, be, bs), reps=5,
                              flush=flush),
                          **moe_bound(xs, gate_up, down, be, bs))
                res["k5_at_train_shape"] = dict(k5, **moe_rates(k5))
                del got, want
        results.append(res)
        del args, xs, dy, ref
        torch.cuda.empty_cache()
    del weights, w32
    torch.cuda.empty_cache()
    emit("moe_bwd_vs_plain", cases=results)
    return results


# ---------------------------------------------------------------------------
# phase 7: the flash kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(seed, b=1, s=4096, n=32, kv=8, d=128, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(b, s, n, d), randn(b, s, kv, d), randn(b, s, kv, d), \
        randn(b, s, n, d)


def flash_rel_err(a: torch.Tensor, r: torch.Tensor) -> float:
    """Largest ``|a - r| / (|r| + rms(r's row) + 1e-3 max|r|)`` over the
    elements, a row being the last dim (D of out/dq/dk/dv, S of lse).
    Kernel and plain version sum in fp32 from the same inputs, except that
    the bf16 K3 and K4 round p and ds once to bf16 before the dq, dk and dv
    products (2^-9 relative on each term, which the sums average; bounded
    on the CPU by ``test_bf16_rounding_of_p_and_ds_is_bounded`` in
    ``tests/test_torch_flash_attention.py``). So they differ by a few
    roundings of each element, and by a few roundings of its row's scale
    where a sum cancels. Causal attention's rows differ in
    scale by orders of magnitude along S, so the scale is the row's: one
    taken over the whole tensor, from its first rows, would let a late row
    drop a term unseen. The small whole-tensor term covers rows that are
    zero but for rounding (causal dq of query 0). Equal elements count 0;
    a NaN stays NaN."""
    a, r = a.double(), r.double()
    row = r.pow(2).mean(-1, keepdim=True).sqrt()
    err = (a - r).abs()
    scale = r.abs() + row + 1e-3 * r.abs().max()
    return torch.where(err == 0, 0.0, err / scale).max().item()


def flash_run(impl, q, k, v, g, causal, p, seed):
    """(out, lse, dq, dk, dv) through the given versions: the kernels'
    wrappers or the plain functions; each backward takes its own forward's
    out and lse."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    fwd, dq_fn, dkv_fn = impl
    out, lse = fwd(q, k, v, causal, None, p, seed)
    delta = fa.attention_delta(g, out)
    args = (q, k, v, g, lse, delta, causal, None, p, seed)
    return (out, lse, dq_fn(*args), *dkv_fn(*args)), delta


def flash_bounds(q, k, causal):
    """Least time of each kernel: the larger of its bytes (each input read
    once, each output written once) over HBM bandwidth and its products
    over the peak rate for the input type. Causal attention does only the
    pairs k <= q; K2 does 2 products (s, pv), K3 3 (s, dp, dq), K4 4 (s,
    dv, dp, dk), 2 FLOP per multiply-add."""
    b, s, n, d = q.shape
    kv = k.shape[2]
    pairs = s * (s + 1) // 2 if causal else s * s
    es = q.element_size()
    qb, kvb, stat = b * s * n * d * es, b * s * kv * d * es, b * n * s * 4
    work = {"flash_fwd": (2, 2 * qb + 2 * kvb + stat),
            "flash_bwd_dq": (3, 3 * qb + 2 * kvb + 2 * stat),
            "flash_bwd_dkv": (4, 2 * qb + 4 * kvb + 2 * stat)}
    out = {}
    for name, (products, nbytes) in work.items():
        flops = 2.0 * products * b * n * pairs * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, flops=flops)
    return out


def sdpa_yardsticks(q, k, v, g, causal, flush):
    """One PyTorch call for the same function, timed as a yardstick only:
    ``F.scaled_dot_product_attention`` forward (K2), and its backward (the
    work of K3 and K4 together), on [B, N, S, D] copies."""
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    with torch.no_grad():
        fwd_ms = time_ms(fwd, flush=flush)
    out = fwd()
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                 retain_graph=True),
                     flush=flush)
    return fwd_ms, bwd_ms


def check_flash_mask(dtype):
    """q = k = 0 makes every valid score equal (p exactly 1, also in bf16),
    so with V one-hot over a window of D keys K2's output is keep / (l (1 -
    p)): its nonzero pattern is the kernel's mask, held bit for bit against
    dropout_keep_mask (and causality) over all 512 x 512 (q, k) pairs of
    all 32 heads; in ``dtype`` (bf16: the tensor-core K2, fp32: the
    CUDA-core one)."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    b, s, n, kv, d, p, seed = 1, 512, 32, 8, 128, 0.1, 0xC0FFEE
    q = torch.zeros(b, s, n, d, device="cuda", dtype=dtype)
    k = torch.zeros(b, s, kv, d, device="cuda", dtype=dtype)
    q_pos = torch.arange(s, device="cuda")[:, None]
    kept = total = 0
    for k0 in range(0, s, d):
        v = torch.zeros(b, s, kv, d, device="cuda", dtype=dtype)
        v[0, k0:k0 + d] = torch.eye(d, device="cuda")[:, None, :]
        out, _ = fa.flash_fwd_cuda(q, k, v, True, None, p, seed)
        k_pos = torch.arange(k0, k0 + d, device="cuda")[None, :]
        want = fa.dropout_keep_mask(seed, fa.flat_bh(b, n, "cuda"), q_pos,
                                    k_pos, s, p) & (k_pos <= q_pos)
        got = out.permute(0, 2, 1, 3) != 0
        if not torch.equal(got, want):
            raise AssertionError(f"flash dropout mask differs from the plain "
                                 f"mask in {(got != want).sum().item()} "
                                 f"places (keys {k0}..{k0 + d - 1})")
        kept += int(want.sum())
        total += int((k_pos <= q_pos).sum()) * n
    return dict(pairs=total, kept_share=kept / total)


def phase_flash_vs_plain():
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    plains = (fa.flash_fwd_plain, fa.flash_bwd_dq_plain,
              fa.flash_bwd_dkv_plain)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = [
        ("bf16", {}, True, 0.0, 2e-2),
        ("fp32", dict(dtype=torch.float32), True, 0.0, 1e-4),
        ("bf16_dropout", {}, True, 0.1, 2e-2),
        ("bf16_d64", dict(d=64), True, 0.0, 2e-2),
        ("bf16_nrep1", dict(kv=32), True, 0.0, 2e-2),
        ("bf16_noncausal", {}, False, 0.0, 2e-2),
        ("bf16_s1000", dict(s=1000), True, 0.0, 2e-2),
    ]
    names = ("out", "lse", "dq", "dk", "dv")
    results = []
    for i, (case, kw, causal, p, tol) in enumerate(cases):
        q, k, v, g = flash_inputs(200 + i, **kw)
        seed = 1234 + i
        (got, delta), (ref, _) = (flash_run(impl, q, k, v, g, causal, p, seed)
                                  for impl in (kernels, plains))
        torch.cuda.synchronize()
        errs, rels = {}, {}
        for name, a, r in zip(names, got, ref):
            rel = flash_rel_err(a, r)
            if not (rel <= tol) or not torch.isfinite(a).all():
                raise AssertionError(f"flash {case} {name}: error {rel} of "
                                     f"|ref| + rms(row) above {tol}")
            errs[name] = (a.float() - r.float()).abs().max().item()
            rels[name] = rel
        res = dict(case=case, causal=causal, dropout_p=p, tol=tol,
                   shape=list(q.shape), kv_heads=k.shape[2],
                   dtype=str(q.dtype), max_abs_err=errs, max_rel_err=rels)
        if q.dtype == torch.bfloat16:
            # K2, K3 and K4 sum inside one CTA in a fixed order: a second
            # launch on the same inputs gives the same bits
            bwd = (q, k, v, g, got[1], delta, causal, None, p, seed)
            again = (*kernels[0](q, k, v, causal, None, p, seed),
                     kernels[1](*bwd), *kernels[2](*bwd))
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"flash {case} {name}: two launches "
                                         "on the same inputs differ")
            res["deterministic"] = True
        res["design"] = FLASH_DESIGN[q.dtype]
        if case in ("bf16", "fp32"):
            out, lse = got[0], got[1]
            bwd = (q, k, v, g, lse, delta, causal, None, p, seed)
            calls = {"flash_fwd": (lambda: kernels[0](q, k, v, causal),
                                   lambda: plains[0](q, k, v, causal)),
                     "flash_bwd_dq": (lambda: kernels[1](*bwd),
                                      lambda: plains[1](*bwd)),
                     "flash_bwd_dkv": (lambda: kernels[2](*bwd),
                                       lambda: plains[2](*bwd))}
            bounds = flash_bounds(q, k, causal)
            timing = {}
            for name, (kern, plain) in calls.items():
                timing[name] = dict(
                    kernel_ms=time_ms(kern, flush=flush),
                    plain_ms=time_ms(plain, reps=5, flush=flush),
                    **bounds[name])
                timing[name]["tflops"] = (bounds[name]["flops"]
                                          / timing[name]["kernel_ms"] / 1e9)
            if case == "bf16":
                fwd_ms, bwd_ms = sdpa_yardsticks(q, k, v, g, causal, flush)
                timing["flash_fwd"]["library_ms"] = fwd_ms
                timing["flash_bwd_dq"]["library_ms"] = bwd_ms
                timing["flash_bwd_dkv"]["library_ms"] = bwd_ms
                res["library"] = ("F.scaled_dot_product_attention (is_causal, "
                                  "enable_gqa): forward for flash_fwd; its "
                                  "backward (dq, dk, dv together) for both "
                                  "backward kernels")
            res["timing"] = timing
        results.append(res)
        del q, k, v, g, got, ref, delta
        torch.cuda.empty_cache()
    mask = {str(dt): check_flash_mask(dt)
            for dt in (torch.bfloat16, torch.float32)}
    emit("flash_vs_plain", cases=results, dropout_mask=mask)
    rates = {c["case"]: {name: t["tflops"] for name, t in c["timing"].items()}
             for c in results if "timing" in c}
    t = next(c for c in results if c["case"] == "bf16")["timing"]
    k2 = t["flash_fwd"]
    emit("flash_fwd_k2", k2_ms=k2["kernel_ms"], tflops=k2["tflops"],
         sdpa_fwd_ms=k2["library_ms"],
         factor_vs_sdpa_fwd=k2["kernel_ms"] / k2["library_ms"],
         bound_ms=k2["bound_ms"],
         fp32_k2_ms=next(c for c in results if c["case"] == "fp32")[
             "timing"]["flash_fwd"]["kernel_ms"])
    pair = t["flash_bwd_dq"]["kernel_ms"] + t["flash_bwd_dkv"]["kernel_ms"]
    emit("flash_bwd_pair", tflops=rates, k3_k4_ms=pair,
         sdpa_bwd_ms=t["flash_bwd_dq"]["library_ms"],
         factor_vs_sdpa_bwd=pair / t["flash_bwd_dq"]["library_ms"],
         bound_ms=t["flash_bwd_dq"]["bound_ms"]
         + t["flash_bwd_dkv"]["bound_ms"])
    return results


# ---------------------------------------------------------------------------
# phases 8-9: the train step
# ---------------------------------------------------------------------------

def phase_train(steps=5, seq=4096, mixtral=False):
    """``train`` (Llama-3-8B widths, 4 layers) or ``train_mixtral``
    (Mixtral 8x7B widths, 2 layers, blockwise): ``steps`` steps of the
    workload on one batch; the kernels' counts are set to 0 just before and
    read just after."""
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.scripts.workloads import (
        llama3_train_workload, mixtral_train_workload)

    phase = "train_mixtral" if mixtral else "train"
    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    if mixtral:
        counters.update({name: getattr(bm, name) for name in (
            "grouped_glu", "grouped_glu_decode", "grouped_glu_dx",
            "grouped_glu_dw")})
    torch.cuda.reset_peak_memory_stats()
    w = (mixtral_train_workload(layers=2, seq=seq) if mixtral
         else llama3_train_workload(layers=4, seq=seq))
    cfg, state, step, batch = w.cfg, w.state, w.step, w.batch
    n_params = sum(p.numel() for p in state.params.values())
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{phase}: non-finite loss or grad norm: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall: {losses}")
    if state.step != steps:
        raise AssertionError(f"{phase}: state.step {state.step} != {steps}")
    for name, n in launches.items():
        want = 0 if name == "grouped_glu_decode" else cfg.num_layers * steps
        if n != want:
            raise AssertionError(f"{phase}: {name} launched {n} times, want "
                                 f"{want} (layers x steps, or none)")
    p50 = float(np.median(times))
    emit(phase, layers=cfg.num_layers, params=n_params, seq=seq,
         compute_dtype=str(cfg.dtype), param_dtype=str(cfg.param_dtype),
         steps=steps, losses=losses, grad_norms=norms, step_ms=times,
         step_ms_p50=p50, tokens_per_s=seq / (p50 / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    del w, state, step
    torch.cuda.empty_cache()
    return launches


def phase_train_cross_check(base_cfg, layers=2, seq=256, steps=2,
                            phase="train_cross_check", **cfg_kw):
    """Two fp32 steps at full width on the card and on the CPU path, from
    the same weights and batch. The second step's loss and grad norm depend
    on the first update. The updates themselves, ``p_after - p_before``,
    are held in norm per parameter: Adam's first step moves an element by
    ``lr g / (|g| + eps)``, so an element whose gradient is within rounding
    of zero may move by any fraction of ``lr`` on either side, and no
    element-wise limit below ``lr`` would hold; the norm bounds how much
    of the update such elements carry. A Mixtral config first has both
    sides route every token to the same experts in every step, so that a
    failure names its cause."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
    from neuronx_distributed_tpu_torch.models import llama, mixtral
    from neuronx_distributed_tpu_torch.scripts.workloads import train_batch

    cfg = dataclasses.replace(base_cfg, num_layers=layers,
                              dtype=torch.float32, param_dtype=torch.float32,
                              use_flash_attention=True, **cfg_kw)
    family = mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama
    sd = family.init_state_dict(cfg, seed=1, std=0.02, device="cpu")
    batch = train_batch(cfg.vocab_size, seq, seed=1)
    side = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pm, params = trainer.initialize_parallel_model(
            neuronx_distributed_config(), cfg, state_dict=sd, device=dev)
        routes = []
        for layer in pm.module.layers:
            if hasattr(layer, "moe"):
                layer.moe.router.register_forward_hook(
                    lambda mod, inp, out, r=routes: r.append(out[1].cpu()))
        tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
        step = trainer.make_train_step(pm, tx)
        metrics = [step(state, batch)[1] for _ in range(steps)]
        side[dev] = ([(m["loss"].item(), m["grad_norm"].item())
                      for m in metrics],
                     {n: p.detach().cpu() - sd[n] for n, p in params.items()},
                     time.perf_counter() - t0, routes)
        del pm, params, tx, state, step
    torch.cuda.empty_cache()
    (mg, ug, tg, rg), (mc, uc, tc, rc) = side["cuda"], side["cpu"]
    if len(rg) != len(rc) or any(not torch.equal(a, b)
                                 for a, b in zip(rg, rc)):
        moved = sum(int((a != b).any(-1).sum()) for a, b in zip(rg, rc))
        raise AssertionError(f"{phase}: the card routed {moved} token(s) "
                             "to other experts than the CPU")
    for i, ((lg, ng), (lc, nc)) in enumerate(zip(mg, mc)):
        if not abs(lg - lc) <= 1e-4 * abs(lc):
            raise AssertionError(f"{phase}: step {i + 1} loss {lg} vs CPU "
                                 f"{lc}")
        if not abs(ng - nc) <= 1e-3 * abs(nc):
            raise AssertionError(f"{phase}: step {i + 1} grad norm {ng} vs "
                                 f"CPU {nc}")
    if not mc[-1][0] < mc[0][0] - 1e-2:
        raise AssertionError(f"{phase}: the update did not lower the loss: "
                             f"{mc}")
    worst, worst_name, worst_elem = 0.0, None, 0.0
    for name, ref in uc.items():
        diff = ug[name] - ref
        rel = (diff.norm() / ref.norm()).item()
        if rel > worst:
            worst, worst_name = rel, name
        worst_elem = max(worst_elem, (diff.abs().max()
                                      / ref.abs().max()).item())
        if not rel <= 1e-3:
            raise AssertionError(f"{phase}: {name}'s update differs by {rel} "
                                 "of its norm, above 1e-3")
    del sd
    emit(phase, layers=layers, seq=seq, steps=steps,
         loss_card=[m[0] for m in mg], loss_cpu=[m[0] for m in mc],
         grad_norm_card=[m[1] for m in mg], grad_norm_cpu=[m[1] for m in mc],
         max_update_rel_diff=worst, max_update_rel_diff_param=worst_name,
         max_update_elem_diff_of_max=worst_elem, routed_calls=len(rc),
         card_s=tg, cpu_s=tc)


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
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(libs))

    cases = phase_kernel_vs_plain()

    ecfg = EngineConfig(block_size=16, num_blocks=2048, max_slots=8,
                        max_blocks_per_seq=128, token_budget=512)
    launches = serve(LLAMA3_8B, ecfg, "serve")["paged_attention"]
    serve(dataclasses.replace(LLAMA3_8B, num_layers=4),
          dataclasses.replace(ecfg, quantized=True), "serve_int8")
    phase_cross_check(LLAMA3_8B)
    moe_cases = phase_moe_vs_plain()
    mixtral = dataclasses.replace(MIXTRAL_8X7B, num_layers=8,
                                  moe_dispatch="blockwise", moe_block_size=64)
    moe_launches = {
        "grouped_glu": serve(mixtral, ecfg, "serve_mixtral")["grouped_glu"],
        "grouped_glu_decode": serve(
            mixtral, dataclasses.replace(ecfg, disaggregated=True,
                                         max_slots=4, prefill_budget=512),
            "serve_mixtral_disagg")["grouped_glu_decode"]}
    phase_mixtral_cross_check(MIXTRAL_8X7B)
    bwd_cases = phase_moe_bwd_vs_plain()
    flash_cases = phase_flash_vs_plain()
    flash_launches = phase_train()
    phase_train_cross_check(LLAMA3_8B)
    train_launches = phase_train(mixtral=True)
    phase_train_cross_check(MIXTRAL_8X7B, layers=1,
                            phase="mixtral_train_cross_check",
                            moe_dispatch="blockwise", moe_block_size=64)

    main_case = next(c for c in cases if c["case"] == "bf16")
    summary = [{
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(c["max_err"] for c in cases),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "max_err": max(c["max_err"] for c in cases),
        "design": K1_DESIGN["tensor_cores"] + "; other types: "
                  + K1_DESIGN["cuda_cores"],
        "cases_ms": {c["case"]: c["kernel_ms"] for c in cases
                     if "kernel_ms" in c}}]
    flash_main = next(c for c in flash_cases if c["case"] == "bf16")
    outputs = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
               "flash_bwd_dkv": ("dk", "dv")}
    for name, replaces in FLASH_KERNELS:
        t = flash_main["timing"][name]
        err = max(c["max_abs_err"][o] for c in flash_cases
                  for o in outputs[name])
        summary.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": flash_launches[name],
            "max_abs_err": err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_ms": t["kernel_ms"], "max_err": err,
            "design": f"bf16: {FLASH_DESIGN[torch.bfloat16]}; fp32: "
                      f"{FLASH_DESIGN[torch.float32]}"})
    for name, replaces in MOE_KERNELS:
        main_case = next(c for c in moe_cases
                         if c["kernel"] == name and c["case"].endswith("bf16"))
        err = max(c["max_abs_err"] for c in moe_cases if c["kernel"] == name)
        summary.append({
            "name": name, "route": "cuda", "source": MOE_SOURCE,
            "replaces": replaces, "launches": moe_launches[name],
            "max_abs_err": err, "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "kernel_ms": main_case["kernel_ms"], "max_err": err,
            "design": main_case["design"]})
    bwd_main = next(c for c in bwd_cases if c["case"] == "bf16")
    for name, replaces in MOE_BWD_KERNELS:
        t = bwd_main["timing"][name]
        err = max(v for c in bwd_cases for k, v in c["max_abs_err"].items()
                  if k.startswith(f"{name}."))
        summary.append({
            "name": name, "route": "cuda", "source": MOE_SOURCE,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_ms": t["kernel_ms"], "max_err": err,
            "design": bwd_main["design"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
