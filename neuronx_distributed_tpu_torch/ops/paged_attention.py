"""Paged decode attention over the shared block pool (counterpart of
``neuronx_distributed_tpu/ops/paged_attention.py``).

Two implementations behind one signature:

* :func:`paged_attention_plain` — plain PyTorch, mirroring the JAX
  package's gather-based ``_paged_attention_xla``: gather by clipped
  table, force unmapped entries to ``PAD_POSITION``, fp32 einsums,
  ``-1e30`` masking, softmax. The CPU tests hold it against the JAX
  function, and ``chip_smoke.py`` holds the kernel against it.
* :func:`paged_attention_cuda` — the hand-written Hopper kernels of
  ``csrc/paged_attention.cu`` (replacing the Pallas ``_paged_kernel``),
  bound through :mod:`ctypes`. The types choose the kernel: bf16 q over a
  bf16 pool runs ``tc::paged_attention_wgmma`` on the tensor cores, which
  walks each run of consecutive tokens with equal table rows once for the
  whole run and, where the card would sit idle, splits each run's table
  across :func:`tc_splits` CTAs merged by a second pass; other types run
  the CUDA-core ``paged_attention_kernel``.

:func:`paged_attention` chooses by the device of ``q``: CPU tensors take
the plain version, CUDA tensors the kernel, and nothing falls back. A row
with no valid key (only pad rows can have none) gives zeros in both
versions; the JAX reference's XLA path would give a uniform average there.
Both versions only read the pool.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..inference.kv_cache import PAD_POSITION, dequantize_kv

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int8: 3}
MAX_REP = 16
MAX_BLOCK_SIZE = 256
MAX_SPLITS = 16
ROWS = 64              # query rows of a tensor-core tile: 64 // n_rep tokens
# nxd_paged_attention(q_dtype, pool_dtype, q, k_pool, v_pool, k_scale,
#   v_scale, pool_pos, tables, q_pos, out, partial, T, N, KV, D, BS, MAXB,
#   splits, scale, stream) in csrc/paged_attention.cu
ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])


def tc_splits(t: int, n: int, kv: int, sms: int) -> int:
    """CTAs per (token tile, kv head) of the tensor-core kernel, from the
    shapes alone: enough that the tiles x kv heads fill the card's ``sms``
    SMs four times over (two CTAs an SM, two waves, so a tile that walks
    many runs, as the decode step's first does, is shared out), at most
    ``MAX_SPLITS``."""
    ctas = -(-t // (ROWS // (n // kv))) * kv
    return max(1, min(MAX_SPLITS, 4 * sms // ctas))


def _check_common(q, k_pool, v_pool, k_scale, v_scale):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [T, N, D] and pools [NB, BS, KV, D]; got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    if k_pool.shape != v_pool.shape:
        raise ValueError("k_pool and v_pool shapes differ")
    if q.shape[1] % k_pool.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k_pool.shape[2]}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, pool_pos: torch.Tensor,
                          tables: torch.Tensor, q_pos: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch paged attention; same arguments as
    :func:`paged_attention`."""
    _check_common(q, k_pool, v_pool, k_scale, v_scale)
    t, n, d = q.shape
    nb, bs, kv, _ = k_pool.shape
    n_rep = n // kv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    tables = tables.long()
    safe = torch.clamp(tables, 0, nb - 1)
    kg, vg = k_pool[safe], v_pool[safe]        # [T, maxb, bs, KV, D]
    # entries gathered through an unmapped (-1) table slot are another
    # sequence's data: force their stored position to the pad sentinel
    pg = pool_pos[safe].masked_fill(tables[:, :, None] < 0, PAD_POSITION)
    if k_scale is not None:
        kg = dequantize_kv(kg, k_scale[safe], q.dtype)
        vg = dequantize_kv(vg, v_scale[safe], q.dtype)
    length = tables.shape[1] * bs
    kf = kg.reshape(t, length, kv, d).to(q.dtype).float()
    vf = vg.reshape(t, length, kv, d).to(q.dtype).float()
    # query head g * n_rep + r reads kv head g (repeat_kv's order), grouped
    # here instead of expanding K/V n_rep times
    qf = q.float().reshape(t, kv, n_rep, d)
    scores = torch.einsum("tgrd,tlgd->tgrl", qf, kf) * scale
    mask = (q_pos.long()[:, None] >= pg.reshape(t, length))[:, None, None, :]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tgrl,tlgd->tgrd", probs, vf)
    out = out * mask.any(dim=-1, keepdim=True)   # no valid key -> zeros
    return out.reshape(t, n, d).to(q.dtype)


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, pool_pos: torch.Tensor,
                         tables: torch.Tensor, q_pos: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None, *,
                         splits: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on the current stream. Checks
    device, dtype, shape and contiguity, and raises on anything the kernel
    does not take. Adds one to ``paged_attention.launches`` per launch.
    ``splits`` sets the bf16 tensor-core kernel's split count (default
    :func:`tc_splits`), to time the candidates; every caller on the main
    path leaves it."""
    from . import _build

    _check_common(q, k_pool, v_pool, k_scale, v_scale)
    t, n, d = q.shape
    nb, bs, kv, dk = k_pool.shape
    maxb = tables.shape[-1]
    quantized = k_scale is not None
    args = [q, k_pool, v_pool, pool_pos, tables, q_pos]
    if quantized:
        args += [k_scale, v_scale]
    for a in args:
        if not a.is_cuda or a.device != q.device:
            raise ValueError("paged_attention_cuda needs every tensor on "
                             f"{q.device}; got one on {a.device}")
        if not a.is_contiguous():
            raise ValueError("paged_attention_cuda needs contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"q dtype {q.dtype} not supported")
    if k_pool.dtype not in _CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         "supported")
    if (k_pool.dtype == torch.int8) != quantized:
        raise ValueError("int8 pools need k_scale/v_scale, and only they do")
    if quantized and (k_scale.shape != (nb, bs, kv)
                      or v_scale.shape != (nb, bs, kv)
                      or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError("scales must be fp32 [NB, BS, KV]")
    if dk != d or d not in (64, 128):
        raise ValueError(f"head_dim must be 64 or 128 and match the pool; "
                         f"got q {d}, pool {dk}")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {bs} outside 1..{MAX_BLOCK_SIZE}")
    if n // kv > MAX_REP:
        raise ValueError(f"n_rep {n // kv} above {MAX_REP}")
    if (pool_pos.shape != (nb, bs) or tables.shape != (t, maxb)
            or q_pos.shape != (t,) or maxb < 1):
        raise ValueError("pool_pos must be [NB, BS], tables [T, maxb>=1] and "
                         "q_pos [T]")
    for name, a in (("pool_pos", pool_pos), ("tables", tables),
                    ("q_pos", q_pos)):
        if a.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {a.dtype}")
    out = torch.empty_like(q)
    if t == 0:
        return out
    tensor_cores = q.dtype == k_pool.dtype == torch.bfloat16
    if tensor_cores and splits is None:
        splits = tc_splits(t, n, kv, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
    splits = splits if tensor_cores else 1
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits {splits} outside 1..{MAX_SPLITS}")
    partial = (torch.empty(splits * t * n * (d + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    lib = _build.load("paged_attention")
    fn = lib.nxd_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    ks = k_scale.data_ptr() if quantized else None
    vs = v_scale.data_ptr() if quantized else None
    rc = fn(_CODES[q.dtype], _CODES[k_pool.dtype], q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
            pool_pos.data_ptr(), tables.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            t, n, kv, d, bs, maxb, splits,
            (1.0 / math.sqrt(d)) if scale is None else float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    paged_attention.launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, pool_pos: torch.Tensor,
                    tables: torch.Tensor, q_pos: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention.

    ``q [T, N, D]`` one query row per packed token; ``k_pool``/``v_pool``
    ``[num_blocks, block_size, KV, D]`` (int8 when ``k_scale``/``v_scale``
    ``[num_blocks, block_size, KV]`` fp32 are given); ``pool_pos
    [num_blocks, block_size]`` int32 stored token positions (PAD_POSITION =
    empty); ``tables [T, max_blocks_per_seq]`` int32 per-token block table
    (-1 = unmapped); ``q_pos [T]`` int32 query positions. Returns ``[T, N,
    D]`` in ``q``'s dtype.

    CPU tensors run :func:`paged_attention_plain`; CUDA tensors run the
    kernel (:func:`paged_attention_cuda`), which raises on what it does not
    take.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, pool_pos, tables,
                                     q_pos, k_scale, v_scale, scale)
    if q.is_cuda:
        return paged_attention_cuda(q, k_pool, v_pool, pool_pos, tables,
                                    q_pos, k_scale, v_scale, scale)
    raise ValueError(f"paged_attention has no path for device {q.device}")


#: kernel launches since the count was last set to 0
paged_attention.launches = 0
