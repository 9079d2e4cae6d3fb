"""Flash attention with its backward (counterpart of
``neuronx_distributed_tpu/ops/flash_attention.py``).

Three kernels, each with a plain PyTorch version behind one signature:

* forward (K2): :func:`flash_fwd` -> ``(out [B,S,N,D], lse [B,N,S] fp32)``.
  The plain version mirrors the JAX package's blockwise scan
  ``_flash_xla_impl``; the kernel replaces the Pallas ``_flash_fwd_kernel``.
* dq (K3): :func:`flash_bwd_dq`, and dk/dv (K4): :func:`flash_bwd_dkv`. The
  plain versions split the JAX package's ``_flash_bwd_from_lse``; the
  kernels replace ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``.
  ``delta = rowsum(g * out)`` is computed in PyTorch outside the kernels, as
  the JAX package computes it in XLA.

Each dispatcher chooses by the device of ``q``: CPU tensors take the plain
version, CUDA tensors the kernel (``csrc/flash_attention.cu``, bound with
:mod:`ctypes`), which launches or raises; nothing falls back. The C entries
choose the kernel by the input type: bf16 runs the tensor-core kernels
(``tc::flash_fwd_wgmma``, ``tc::flash_bwd_dq_wgmma``,
``tc::flash_bwd_dkv_wgmma``), fp32 the CUDA-core ones. Every kernel
wrapper adds one to its dispatcher's ``launches`` per launch, whichever
kernel it launched.

K/V may carry fewer heads than q (grouped-query attention): ``k``/``v``
``[B, S, KV, D]`` with ``N % KV == 0``, query head ``n`` reading kv head
``n // (N // KV)``, as ``repeat_kv`` would arrange them. The JAX functions
take K/V already expanded; passing ``KV == N`` is that interface.

Attention dropout uses the JAX package's counter hash
(:func:`dropout_keep_mask`, :func:`flat_bh`) on global (q, k) coordinates
and the flat batch x query-head index, so the plain versions, the kernels
and the JAX package draw the same mask for the same seed.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
# The first call of a custom operator (flash_fwd_op below) imports
# torch._dynamo, and one of its modules applies torch.fx.wrap at import,
# whose frame refers to itself. Imported from inside a forward, that cycle
# would keep the whole calling stack (the model, its activations) alive
# until a garbage collection; imported here, it keeps nothing of a caller.
import torch._dynamo  # noqa: F401

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
BLOCK_K = 512          # the plain versions' key block, as in the JAX scan

# nxd_flash_fwd(dtype, q, k, v, out, lse, B, S, N, KV, D, scale, causal,
#   dropout, threshold, seed, inv_keep, stream) in csrc/flash_attention.cu;
# nxd_flash_bwd_dq(dtype, q, k, v, g, lse, delta, dq, B, S, N, KV, D, ...)
# and nxd_flash_bwd_dkv(dtype, q, k, v, g, lse, delta, dk, dv, B, ...) end
# in the same trailing arguments.
_TAIL = ([ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                               ctypes.c_void_p])
FWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + _TAIL
DQ_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 7 + _TAIL
DKV_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + _TAIL


# ---------------------------------------------------------------------------
# dropout mask
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``b``, in halves so no int64 product overflows."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def dropout_keep_mask(seed, head_idx: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, sk: int, p: float) -> torch.Tensor:
    """Boolean keep mask from integer coordinates (broadcastable), bit for
    bit the JAX package's ``dropout_keep_mask``: the counter ``q * sk + k``
    xored with a per-(seed, head) hash, mixed by the murmur3 finalizer, kept
    where the result is at least ``round(p * 0xFFFFFFFF)``. Computed in int64
    with every product and shift reduced mod 2**32."""
    seed = torch.as_tensor(seed, dtype=torch.int64,
                           device=head_idx.device) & _M32
    h = (seed + _mul32(head_idx.to(torch.int64) & _M32, 0x9E3779B9)) & _M32
    h = _mul32(h ^ (h >> 16), 0x21F0AAAD)
    x = (_mul32(q_pos.to(torch.int64) & _M32, sk & _M32)
         + (k_pos.to(torch.int64) & _M32)) & _M32
    x = x ^ h
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= round(p * 0xFFFFFFFF)


def flat_bh(b: int, n: int, device=None) -> torch.Tensor:
    """``[B, N, 1, 1]`` flat batch*head coordinate ``b * N + n`` of the
    dropout mask (batch-major, over query heads)."""
    return (torch.arange(b, device=device)[:, None] * n
            + torch.arange(n, device=device)[None, :])[..., None, None]


def _dropout_args(dropout_p: float, seed: Optional[int]):
    """(on, threshold, seed, inv_keep) as the kernels take them."""
    if dropout_p <= 0.0:
        return 0, 0, 0, 1.0
    return (1, round(dropout_p * 0xFFFFFFFF), int(seed) & _M32,
            1.0 / (1.0 - dropout_p))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, N, D] and k/v [B, S, KV, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, n, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (self-attention: one length)")
    if n % k.shape[2]:
        raise ValueError(f"q heads {n} not a multiple of kv heads "
                         f"{k.shape[2]}")


def _scale(q, scale):
    return (1.0 / math.sqrt(q.shape[-1])) if scale is None else float(scale)


def _grouped(q, k, v, acc):
    """q as ``[B, KV, R, S, D]``, k/v as ``[B, KV, S, D]``, in ``acc``."""
    b, s, n, d = q.shape
    kv = k.shape[2]
    qt = q.to(acc).permute(0, 2, 1, 3).reshape(b, kv, n // kv, s, d)
    return qt, k.to(acc).permute(0, 2, 1, 3), v.to(acc).permute(0, 2, 1, 3)


def _acc_dtype(q):
    # float64 inputs keep float64 (gradcheck); everything else sums in fp32
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _block_terms(qt, kb, k0, causal, scale, dropout_p, seed, bh, q_pos, s):
    """Scores of one key block, their causal/ragged validity, and the keep
    mask (None without dropout)."""
    k_pos = torch.arange(k0, k0 + kb.shape[2], device=qt.device)
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qt, kb) * scale
    keep = None
    if causal:
        sc = sc.masked_fill(~(q_pos[:, None] >= k_pos[None, :]),
                            float("-inf"))
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, bh, q_pos[:, None], k_pos[None, :], s,
                                 dropout_p)
    return sc, keep


def _bh(b, n, kv, device):
    """flat_bh arranged as ``[B, KV, R, 1, 1]`` to match grouped scores."""
    return flat_bh(b, n, device).reshape(b, kv, n // kv, 1, 1)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    dropout_p: float = 0.0, seed: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online-softmax forward, as ``_flash_xla_impl``: returns
    ``(out [B,S,N,D] in q's dtype, lse [B,N,S])``; lse is -inf for a row
    with no valid key."""
    _check(q, k, v)
    b, s, n, d = q.shape
    kv = k.shape[2]
    scale = _scale(q, scale)
    acc_t = _acc_dtype(q)
    qt, kt, vt = _grouped(q, k, v, acc_t)
    q_pos = torch.arange(s, device=q.device)
    bh = _bh(b, n, kv, q.device)
    m = torch.full(qt.shape[:-1], float("-inf"), dtype=acc_t, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qt)
    for k0 in range(0, s, BLOCK_K):
        kb, vb = kt[:, :, k0:k0 + BLOCK_K], vt[:, :, k0:k0 + BLOCK_K]
        sc, keep = _block_terms(qt, kb, k0, causal, scale, dropout_p, seed,
                                bh, q_pos, s)
        m_new = torch.maximum(m, sc.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe[..., None]),
                        0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        p_acc = p if keep is None else torch.where(keep, p, 0.0)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bgkd->bgrqd",
                                                   p_acc, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if dropout_p > 0.0:
        out = out * (1.0 / (1.0 - dropout_p))
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      float("-inf"))
    out = out.reshape(b, n, s, d).transpose(1, 2).to(q.dtype)
    return out, lse.reshape(b, n, s)


def _bwd_blocks(q, k, v, g, lse, delta, causal, scale, dropout_p, seed):
    """The loop of ``_flash_bwd_from_lse``: per key block, yield ``(k
    block, q, g, p_v, ds)`` with q/g grouped ``[B, KV, R, S, D]`` and the
    dropped probabilities ``p_v`` and ``ds`` ``[B, KV, R, S, BK]``,
    recomputed from the saved lse."""
    b, s, n, d = q.shape
    kv = k.shape[2]
    acc_t = _acc_dtype(q)
    qt, kt, vt = _grouped(q, k, v, acc_t)
    gt = g.to(acc_t).permute(0, 2, 1, 3).reshape(qt.shape)
    lse_t = lse.to(acc_t).reshape(b, kv, n // kv, s)[..., None]
    delta_t = delta.to(acc_t).reshape(b, kv, n // kv, s)[..., None]
    q_pos = torch.arange(s, device=q.device)
    bh = _bh(b, n, kv, q.device)
    inv_keep = 1.0 / (1.0 - dropout_p) if dropout_p > 0.0 else 1.0
    for k0 in range(0, s, BLOCK_K):
        kb, vb = kt[:, :, k0:k0 + BLOCK_K], vt[:, :, k0:k0 + BLOCK_K]
        sc, keep = _block_terms(qt, kb, k0, causal, scale, dropout_p, seed,
                                bh, q_pos, s)
        p = torch.where(torch.isfinite(sc), torch.exp(sc - lse_t), 0.0)
        dp = torch.einsum("bgrqd,bgkd->bgrqk", gt, vb)
        if keep is not None:
            p_v = torch.where(keep, p * inv_keep, 0.0)
            dp = torch.where(keep, dp * inv_keep, 0.0)
        else:
            p_v = p
        ds = p * (dp - delta_t) * scale
        yield kb, qt, gt, p_v, ds


def flash_bwd_dq_plain(q, k, v, g, lse, delta, causal: bool = True,
                       scale: Optional[float] = None, dropout_p: float = 0.0,
                       seed: Optional[int] = None) -> torch.Tensor:
    """dq of the flash backward (K3's plain version): ``g`` like q, ``lse``
    and ``delta`` ``[B, N, S]``; returns dq in q's dtype."""
    _check(q, k, v)
    b, s, n, d = q.shape
    scale = _scale(q, scale)
    dq = None
    for kb, _, _, _, ds in _bwd_blocks(q, k, v, g, lse, delta, causal, scale,
                                       dropout_p, seed):
        part = torch.einsum("bgrqk,bgkd->bgrqd", ds, kb)
        dq = part if dq is None else dq + part
    return dq.reshape(b, n, s, d).transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal: bool = True,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv of the flash backward (K4's plain version), summed over each
    kv head's query heads; returned ``[B, S, KV, D]`` in k's dtype."""
    _check(q, k, v)
    scale = _scale(q, scale)
    dks, dvs = [], []
    for _, qt, gt, p_v, ds in _bwd_blocks(q, k, v, g, lse, delta, causal,
                                          scale, dropout_p, seed):
        dvs.append(torch.einsum("bgrqk,bgrqd->bgkd", p_v, gt))
        dks.append(torch.einsum("bgrqk,bgrqd->bgkd", ds, qt))
    dk = torch.cat(dks, dim=2).transpose(1, 2).contiguous().to(k.dtype)
    dv = torch.cat(dvs, dim=2).transpose(1, 2).contiguous().to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check_kernel_args(name, q, k, v, extra=(), stats=()):
    """Raise on anything the kernels do not take: ``extra`` are tensors
    shaped like q (g), ``stats`` the fp32 ``[B, N, S]`` lse and delta."""
    _check(q, k, v)
    for t in (q, k, v, *extra, *stats):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} needs every tensor on {q.device}; got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if q.dtype not in _CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (fp32, "
                         "bf16)")
    for t in (k, v, *extra):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: every input must be {q.dtype}")
    b, s, n, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"{name}: head_dim must be 64 or 128, got {d}")
    if b * n > 65535:
        raise ValueError(f"{name}: B*N {b * n} above 65535")
    for t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name}: g must match q's shape")
    for t in stats:
        if t.shape != (b, n, s) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be fp32 [B, N, S]")


def _lib_fn(name, argtypes):
    from . import _build

    fn = getattr(_build.load("flash_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _tail(q, k, scale, causal, dropout_p, seed):
    b, s, n, d = q.shape
    on, thr, sd, inv = _dropout_args(dropout_p, seed)
    return (b, s, n, k.shape[2], d, _scale(q, scale), int(bool(causal)), on,
            thr, sd, inv, torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def flash_fwd_cuda(q, k, v, causal: bool = True,
                   scale: Optional[float] = None, dropout_p: float = 0.0,
                   seed: Optional[int] = None):
    """Launch K2 on the current stream; checks and raises on anything the
    kernel does not take. Adds one to ``flash_fwd.launches``."""
    _check_kernel_args("flash_fwd_cuda", q, k, v)
    b, s, n, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, n, s), dtype=torch.float32, device=q.device)
    fn = _lib_fn("nxd_flash_fwd", FWD_ARGTYPES)
    _raise_on(fn(_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 *_tail(q, k, scale, causal, dropout_p, seed)), "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal: bool = True,
                      scale: Optional[float] = None, dropout_p: float = 0.0,
                      seed: Optional[int] = None):
    """Launch K3; adds one to ``flash_bwd_dq.launches``."""
    _check_kernel_args("flash_bwd_dq_cuda", q, k, v, (g,), (lse, delta))
    dq = torch.empty_like(q)
    fn = _lib_fn("nxd_flash_bwd_dq", DQ_ARGTYPES)
    _raise_on(fn(_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), *_tail(q, k, scale, causal, dropout_p, seed)),
              "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal: bool = True,
                       scale: Optional[float] = None,
                       dropout_p: float = 0.0, seed: Optional[int] = None):
    """Launch K4; adds one to ``flash_bwd_dkv.launches``."""
    _check_kernel_args("flash_bwd_dkv_cuda", q, k, v, (g,), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _lib_fn("nxd_flash_bwd_dkv", DKV_ARGTYPES)
    _raise_on(fn(_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(),
                 *_tail(q, k, scale, causal, dropout_p, seed)),
              "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------

def _dispatch(name, plain, cuda, q, *args):
    if q.device.type == "cpu":
        return plain(q, *args)
    if q.is_cuda:
        return cuda(q, *args)
    raise ValueError(f"{name} has no path for device {q.device}")


def flash_fwd(q, k, v, causal=True, scale=None, dropout_p=0.0, seed=None):
    """Flash forward: ``(out, lse)``. CPU -> plain, CUDA -> K2."""
    return _dispatch("flash_fwd", flash_fwd_plain, flash_fwd_cuda, q, k, v,
                     causal, scale, dropout_p, seed)


def flash_bwd_dq(q, k, v, g, lse, delta, causal=True, scale=None,
                 dropout_p=0.0, seed=None):
    """dq of the flash backward. CPU -> plain, CUDA -> K3."""
    return _dispatch("flash_bwd_dq", flash_bwd_dq_plain, flash_bwd_dq_cuda,
                     q, k, v, g, lse, delta, causal, scale, dropout_p, seed)


def flash_bwd_dkv(q, k, v, g, lse, delta, causal=True, scale=None,
                  dropout_p=0.0, seed=None):
    """dk, dv of the flash backward. CPU -> plain, CUDA -> K4."""
    return _dispatch("flash_bwd_dkv", flash_bwd_dkv_plain,
                     flash_bwd_dkv_cuda, q, k, v, g, lse, delta, causal,
                     scale, dropout_p, seed)


#: kernel launches since each count was last set to 0
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def attention_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(g * out)`` in fp32 (float64 stays float64), as
    ``[B, N, S]``; the backward kernels take it precomputed."""
    acc = _acc_dtype(out)
    return (g.to(acc) * out.to(acc)).sum(-1).transpose(1, 2).contiguous()


@torch.library.custom_op(
    "nxd_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float? scale, "
           "float dropout_p, int seed) -> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, causal, scale, dropout_p, seed):
    """:func:`flash_fwd` as an operator of its own, so that remat's
    op-by-op policies see it: ``remat_policy="save_attention"`` keeps its
    ``(out, lse)``, the reference's named residuals ``flash_out`` and
    ``flash_lse``, and the recompute replays them instead of launching
    K2 again (:mod:`..utils.remat`)."""
    return flash_fwd(q, k, v, causal, scale, dropout_p, seed)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the flash backward: saves ``q, k, v, out, lse``
    and the uint32 seed, as ``_flash_pallas_vjp_fwd`` does, and recomputes
    p from lse in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd_op(q, k, v, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse,
                              torch.tensor([seed], dtype=torch.uint32))
        ctx.causal, ctx.scale, ctx.dropout_p = causal, scale, dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seed_t = ctx.saved_tensors
        seed = int(seed_t[0])
        g = g.contiguous()
        delta = attention_delta(g, out)
        args = (q, k, v, g, lse, delta, ctx.causal, ctx.scale, ctx.dropout_p,
                seed)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    dropout_p: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Flash attention, differentiable. ``q [B, S, N, D]``; ``k``/``v``
    ``[B, S, KV, D]`` with ``N % KV == 0``; returns ``[B, S, N, D]`` in q's
    dtype. ``dropout_p > 0`` needs ``dropout_seed`` (a uint32): the softmax
    normaliser sums the undropped probabilities, dropped entries are zeroed
    and survivors rescaled by 1/(1-p), and the same mask regenerates in the
    backward."""
    if dropout_p > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_p > 0 requires dropout_seed (a uint32 "
                             "scalar; draw one per step)")
        seed = int(dropout_seed) & _M32
    else:
        seed = 0
    return FlashAttentionFunction.apply(q, k, v, causal, scale, dropout_p,
                                        seed)
