"""Grouped GLU of the dropless MoE, forward only (counterpart of
``neuronx_distributed_tpu/ops/blockwise_moe.py``).

Tokens arrive sorted by expert in fixed-size blocks (``xs [P, H]``, the
layout of :func:`..modules.moe.blockwise.scatter_to_blocks`), and block
``b`` runs ``silu(x_b·Wg_e)·(x_b·Wu_e)·Wd_e`` with ``e = block_expert[b]``.
Weights are the stacked expert banks ``gate_up [E, H, 2, I]`` (gate at
index 0, up at 1) and ``down [E, I, H]``. A block whose ``block_expert[b] >=
E`` is a *sentinel*: its rows are exact zeros and no weight is read for it.

Two kernels, each with a plain PyTorch version behind one signature:

* K5, :func:`grouped_glu`: the packed-step kernel. The plain version
  mirrors the JAX reference ``_ref_fwd``: per ``block_i`` tile of the
  intermediate dim an fp32 partial, rounded to the output dtype and added.
  The kernel replaces the Pallas ``_glu_fwd_kernel``.
* K6, :func:`grouped_glu_decode`: the same function for decode, where what
  matters is the weight traffic: sentinel blocks read no weight byte, and on
  ``sentinel_empty`` metadata of a narrow step each hit expert holds one
  block, so its weights are read once. The plain version mirrors
  ``_ref_decode_fwd``: fp32 partials ``[num_ib, P, H]``, summed, cast once.
  The kernel replaces ``_glu_fwd_decode_kernel``.

Both run the same CUDA kernels (``csrc/blockwise_moe.cu``, bound with
:mod:`ctypes`) through entry points of their own. They sum over the whole
intermediate dim in fp32 and round once, so in bf16 K5 is closer to the fp32
result than its plain version, which rounds once per tile.

Each dispatcher chooses by the device of ``xs``: CPU tensors take the plain
version, CUDA tensors the kernel, which launches or raises; nothing falls
back. The kernels have no backward (the Pallas backward kernels K7 and K8
are not ported yet): on CUDA an input that requires grad, with grad mode on,
raises. Every kernel wrapper adds one to its dispatcher's ``launches`` per
launch.
"""

from __future__ import annotations

import ctypes

import torch

_CODES = {torch.float32: 0, torch.bfloat16: 1}
# nxd_grouped_glu / nxd_grouped_glu_decode(dtype, xs, gate_up, down,
#   block_expert, act, ys, P, H, I, E, block_size, stream) in
#   csrc/blockwise_moe.cu
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])


def _check(xs, gate_up, down, block_expert, block_size, block_i):
    if xs.dim() != 2 or gate_up.dim() != 4 or down.dim() != 3:
        raise ValueError(f"xs must be [P, H], gate_up [E, H, 2, I] and down "
                         f"[E, I, H]; got {tuple(xs.shape)}, "
                         f"{tuple(gate_up.shape)} and {tuple(down.shape)}")
    p, h = xs.shape
    e, hg, two, i = gate_up.shape
    if hg != h or two != 2 or tuple(down.shape) != (e, i, h):
        raise ValueError(f"weight shapes {tuple(gate_up.shape)} / "
                         f"{tuple(down.shape)} do not fit xs {tuple(xs.shape)}")
    if block_size <= 0 or p % block_size:
        raise ValueError(f"P={p} is not a multiple of block_size "
                         f"{block_size}")
    if block_expert.shape != (p // block_size,):
        raise ValueError(f"block_expert must be [{p // block_size}], got "
                         f"{tuple(block_expert.shape)}")
    if block_i <= 0 or i % block_i:
        raise ValueError(f"I={i} is not a multiple of block_i {block_i}")


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _block_tiles(xs, gate_up, down, block_expert, block_size, block_i):
    """Yield ``(rows, ib, partial)`` for every live block and I-tile: the
    fp32 product of the block's rows through the tile of its expert's
    weights, the arithmetic of one (b, ib) step of the Pallas grid."""
    e, i = gate_up.shape[0], gate_up.shape[-1]
    for b, eb in enumerate(block_expert.tolist()):
        if eb >= e:
            continue                  # sentinel: no weight, exact zeros
        rows = slice(b * block_size, (b + 1) * block_size)
        x = xs[rows].float()
        for ib in range(i // block_i):
            cols = slice(ib * block_i, (ib + 1) * block_i)
            gu = gate_up[eb, :, :, cols].float()
            a = _silu(x @ gu[:, 0]) * (x @ gu[:, 1])
            yield rows, ib, a @ down[eb, cols].float()


def grouped_glu_plain(xs: torch.Tensor, gate_up: torch.Tensor,
                      down: torch.Tensor, block_expert: torch.Tensor,
                      block_size: int, block_i: int) -> torch.Tensor:
    """Plain PyTorch K5 (the JAX ``_ref_fwd``): each I-tile's fp32 partial
    is rounded to ``xs.dtype`` and added; sentinel blocks are zeros."""
    _check(xs, gate_up, down, block_expert, block_size, block_i)
    ys = torch.zeros_like(xs)
    for rows, _, part in _block_tiles(xs, gate_up, down, block_expert,
                                      block_size, block_i):
        ys[rows] = ys[rows] + part.to(xs.dtype)
    return ys


def grouped_glu_decode_plain(xs: torch.Tensor, gate_up: torch.Tensor,
                             down: torch.Tensor, block_expert: torch.Tensor,
                             block_size: int, block_i: int) -> torch.Tensor:
    """Plain PyTorch K6 (the JAX ``_ref_decode_fwd``): fp32 partials
    ``[num_ib, P, H]``, summed over the tiles and cast once."""
    _check(xs, gate_up, down, block_expert, block_size, block_i)
    num_ib = gate_up.shape[-1] // block_i
    parts = torch.zeros((num_ib,) + tuple(xs.shape), dtype=torch.float32,
                        device=xs.device)
    for rows, ib, part in _block_tiles(xs, gate_up, down, block_expert,
                                       block_size, block_i):
        parts[ib, rows] = part
    return parts.sum(0).to(xs.dtype)


def _launch(name: str, counter, xs, gate_up, down, block_expert,
            block_size, block_i) -> torch.Tensor:
    from . import _build

    args = (xs, gate_up, down, block_expert)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise RuntimeError(f"{name} has no backward on CUDA: the backward "
                           "is K7/K8, not ported; call it under "
                           "torch.no_grad() or on frozen weights")
    _check(xs, gate_up, down, block_expert, block_size, block_i)
    for a in args:
        if not a.is_cuda or a.device != xs.device:
            raise ValueError(f"{name} needs every tensor on {xs.device}; got "
                             f"one on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if xs.dtype not in _CODES or gate_up.dtype != xs.dtype \
            or down.dtype != xs.dtype:
        raise ValueError(f"{name} takes fp32 or bf16 xs with weights of the "
                         f"same dtype; got {xs.dtype}, {gate_up.dtype}, "
                         f"{down.dtype}")
    if block_expert.dtype != torch.int32:
        raise ValueError(f"block_expert must be int32, got "
                         f"{block_expert.dtype}")
    p, h = xs.shape
    e, _, _, i = gate_up.shape
    ys = torch.empty_like(xs)
    if p == 0:
        return ys
    # a = silu(x Wg) (x Wu) of every live row, fp32, between the two passes
    act = torch.empty((p, i), dtype=torch.float32, device=xs.device)
    fn = getattr(_build.load("blockwise_moe"), f"nxd_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    rc = fn(_CODES[xs.dtype], xs.data_ptr(), gate_up.data_ptr(),
            down.data_ptr(), block_expert.data_ptr(), act.data_ptr(),
            ys.data_ptr(), p, h, i, e, block_size,
            torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    counter.launches += 1
    return ys


def grouped_glu_cuda(xs, gate_up, down, block_expert, block_size,
                     block_i) -> torch.Tensor:
    """Launch K5 on the current stream; adds one to
    ``grouped_glu.launches``. ``block_i`` is checked, not used: the kernel
    sums over all of I before it rounds."""
    return _launch("grouped_glu", grouped_glu, xs, gate_up, down,
                   block_expert, block_size, block_i)


def grouped_glu_decode_cuda(xs, gate_up, down, block_expert, block_size,
                            block_i) -> torch.Tensor:
    """Launch K6 on the current stream; adds one to
    ``grouped_glu_decode.launches``."""
    return _launch("grouped_glu_decode", grouped_glu_decode, xs, gate_up,
                   down, block_expert, block_size, block_i)


def grouped_glu(xs: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                block_expert: torch.Tensor, block_size: int,
                block_i: int) -> torch.Tensor:
    """Block-sparse grouped GLU ``ys[b] = silu(x_b@Wg_e)·(x_b@Wu_e)@Wd_e``,
    ``e = block_expert[b]``, sentinel blocks zero; ``[P, H]`` in
    ``xs.dtype``. CPU tensors run :func:`grouped_glu_plain`, CUDA tensors
    K5."""
    if xs.device.type == "cpu":
        return grouped_glu_plain(xs, gate_up, down, block_expert, block_size,
                                 block_i)
    if xs.is_cuda:
        return grouped_glu_cuda(xs, gate_up, down, block_expert, block_size,
                                block_i)
    raise ValueError(f"grouped_glu has no path for device {xs.device}")


def grouped_glu_decode(xs: torch.Tensor, gate_up: torch.Tensor,
                       down: torch.Tensor, block_expert: torch.Tensor,
                       block_size: int, block_i: int) -> torch.Tensor:
    """The grouped GLU for decode (pair it with ``sentinel_empty`` metadata,
    so only the experts the step's tokens hit are read). CPU tensors run
    :func:`grouped_glu_decode_plain`, CUDA tensors K6."""
    if xs.device.type == "cpu":
        return grouped_glu_decode_plain(xs, gate_up, down, block_expert,
                                        block_size, block_i)
    if xs.is_cuda:
        return grouped_glu_decode_cuda(xs, gate_up, down, block_expert,
                                       block_size, block_i)
    raise ValueError(f"grouped_glu_decode has no path for device "
                     f"{xs.device}")


#: kernel launches since each count was last set to 0
grouped_glu.launches = 0
grouped_glu_decode.launches = 0
