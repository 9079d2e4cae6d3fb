"""Grouped GLU of the dropless MoE and its backward (counterpart of
``neuronx_distributed_tpu/ops/blockwise_moe.py``).

Tokens arrive sorted by expert in fixed-size blocks (``xs [P, H]``, the
layout of :func:`..modules.moe.blockwise.scatter_to_blocks`), and block
``b`` runs ``silu(x_b·Wg_e)·(x_b·Wu_e)·Wd_e`` with ``e = block_expert[b]``.
Weights are the stacked expert banks ``gate_up [E, H, 2, I]`` (gate at
index 0, up at 1) and ``down [E, I, H]``. A block whose ``block_expert[b] >=
E`` is a *sentinel*: its rows are exact zeros and no weight is read for it.

Four kernels, each with a plain PyTorch version behind one signature:

* K5, the packed-step forward. The plain version :func:`grouped_glu_plain`
  mirrors the JAX reference ``_ref_fwd``: per ``block_i`` tile of the
  intermediate dim an fp32 partial, rounded to the output dtype and added.
  The kernel replaces the Pallas ``_glu_fwd_kernel``.
* K6, :func:`grouped_glu_decode`: the same function for decode, where what
  matters is the weight traffic: sentinel blocks read no weight byte, and on
  ``sentinel_empty`` metadata of a narrow step each hit expert holds one
  block, so its weights are read once. The plain version mirrors
  ``_ref_decode_fwd``: fp32 partials ``[num_ib, P, H]``, summed, cast once.
  The kernel replaces ``_glu_fwd_decode_kernel``. Forward only, as in the
  JAX package.
* K7, :func:`grouped_glu_dx`: ``dx`` of the backward. The plain version
  mirrors ``_ref_dx``: per ``block_i`` tile an fp32 partial, rounded to
  ``xs.dtype`` and added. Replaces ``_glu_dx_kernel``.
* K8, :func:`grouped_glu_dw`: ``(dgate_up, ddown)``. The plain version
  mirrors ``_ref_dw``: fp32 accumulators updated block by block in
  ascending order, sentinel blocks skipped, each cast once to the weights'
  dtype. Replaces ``_glu_dw_kernel``.

:func:`grouped_glu_bwd` gives all three gradients; on the card it launches
K7's and K8's passes behind one shared first pass. :func:`grouped_glu` is
differentiable through :class:`GroupedGLUFunction` (the JAX ``custom_vjp``
pair) on both devices: forward K5, backward K7 and K8, or their plain
versions on the CPU.

The kernels (``csrc/blockwise_moe.cu``, bound with :mod:`ctypes`) sum over
the whole intermediate dim in fp32 and round once, so in bf16 K5's and K7's
outputs are closer to the fp32 result than their plain versions, which
round once per tile. dW is summed in fp32 and rounded once in both. In bf16
every kernel runs on the tensor cores and takes H and I multiples of 8: the
forward rounds ``a = silu(g) u`` once to bf16 between its two passes, the
backward's dx rounds the intermediates dg and du once to bf16 before the
second product (the plain versions keep all three in fp32), and its dW
takes dg, du and a as a bf16 value plus the bf16 remainder of that
rounding. fp32 runs on the CUDA cores.

Each dispatcher chooses by the device of ``xs``: CPU tensors take the plain
version, CUDA tensors the kernel, which launches or raises; nothing falls
back. Every kernel wrapper adds one to its dispatcher's ``launches`` per
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
# nxd_grouped_glu_dx / _dw / _bwd(dtype, xs, gate_up, down, block_expert,
#   dy, a, dg, du, dx, dgu, ddn, P, H, I, E, block_size, stream)
BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _check(xs, gate_up, down, block_expert, block_size, block_i, dy=None):
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
    if dy is not None and dy.shape != xs.shape:
        raise ValueError(f"dy must be shaped like xs {tuple(xs.shape)}, got "
                         f"{tuple(dy.shape)}")


def _acc_dtype(xs: torch.Tensor) -> torch.dtype:
    """fp32 accumulation, float64 for float64 inputs (``gradcheck``)."""
    return torch.float64 if xs.dtype == torch.float64 else torch.float32


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _block_tiles(xs, gate_up, down, block_expert, block_size, block_i):
    """Yield ``(rows, ib, partial)`` for every live block and I-tile: the
    fp32 product of the block's rows through the tile of its expert's
    weights, the arithmetic of one (b, ib) step of the Pallas grid."""
    e, i = gate_up.shape[0], gate_up.shape[-1]
    acc = _acc_dtype(xs)
    for b, eb in enumerate(block_expert.tolist()):
        if eb >= e:
            continue                  # sentinel: no weight, exact zeros
        rows = slice(b * block_size, (b + 1) * block_size)
        x = xs[rows].to(acc)
        for ib in range(i // block_i):
            cols = slice(ib * block_i, (ib + 1) * block_i)
            gu = gate_up[eb, :, :, cols].to(acc)
            a = _silu(x @ gu[:, 0]) * (x @ gu[:, 1])
            yield rows, ib, a @ down[eb, cols].to(acc)


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
    parts = torch.zeros((num_ib,) + tuple(xs.shape), dtype=_acc_dtype(xs),
                        device=xs.device)
    for rows, ib, part in _block_tiles(xs, gate_up, down, block_expert,
                                       block_size, block_i):
        parts[ib, rows] = part
    return parts.sum(0).to(xs.dtype)


def _bwd_plain(xs, gate_up, down, block_expert, dy, block_size, block_i,
               want_dx: bool, want_dw: bool):
    """The backward's arithmetic per (b, ib) step of the Pallas grids: for
    each live block and I-tile, ``g``, ``u``, ``da = dy Wd^T``, ``dg = da u
    silu'(g)`` and ``du = da silu(g)`` in fp32; then dx's partial ``dg Wg^T
    + du Wu^T`` rounded to ``xs.dtype`` and added (``_ref_dx``), and the dW
    partials ``a^T dy``, ``x^T dg``, ``x^T du`` added to fp32 accumulators
    in ascending block order (``_ref_dw``). Sentinel blocks add nothing."""
    _check(xs, gate_up, down, block_expert, block_size, block_i, dy)
    e, i = gate_up.shape[0], gate_up.shape[-1]
    acc = _acc_dtype(xs)
    dx = torch.zeros_like(xs) if want_dx else None
    dgu = ddn = None
    if want_dw:
        dgu = torch.zeros(gate_up.shape, dtype=acc, device=xs.device)
        ddn = torch.zeros(down.shape, dtype=acc, device=xs.device)
    for b, eb in enumerate(block_expert.tolist()):
        if eb >= e:
            continue
        rows = slice(b * block_size, (b + 1) * block_size)
        x, g_out = xs[rows].to(acc), dy[rows].to(acc)
        for ib in range(i // block_i):
            cols = slice(ib * block_i, (ib + 1) * block_i)
            gu = gate_up[eb, :, :, cols].to(acc)
            g, u = x @ gu[:, 0], x @ gu[:, 1]
            da = g_out @ down[eb, cols].to(acc).T
            s = torch.sigmoid(g)
            sg = g * s
            dg = da * u * (s * (1 + g * (1 - s)))
            du = da * sg
            if want_dx:
                part = dg @ gu[:, 0].T + du @ gu[:, 1].T
                dx[rows] = dx[rows] + part.to(xs.dtype)
            if want_dw:
                ddn[eb, cols] += (sg * u).T @ g_out
                dgu[eb, :, 0, cols] += x.T @ dg
                dgu[eb, :, 1, cols] += x.T @ du
    if want_dw:
        dgu, ddn = dgu.to(gate_up.dtype), ddn.to(down.dtype)
    return dx, dgu, ddn


def grouped_glu_dx_plain(xs, gate_up, down, block_expert, dy, block_size,
                         block_i) -> torch.Tensor:
    """Plain PyTorch K7 (the JAX ``_ref_dx``): ``dx [P, H]`` in
    ``xs.dtype``, each I-tile's fp32 partial rounded and added; sentinel
    blocks give zeros."""
    return _bwd_plain(xs, gate_up, down, block_expert, dy, block_size,
                      block_i, True, False)[0]


def grouped_glu_dw_plain(xs, gate_up, down, block_expert, dy, block_size,
                         block_i):
    """Plain PyTorch K8 (the JAX ``_ref_dw``): ``(dgate_up, ddown)`` summed
    in fp32 block by block in ascending order, sentinel blocks skipped, each
    cast once to its weight's dtype. An expert that owns no block gets
    exact zeros."""
    return _bwd_plain(xs, gate_up, down, block_expert, dy, block_size,
                      block_i, False, True)[1:]


def grouped_glu_bwd_plain(xs, gate_up, down, block_expert, dy, block_size,
                          block_i):
    """Plain K7 and K8 from one pass over the blocks: ``(dx, dgate_up,
    ddown)``."""
    return _bwd_plain(xs, gate_up, down, block_expert, dy, block_size,
                      block_i, True, True)


def _check_kernel_args(name, xs, gate_up, down, block_expert, block_size,
                       block_i, dy=None):
    """Raise on anything the kernels do not take."""
    _check(xs, gate_up, down, block_expert, block_size, block_i, dy)
    args = (xs, gate_up, down, block_expert) + (() if dy is None else (dy,))
    for a in args:
        if not a.is_cuda or a.device != xs.device:
            raise ValueError(f"{name} needs every tensor on {xs.device}; got "
                             f"one on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if xs.dtype not in _CODES or any(a.dtype != xs.dtype
                                     for a in (gate_up, down, *args[4:])):
        raise ValueError(f"{name} takes fp32 or bf16 xs with weights (and "
                         f"dy) of the same dtype; got {xs.dtype}, "
                         f"{gate_up.dtype}, {down.dtype}")
    if block_expert.dtype != torch.int32:
        raise ValueError(f"block_expert must be int32, got "
                         f"{block_expert.dtype}")


def _check_bf16_widths(name, xs, h, i):
    """The bf16 kernels copy 16-byte chunks (cp.async): rows of H and I
    must be multiples of 8 elements. fp32 takes any width."""
    if xs.dtype == torch.bfloat16 and (h % 8 or i % 8):
        raise ValueError(f"{name} in bf16 needs H and I multiples of 8 "
                         f"(16-byte rows for cp.async); got H={h}, I={i}")


def _lib_fn(entry: str, argtypes):
    from . import _build

    fn = getattr(_build.load("blockwise_moe"), f"nxd_{entry}")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _launch(name: str, counter, xs, gate_up, down, block_expert,
            block_size, block_i) -> torch.Tensor:
    _check_kernel_args(name, xs, gate_up, down, block_expert, block_size,
                       block_i)
    p, h = xs.shape
    e, _, _, i = gate_up.shape
    _check_bf16_widths(name, xs, h, i)
    ys = torch.empty_like(xs)
    if p == 0:
        return ys
    # a = silu(x Wg) (x Wu) of every live row between the two passes: bf16
    # for bf16 inputs (the tensor cores' A operand), fp32 for fp32 ones
    act = torch.empty((p, i), dtype=xs.dtype, device=xs.device)
    fn = _lib_fn(name, ARGTYPES)
    _raise_on(fn(_CODES[xs.dtype], xs.data_ptr(), gate_up.data_ptr(),
                 down.data_ptr(), block_expert.data_ptr(), act.data_ptr(),
                 ys.data_ptr(), p, h, i, e, block_size,
                 torch.cuda.current_stream(xs.device).cuda_stream), name)
    counter.launches += 1
    return ys


def grouped_glu_cuda(xs, gate_up, down, block_expert, block_size,
                     block_i) -> torch.Tensor:
    """Launch K5 on the current stream; adds one to
    ``grouped_glu.launches``. ``block_i`` is checked, not used: the kernel
    sums over all of I before it rounds. Not differentiable itself:
    :func:`grouped_glu` is."""
    return _launch("grouped_glu", grouped_glu, xs, gate_up, down,
                   block_expert, block_size, block_i)


def grouped_glu_decode_cuda(xs, gate_up, down, block_expert, block_size,
                            block_i) -> torch.Tensor:
    """Launch K6 on the current stream; adds one to
    ``grouped_glu_decode.launches``. Refuses inputs that require grad with
    grad mode on: K6 is forward-only."""
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (xs, gate_up, down)):
        raise RuntimeError("grouped_glu_decode has no backward: the JAX "
                           "package defines none for its decode kernel "
                           "either (train through grouped_glu); call it "
                           "under torch.no_grad() or on frozen weights")
    return _launch("grouped_glu_decode", grouped_glu_decode, xs, gate_up,
                   down, block_expert, block_size, block_i)


def _launch_bwd(entry: str, xs, gate_up, down, block_expert, dy, block_size,
                block_i, want_dx: bool, want_dw: bool):
    """Launch one backward entry of ``csrc/blockwise_moe.cu``: pass 1 into
    scratches (bf16 for bf16 inputs, on the tensor cores; fp32 for fp32
    ones, on the CUDA cores), then K7's dx pass and/or K8's dW pass.
    Returns ``(dx, dgate_up, ddown)``, None for what the entry does not
    compute."""
    _check_kernel_args(entry, xs, gate_up, down, block_expert, block_size,
                       block_i, dy)
    p, h = xs.shape
    e, _, _, i = gate_up.shape
    _check_bf16_widths(entry, xs, h, i)
    dx = torch.empty_like(xs) if want_dx else None
    dgu = torch.empty_like(gate_up) if want_dw else None
    ddn = torch.empty_like(down) if want_dw else None
    # fp32: [P, I] each; bf16: [P, I], or where the dW pass follows [2, P,
    # I], the bf16 value and the bf16 remainder of its rounding
    if xs.dtype == torch.bfloat16:
        scratch = dict(size=(2, p, i) if want_dw else (p, i),
                       dtype=torch.bfloat16, device=xs.device)
    else:
        scratch = dict(size=(p, i), dtype=torch.float32, device=xs.device)
    dg, du = torch.empty(**scratch), torch.empty(**scratch)
    a = torch.empty(**scratch) if want_dw else None
    ptrs = [None if t is None else t.data_ptr()
            for t in (xs, gate_up, down, block_expert, dy, a, dg, du, dx, dgu,
                      ddn)]
    fn = _lib_fn(entry, BWD_ARGTYPES)
    _raise_on(fn(_CODES[xs.dtype], *ptrs, p, h, i, e, block_size,
                 torch.cuda.current_stream(xs.device).cuda_stream), entry)
    return dx, dgu, ddn


def grouped_glu_dx_cuda(xs, gate_up, down, block_expert, dy, block_size,
                        block_i) -> torch.Tensor:
    """Launch K7 (pass 1, then the dx pass) on the current stream; adds one
    to ``grouped_glu_dx.launches``. ``block_i`` is checked, not used."""
    dx = _launch_bwd("grouped_glu_dx", xs, gate_up, down, block_expert, dy,
                     block_size, block_i, True, False)[0]
    grouped_glu_dx.launches += 1
    return dx


def grouped_glu_dw_cuda(xs, gate_up, down, block_expert, dy, block_size,
                        block_i):
    """Launch K8 (pass 1, then the dW pass) on the current stream; adds one
    to ``grouped_glu_dw.launches``."""
    out = _launch_bwd("grouped_glu_dw", xs, gate_up, down, block_expert, dy,
                      block_size, block_i, False, True)[1:]
    grouped_glu_dw.launches += 1
    return out


def grouped_glu_bwd_cuda(xs, gate_up, down, block_expert, dy, block_size,
                         block_i):
    """Launch K7's and K8's passes behind one shared pass 1: ``(dx,
    dgate_up, ddown)``. Adds one to ``grouped_glu_bwd.launches`` and, as it
    launches both kernels, one to each of ``grouped_glu_dx.launches`` and
    ``grouped_glu_dw.launches``."""
    out = _launch_bwd("grouped_glu_bwd", xs, gate_up, down, block_expert, dy,
                      block_size, block_i, True, True)
    grouped_glu_bwd.launches += 1
    grouped_glu_dx.launches += 1
    grouped_glu_dw.launches += 1
    return out


def _dispatch(name, plain, cuda, xs, *args):
    if xs.device.type == "cpu":
        return plain(xs, *args)
    if xs.is_cuda:
        return cuda(xs, *args)
    raise ValueError(f"{name} has no path for device {xs.device}")


class GroupedGLUFunction(torch.autograd.Function):
    """The grouped GLU with its backward (the JAX ``custom_vjp`` pair of
    ``_grouped_glu_kernel``): the forward is K5, the backward K7 and K8
    (both through one launch where both are needed), or their plain
    versions on the CPU. Saves ``xs``, ``gate_up``, ``down`` and
    ``block_expert``; g, u and a are recomputed in the backward."""

    @staticmethod
    def forward(ctx, xs, gate_up, down, block_expert, block_size, block_i):
        ys = _dispatch("grouped_glu", grouped_glu_plain, grouped_glu_cuda, xs,
                       gate_up, down, block_expert, block_size, block_i)
        ctx.save_for_backward(xs, gate_up, down, block_expert)
        ctx.block_size, ctx.block_i = block_size, block_i
        return ys

    @staticmethod
    def backward(ctx, dy):
        xs, gate_up, down, block_expert = ctx.saved_tensors
        args = (xs, gate_up, down, block_expert, dy.contiguous(),
                ctx.block_size, ctx.block_i)
        want_dx = ctx.needs_input_grad[0]
        want_dw = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx = dgu = ddn = None
        if want_dx and want_dw:
            dx, dgu, ddn = grouped_glu_bwd(*args)
        elif want_dx:
            dx = grouped_glu_dx(*args)
        elif want_dw:
            dgu, ddn = grouped_glu_dw(*args)
        return dx, dgu, ddn, None, None, None


def grouped_glu(xs: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                block_expert: torch.Tensor, block_size: int,
                block_i: int) -> torch.Tensor:
    """Block-sparse grouped GLU ``ys[b] = silu(x_b@Wg_e)·(x_b@Wu_e)@Wd_e``,
    ``e = block_expert[b]``, sentinel blocks zero; ``[P, H]`` in
    ``xs.dtype``. Differentiable (:class:`GroupedGLUFunction`): CPU tensors
    run :func:`grouped_glu_plain` and the plain backward, CUDA tensors K5,
    K7 and K8."""
    return GroupedGLUFunction.apply(xs, gate_up, down, block_expert,
                                    block_size, block_i)


def grouped_glu_decode(xs: torch.Tensor, gate_up: torch.Tensor,
                       down: torch.Tensor, block_expert: torch.Tensor,
                       block_size: int, block_i: int) -> torch.Tensor:
    """The grouped GLU for decode (pair it with ``sentinel_empty`` metadata,
    so only the experts the step's tokens hit are read). CPU tensors run
    :func:`grouped_glu_decode_plain`, CUDA tensors K6, forward only."""
    return _dispatch("grouped_glu_decode", grouped_glu_decode_plain,
                     grouped_glu_decode_cuda, xs, gate_up, down, block_expert,
                     block_size, block_i)


def grouped_glu_dx(xs, gate_up, down, block_expert, dy, block_size,
                   block_i) -> torch.Tensor:
    """dx of the grouped GLU for the cotangent ``dy [P, H]``. CPU tensors
    run :func:`grouped_glu_dx_plain`, CUDA tensors K7."""
    return _dispatch("grouped_glu_dx", grouped_glu_dx_plain,
                     grouped_glu_dx_cuda, xs, gate_up, down, block_expert, dy,
                     block_size, block_i)


def grouped_glu_dw(xs, gate_up, down, block_expert, dy, block_size, block_i):
    """``(dgate_up, ddown)`` of the grouped GLU for ``dy``. CPU tensors run
    :func:`grouped_glu_dw_plain`, CUDA tensors K8."""
    return _dispatch("grouped_glu_dw", grouped_glu_dw_plain,
                     grouped_glu_dw_cuda, xs, gate_up, down, block_expert, dy,
                     block_size, block_i)


def grouped_glu_bwd(xs, gate_up, down, block_expert, dy, block_size,
                    block_i):
    """``(dx, dgate_up, ddown)``. CPU tensors run
    :func:`grouped_glu_bwd_plain`, CUDA tensors K7 and K8 behind one
    shared first pass."""
    return _dispatch("grouped_glu_bwd", grouped_glu_bwd_plain,
                     grouped_glu_bwd_cuda, xs, gate_up, down, block_expert,
                     dy, block_size, block_i)


#: kernel launches since each count was last set to 0
grouped_glu.launches = 0
grouped_glu_decode.launches = 0
grouped_glu_dx.launches = 0
grouped_glu_dw.launches = 0
grouped_glu_bwd.launches = 0
