"""Collectives over a named axis's process group (counterpart of
``neuronx_distributed_tpu/parallel/comm.py``).

The reference expresses each collective over a named mesh axis inside
``shard_map``; the port runs it over the process group of that axis
(:mod:`.mesh`). Every wrapper is the identity where the axis holds one
rank, and returns a new tensor, leaving its input as it was (the
``*_`` forms reduce in place).

These are for code that is not differentiated through; the
differentiable pairs are :mod:`.mappings`.

Host staging. Several ranks may share one card (``chip_smoke.py`` runs
four ranks on one H100): NCCL refuses two ranks on one device, so those
ranks talk over gloo with CUDA tensors. Gloo in the card's torch (2.11)
runs ``all_reduce`` (sum, max, bf16, int64), ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single`` on CUDA tensors (its
CUDA work copies them through pinned host buffers itself), but its
``send``/``recv`` abort the process on a CUDA pointer
(``scripts/probe_gloo_cuda.py``). So :func:`ppermute`, the one op staged
there, sends a host copy of its input and receives into a host buffer
that it copies back to the card, on purpose and counted:
:data:`host_staged_bytes` adds the bytes it moved to the host and back.
Compute stays on the card. :data:`collective_bytes` counts every op's
payload (its input and output bytes), staged or not.

Gloo has no float8 types: :func:`all_gather`, :func:`all_to_all` and
:func:`ppermute` move a float8 tensor as its bytes (``uint8``) and view
the result back, so the quantized expert-parallel wire
(:mod:`.ep_dispatch`) crosses as the codes themselves.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import mesh as ps

#: bytes (device to host plus host to device) each op staged through the
#: host has moved since it was last cleared
host_staged_bytes: Dict[str, int] = collections.Counter()

#: payload bytes (inputs and outputs) of each op run across ranks since it
#: was last cleared
collective_bytes: Dict[str, int] = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def axis_size(axis: ps.Axis) -> int:
    """Ranks along ``axis``; 1 where the parallel state is not
    initialised."""
    return ps.axis_size(axis) if ps.model_parallel_is_initialized() else 1


def combined_axis_index(axis: ps.Axis) -> int:
    """This rank's index along ``axis`` (the flat index, major to minor,
    over a tuple); 0 where the parallel state is not initialised (JAX
    ``comm.combined_axis_index``)."""
    return ps.axis_rank(axis) if ps.model_parallel_is_initialized() else 0


_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``, or its bytes for a float8 tensor, which gloo cannot move."""
    return x.view(torch.uint8) if x.dtype in _FLOAT8 else x


def _count(op: str, *tensors: torch.Tensor) -> None:
    """Add the payload of ``op`` to :data:`collective_bytes`."""
    collective_bytes[op] += sum(t.numel() * t.element_size() for t in tensors)


def all_reduce_(x: torch.Tensor, axis: ps.Axis = ps.TP_AXIS,
                op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over ``axis`` in place (``x`` must be contiguous)."""
    if axis_size(axis) == 1:
        return x
    _count("all_reduce", x)
    dist.all_reduce(x, op=_OPS[op], group=ps.axis_group(axis))
    return x


def all_reduce(x: torch.Tensor, axis: ps.Axis = ps.TP_AXIS,
               op: str = "sum") -> torch.Tensor:
    """``op`` (``sum``, ``max``, ``min``) of ``x`` over ``axis``."""
    if axis_size(axis) == 1:
        return x
    return all_reduce_(x.contiguous().clone(), axis, op)


def all_gather(x: torch.Tensor, axis: ps.Axis = ps.TP_AXIS,
               dim: int = -1, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (the
    reference's tiled ``all_gather``); written into ``out`` when given
    (no second whole-size copy along a ``dim`` other than 0)."""
    n = axis_size(axis)
    if n == 1:
        return x if out is None else out.copy_(x)
    dim = dim % x.dim()
    xt = _as_bytes(x.movedim(dim, 0).contiguous())
    got = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _count("all_gather", got, xt)
    dist.all_gather_into_tensor(got, xt, group=ps.axis_group(axis))
    got = got.view(x.dtype).movedim(0, dim)
    return got.contiguous() if out is None else out.copy_(got)


def reduce_scatter(x: torch.Tensor, axis: ps.Axis = ps.TP_AXIS,
                   dim: int = -1) -> torch.Tensor:
    """The sum over ``axis``, this rank's ``1/n`` chunk of it along ``dim``
    (the reference's tiled ``psum_scatter``)."""
    n = axis_size(axis)
    if n == 1:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} size {x.shape[dim]} not divisible by "
                         f"axis {axis!r} size {n}")
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _count("reduce_scatter", out, xt)
    dist.reduce_scatter_tensor(out, xt, group=ps.axis_group(axis))
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, axis: ps.Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` into ``n`` chunks along ``split_dim``, send chunk ``j``
    to rank ``j``, and concatenate what arrives along ``concat_dim`` in
    rank order (the reference's tiled ``all_to_all``)."""
    n = axis_size(axis)
    if n == 1:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} size {x.shape[split_dim]} not "
                         f"divisible by axis {axis!r} size {n}")
    inp = _as_bytes(torch.stack(x.chunk(n, split_dim)).contiguous())
    out = torch.empty_like(inp)
    _count("all_to_all", out, inp)
    dist.all_to_all_single(out, inp, group=ps.axis_group(axis))
    return torch.cat(out.view(x.dtype).unbind(0), dim=concat_dim)


def ppermute(x: torch.Tensor, axis: ps.Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` to each ``dst`` of a pair ``(this rank, dst)`` and return
    what the pair ``(src, this rank)`` sends, as send/recv pairs; zeros
    where no pair sends here (the reference's ``ppermute``)."""
    if axis_size(axis) == 1:
        return x
    if x.dtype in _FLOAT8:
        return ppermute(_as_bytes(x.contiguous()), axis, perm).view(x.dtype)
    me = ps.axis_rank(axis)
    members = ps.axis_members(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    sends = [dst for src, dst in perm if src == me]
    recvs = [src for src, dst in perm if dst == me]
    if len(recvs) > 1:
        raise ValueError(f"ppermute: rank {me} receives from {recvs}")

    group = ps.axis_group(axis)
    # gloo's send/recv abort on a CUDA pointer: stage through host memory
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.cpu() if staged and sends else x
    recv = torch.zeros_like(x, device="cpu") if staged else out
    _count("ppermute", out, x)
    ops = [dist.P2POp(dist.isend, send, members[d]) for d in sends]
    ops += [dist.P2POp(dist.irecv, recv, members[s]) for s in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        out.copy_(recv)
        host_staged_bytes["ppermute"] += ((bool(sends) + bool(recvs))
                                          * x.numel() * x.element_size())
    return out


def split_along_dim(x: torch.Tensor, axis: ps.Axis = ps.TP_AXIS,
                    dim: int = -1) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (the reference's
    ``split_tensor_along_last_dim`` and own-rank select): no
    communication."""
    n = axis_size(axis)
    if n == 1:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} size {x.shape[dim]} not divisible by "
                         f"axis {axis!r} size {n}")
    chunk = x.shape[dim] // n
    return x.narrow(dim, ps.axis_rank(axis) * chunk, chunk).contiguous()
