"""Expert-parallel token dispatch: the ring and quantized forms of the EP
collectives (counterpart of ``neuronx_distributed_tpu/parallel/
ep_dispatch.py``).

The dropless expert-parallel path (``ExpertMLPs._forward_blockwise_ep``)
gathers every token shard over ``ep`` and reduce-scatters the per-rank
partial expert outputs back. This module gives that pair two treatments:

* **rings**: the gather and the combine run as :func:`.comm.ppermute`
  hops, each arriving token chunk its own tensor, so the expert compute of
  chunk ``t`` needs only ``t`` hops (the reference overlaps it with the
  later hops through XLA's scheduler; here the hops run in order, eagerly);
* **a quantized wire**: the payloads ride :mod:`.wire_codec` (int8 or fp8
  values and per-block fp32 scales), ~3.9x fewer bytes at int8's default
  256-element blocks.

The contracts are the reference's:

* fp32 wire: the ring moves the payload as it is, so its chunks are the
  monolithic ``all_gather``'s bit for bit; the combine puts each
  contribution in a buffer indexed by its source rank and sums it with
  :func:`_ordered_sum` in ascending rank order, the order of the
  reference's ``psum_scatter``, so ring and monolithic agree bit for bit;
* quantized wire: every chunk crosses the codec once in either form
  (``DQ(Q(chunk))``) and both sum through the same buffer, so ring ==
  monolithic bit for bit, forward and backward.

:func:`gather_token_chunks` and :func:`combine_token_chunks` are
``torch.autograd.Function`` pairs that are each other's backward, over the
same wire: a quantized dispatch quantizes its backward too. Where the axis
holds one rank (or no layout is initialised) both are the identity.

Every op here goes through :mod:`.comm`, so the collective and host-staged
byte counters see it; on gloo with CUDA tensors the ring's ``ppermute``
hops are staged through the host and counted there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import comm
from . import mesh as ps
from .wire_codec import (CompressionConfig, decode_payload, encode_payload,
                         payload_wire_bytes)

__all__ = ["wire_config", "overlap_engaged", "gather_token_chunks",
           "combine_token_chunks", "MIN_AUTO_AXIS_SIZE"]

#: auto mode (``overlap=None``) takes the ring only at axis sizes with
#: enough hops to pipeline (the reference's threshold for its TP rings)
MIN_AUTO_AXIS_SIZE = 4

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def wire_config(dtype: Optional[str],
                block_size: int = 256) -> Optional[CompressionConfig]:
    """The EP wire: None (no compression) for ``None`` or ``"fp32"``, else
    a :class:`.wire_codec.CompressionConfig` of ``dtype``."""
    if not dtype or dtype == "fp32":
        return None
    return CompressionConfig(dtype=dtype, block_size=int(block_size),
                             hierarchical=False, error_feedback=False)


def _norm_wire(wire: Optional[CompressionConfig]
               ) -> Optional[CompressionConfig]:
    return wire if (wire is not None and wire.quantized) else None


def overlap_engaged(overlap: Optional[bool], axis: ps.Axis) -> bool:
    """Whether a layer takes the ring: ``None`` (auto) where the axis holds
    at least :data:`MIN_AUTO_AXIS_SIZE` ranks; ``True`` wherever it holds
    more than one; ``False`` never."""
    if overlap is False:
        return False
    n = comm.axis_size(axis)
    if n <= 1:
        return False
    if overlap is None:
        return n >= MIN_AUTO_AXIS_SIZE
    return True


# ---------------------------------------------------------------------------
# the ring's plumbing
# ---------------------------------------------------------------------------

def _shift_perm(n: int, shift: int) -> List[Tuple[int, int]]:
    """``ppermute`` pairs moving every shard ``shift`` ranks forward."""
    return [(i, (i + shift) % n) for i in range(n)]


def _ship(pair: Pair, axis: ps.Axis, perm) -> Pair:
    """One ring hop of a ``(q, scales)`` pair; the scales are None on the
    fp32 wire, which then moves the payload alone."""
    q, s = pair
    q = comm.ppermute(q, axis, perm)
    if s is not None:
        s = comm.ppermute(s, axis, perm)
    return q, s


def _open(pair: Pair, wire, dtype: torch.dtype) -> torch.Tensor:
    q, s = pair
    return decode_payload(q, s, wire, dtype)


def _ordered_sum(buf: torch.Tensor, n: int) -> torch.Tensor:
    """``buf[0] + buf[1] + ... + buf[n-1]``, left to right, in ascending
    source-rank order: the dequantizing multiply stays out of the adds,
    so the sum has the same bits whichever form filled ``buf``."""
    acc = buf[0]
    for r in range(1, n):
        acc = acc + buf[r]
    return acc


# ---------------------------------------------------------------------------
# gather: the token shards as per-source chunks, in hop order
# ---------------------------------------------------------------------------

def _gather_impl(x: torch.Tensor, axis: ps.Axis, wire, decomposed: bool
                 ) -> List[torch.Tensor]:
    """``x`` gathered over ``axis`` as a list of per-source chunks in hop
    order: element ``t`` is rank ``(me + t) % n``'s shard (element 0 this
    rank's own, through the codec like every other)."""
    n = comm.axis_size(axis)
    if n <= 1:
        return [x]
    if decomposed:
        pair = encode_payload(x, wire)
        chunks = [_open(pair, wire, x.dtype)]
        perm = _shift_perm(n, -1)
        for _ in range(1, n):
            pair = _ship(pair, axis, perm)
            chunks.append(_open(pair, wire, x.dtype))
        return [c.clone() if c is x else c for c in chunks]
    # monolithic: encode once, all-gather the pair, decode per chunk: each
    # chunk is DQ(Q(shard)) exactly as the ring delivers it
    me = comm.combined_axis_index(axis)
    q, s = encode_payload(x, wire)
    qg = comm.all_gather(q, axis, dim=0).reshape((n,) + tuple(q.shape))
    sg = (comm.all_gather(s, axis, dim=0).reshape((n,) + tuple(s.shape))
          if s is not None else None)
    chunks = []
    for t in range(n):
        src = (me + t) % n
        chunks.append(decode_payload(qg[src], None if sg is None
                                     else sg[src], wire, x.dtype).clone())
    return chunks


# ---------------------------------------------------------------------------
# combine: per-destination partials back to this rank's shard, summed
# ---------------------------------------------------------------------------

def _combine_impl(ys: Sequence[torch.Tensor], axis: ps.Axis, wire,
                  decomposed: bool) -> torch.Tensor:
    """The per-destination partials ``ys`` (hop order: ``ys[t]`` is this
    rank's part of rank ``(me + t) % n``'s tokens) reduce-scattered back
    to this rank's shard, summed over source ranks in ascending order."""
    n = comm.axis_size(axis)
    if n <= 1:
        return ys[0]
    me = comm.combined_axis_index(axis)
    y0 = ys[0]
    buf = y0.new_zeros((n,) + tuple(y0.shape))
    if decomposed:
        for t in range(n):
            pair = encode_payload(ys[t].contiguous(), wire)
            if t:
                # one hop lands it: rank me receives, from rank me - t,
                # that rank's chunk meant for me
                pair = _ship(pair, axis, _shift_perm(n, t))
            buf[(me - t) % n] = _open(pair, wire, y0.dtype)
        return _ordered_sum(buf, n)
    # monolithic: the chunks in destination order, one all-to-all of the
    # encoded pair, the decoded contributions by source rank, the same sum
    stacked = torch.stack(list(ys))                   # [n, ...] hop order
    dest_order = torch.roll(stacked, shifts=me, dims=0)
    q, s = encode_payload(dest_order, wire)
    qr = comm.all_to_all(q, axis, split_dim=0, concat_dim=0)
    sr = (comm.all_to_all(s, axis, split_dim=0, concat_dim=0)
          if s is not None else None)
    buf.copy_(decode_payload(qr, sr, wire, y0.dtype))
    return _ordered_sum(buf, n)


class _GatherChunks(torch.autograd.Function):
    """Forward the gather; backward the combine of the chunks' gradients
    (chunk ``t`` came from rank ``me + t``: its gradient goes back there
    and sums over every receiver), over the same wire."""

    @staticmethod
    def forward(ctx, x, axis, wire, decomposed):
        ctx.axis, ctx.wire, ctx.decomposed = axis, wire, decomposed
        return tuple(_gather_impl(x, axis, wire, decomposed))

    @staticmethod
    def backward(ctx, *dchunks):
        ref = next(d for d in dchunks if d is not None)
        grads = [torch.zeros_like(ref) if d is None else d for d in dchunks]
        return (_combine_impl(grads, ctx.axis, ctx.wire, ctx.decomposed),
                None, None, None)


class _CombineChunks(torch.autograd.Function):
    """Forward the combine; backward the gather of the output's gradient
    (``ys[t]`` fed rank ``me + t``'s tokens: its gradient is that rank's
    ``dy``), over the same wire."""

    @staticmethod
    def forward(ctx, axis, wire, decomposed, *ys):
        ctx.axis, ctx.wire, ctx.decomposed = axis, wire, decomposed
        return _combine_impl(ys, axis, wire, decomposed)

    @staticmethod
    def backward(ctx, dy):
        return (None, None, None) + tuple(
            _gather_impl(dy.contiguous(), ctx.axis, ctx.wire,
                         ctx.decomposed))


# ---------------------------------------------------------------------------
# the public pair, and its wire-byte accounting (once a call)
# ---------------------------------------------------------------------------

def _record_ep_wire(kind: str, shape: Tuple[int, ...],
                    wire: Optional[CompressionConfig],
                    passes: float) -> None:
    from ..obs.accounting import record_wire_bytes
    from ..obs.metrics import get_registry

    if not get_registry().enabled:
        return
    m = 1
    for d in shape:
        m *= int(d)
    record_wire_bytes(kind, wire.dtype if wire is not None else "fp32",
                      payload_wire_bytes(shape, wire) * passes,
                      4.0 * m * passes)


def gather_token_chunks(x: torch.Tensor, axis: ps.Axis = ps.EP_AXIS, *,
                        wire: Optional[CompressionConfig] = None,
                        overlap: bool = False) -> Tuple[torch.Tensor, ...]:
    """Dispatch side of EP: the ``[T, ...]`` token shard gathered over
    ``axis`` as a tuple of per-source chunks in hop order (element ``t`` =
    rank ``(me + t) % n``'s tokens; ``(x,)`` where the axis holds one
    rank). ``wire`` (:func:`wire_config`) quantizes every chunk;
    ``overlap=True`` runs the ``ppermute`` ring, ``False`` one
    ``all_gather``: the same chunks bit for bit either way."""
    wire = _norm_wire(wire)
    n = comm.axis_size(axis)
    if n <= 1:
        return (x,)
    _record_ep_wire("ep_dispatch", tuple(x.shape), wire, n - 1)
    return _GatherChunks.apply(x.contiguous(), axis, wire, bool(overlap))


def combine_token_chunks(ys: Sequence[torch.Tensor],
                         axis: ps.Axis = ps.EP_AXIS, *,
                         wire: Optional[CompressionConfig] = None,
                         overlap: bool = False) -> torch.Tensor:
    """Combine side of EP: the per-destination partials (``ys[t]`` for
    rank ``(me + t) % n``) returned to their token shards and summed over
    source ranks in ascending order (the reference's ``psum_scatter``
    order); the dual of :func:`gather_token_chunks`, same hops, same wire.
    ``ys[0]`` where the axis holds one rank."""
    ys = tuple(ys)
    wire = _norm_wire(wire)
    n = comm.axis_size(axis)
    if n <= 1:
        return ys[0]
    if len(ys) != n:
        raise ValueError(f"combine_token_chunks: {len(ys)} chunks for an "
                         f"axis of {n} ranks")
    _record_ep_wire("ep_combine", tuple(ys[0].shape), wire, n - 1)
    return _CombineChunks.apply(axis, wire, bool(overlap), *ys)
