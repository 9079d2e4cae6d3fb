"""The expert MLP bank at one tensor- and expert-parallel rank (counterpart
of ``ExpertMLPs`` in ``neuronx_distributed_tpu/modules/moe/expert_mlps.py``).

Stacked GLU experts, ``gate_up [E, H, 2, I]`` (gate at index 0, up at 1)
and ``down [E, I, H]``, with two dispatch programs:

* ``"capacity"``: the capacity-factor mask einsums. Plain PyTorch; an
  expert's tokens beyond its capacity are dropped. Mixtral's default, and
  the golden cross-check of the blockwise path (with enough capacity the two
  agree).
* ``"blockwise"``: dropless. Tokens sorted by expert into blocks
  (:mod:`.blockwise`) run through the grouped GLU, K5 with its backward K7
  and K8, or K6 with ``sentinel_empty``, forward only
  (:mod:`...ops.blockwise_moe`). Under autograd the bank's weights enter the
  grouped GLU through their ``.to(dtype)`` casts, so the gradients in the
  compute dtype flow back to the parameters in theirs, as in the JAX bank.

Tensor parallel (``tp_size > 1``, JAX ``:107-118``): every rank holds
every expert at ``I / tp`` of the intermediate width, ``gate_up [E, H, 2,
I/tp]`` and ``down [E, I/tp, H]``, and sees every token. Capacity
dispatch enters the TP region through ``copy_to_tensor_parallel_region``
and leaves it by ``reduce_from_tensor_parallel_region`` around the
einsums at the local width; blockwise dispatch runs the grouped GLU (K5,
K7, K8) at the local width, enters the gates through ``copy_to`` (so the
router's gradient is complete on every rank), combines and then reduces
over tp, in JAX's order (``:174-197``).

Expert parallel (``ep_size > 1``, JAX ``:97-306``): each rank holds
``E / ep`` of the experts, ``gate_up [E/ep, H, 2, I/tp]`` and ``down
[E/ep, I/tp, H]``, the ep rank ``r`` experts ``[r E/ep, (r+1) E/ep)``.
Capacity dispatch moves the slots from the token shards to the expert
shards and back by ``enter_``/``exit_expert_parallel_region`` (one
all-to-all each way) around the einsums. Blockwise dispatch has no
all-to-all: every ep rank gathers every rank's tokens (the gather's
backward is a reduce-scatter, so the gradients of x and of the gates
carry the other ranks' contributions, and the router's gradient is
complete), routes the pairs of other ranks' experts to a sentinel expert
``E/ep`` whose blocks the grouped GLU skips (zero rows forward, zero dx,
no dW: K5, K7 and K8 see sentinel blocks in training), and
reduce-scatters the partial outputs back. With a quantized
``ep_wire_dtype`` or the ring (``ep_overlap``: None takes it at ep >= 4)
the tokens cross per chunk (:mod:`...parallel.ep_dispatch`) and the
grouped GLU runs once per source rank's chunk; the small routing
metadata stays on a monolithic fp32 gather.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops import blockwise_moe as ops_bw
from ...parallel import comm, mappings
from ...parallel import mesh as ps
from . import blockwise as bw


def compute_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """Slots per expert: ``max(int(cf · T · K / E), K)``."""
    cap = int(capacity_factor * num_tokens * top_k / num_experts)
    return max(cap, top_k)


def build_dispatch_combine(gates: torch.Tensor, idx: torch.Tensor,
                           num_experts: int, capacity: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Capacity-limited ``(dispatch [T, E, C], combine [T, E, C],
    dropped_fraction)`` from ``gates``/``idx [T, K]``. Slots go by choice
    rank first, then token order; pairs past an expert's capacity drop."""
    t, k = idx.shape
    choice = nn.functional.one_hot(idx.long(), num_experts).float()
    flat = choice.transpose(0, 1).reshape(k * t, num_experts)
    pos_flat = torch.cumsum(flat, 0) - flat
    pos = pos_flat.reshape(k, t, num_experts).transpose(0, 1)
    keep = choice * (pos < capacity)
    pos_clipped = torch.clamp(pos, max=capacity - 1).long()
    slot = nn.functional.one_hot(pos_clipped, capacity).float()
    dispatch = torch.einsum("tke,tkec->tec", keep, slot)
    combine = torch.einsum("tk,tke,tkec->tec", gates.float(), keep, slot)
    dropped = 1.0 - keep.sum() / max(float(t * k), 1.0)
    return dispatch, combine, dropped


def capacity_glu(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                 num_experts: int, capacity: int, gate_up: torch.Tensor,
                 down: torch.Tensor, dtype: torch.dtype,
                 contraction_last: bool = False,
                 expert_parallel: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The capacity path's mask einsums in ``dtype``: dispatch the tokens
    to ``capacity`` slots per expert, ``silu(x Wg) (x Wu) Wd`` per slot,
    combine by gate. ``gate_up [E, H, 2, I]`` and ``down [E, I, H]``, or
    with ``contraction_last`` (the MX banks' layout) ``[E, 2, I, H]`` and
    ``[E, H, I]``; across tensor-parallel ranks ``I`` is this rank's
    shard, and the slots enter the TP region by ``copy_to`` and leave it
    by ``reduce_from`` (the reference's expert-fused column and row
    parallel linears). With ``expert_parallel`` the banks hold this ep
    rank's ``E / ep`` experts, and the slots ``[E, C, H]`` go to the ranks
    that hold their experts and come back by one all-to-all each way
    (``[E/ep, ep C, H]`` between). Returns ``(y [T, H],
    {"dropped_fraction"})``."""
    dispatch, combine, dropped = build_dispatch_combine(
        gates, idx, num_experts, capacity)
    xin = torch.einsum("tec,th->ech", dispatch.to(dtype), x.to(dtype))
    if expert_parallel:
        xin = mappings.enter_expert_parallel_region(xin, ps.EP_AXIS, 0, 1)
    xin = mappings.copy_to_tensor_parallel_region(xin, ps.TP_AXIS)
    h = torch.einsum("ech,ekih->ecki" if contraction_last
                     else "ech,ehki->ecki", xin, gate_up)
    h = ops_bw._silu(h[..., 0, :]) * h[..., 1, :]
    out = torch.einsum("eci,ehi->ech" if contraction_last
                       else "eci,eih->ech", h, down)
    out = mappings.reduce_from_tensor_parallel_region(out, ps.TP_AXIS)
    if expert_parallel:
        out = mappings.exit_expert_parallel_region(out, ps.EP_AXIS, 1, 0)
    y = torch.einsum("tec,ech->th", combine.to(dtype), out)
    return y.to(dtype), {"dropped_fraction": dropped}


class ExpertMLPs(nn.Module):
    """Stacked GLU experts at ``tp_size`` ranks of tensor parallelism
    (``I / tp_size`` of the intermediate width here) and ``ep_size`` of
    expert parallelism (``E / ep_size`` of the experts here), with the EP
    wire (``ep_wire_dtype``) and ring (``ep_overlap``) options. ``block_i``
    is the intermediate tile of the plain grouped GLU, the Pallas kernel's
    ``block_i``. The
    capacity path reads ``top_k`` from the router's choices (``idx [T,
    K]``), as JAX builds its bank with ``top_k = gates.shape[-1]``: the
    Sinkhorn router picks one expert whatever the config's ``top_k``."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 capacity_factor: float = 2.0,
                 dispatch_mode: str = "capacity", block_size: int = 512,
                 block_i: int = 512, sentinel_empty: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None, device=None,
                 tp_size: int = 1, ep_size: int = 1,
                 ep_wire_dtype: str = "fp32",
                 ep_overlap: Optional[bool] = None):
        super().__init__()
        if intermediate % tp_size:
            raise ValueError(f"intermediate {intermediate} not divisible by "
                             f"tp_size {tp_size}")
        if num_experts % ep_size:
            raise ValueError(f"num_experts {num_experts} not divisible by "
                             f"ep_size {ep_size}")
        intermediate //= tp_size
        if dispatch_mode not in ("capacity", "blockwise"):
            raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.ep_wire_dtype = ep_wire_dtype
        self.ep_overlap = ep_overlap
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self.block_size = block_size
        self.block_i = block_i
        self.sentinel_empty = sentinel_empty
        self.dtype = dtype
        pdt = param_dtype or dtype
        e_local = num_experts // ep_size
        self.gate_up = nn.Parameter(torch.empty(
            (e_local, hidden, 2, intermediate), dtype=pdt, device=device))
        self.down = nn.Parameter(torch.empty(
            (e_local, intermediate, hidden), dtype=pdt, device=device))

    def forward(self, x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``x [T, H]``, ``gates``/``idx [T, K]`` -> ``([T, H] in dtype,
        {"dropped_fraction"})``. ``sentinel_empty`` overrides the module's
        for one call (the decode step turns it on)."""
        ep = self._ep()
        if self.dispatch_mode == "blockwise":
            se = self.sentinel_empty if sentinel_empty is None \
                else sentinel_empty
            if ep > 1:
                return self._forward_blockwise_ep(x, gates, idx, se, ep)
            return self._forward_blockwise(x, gates, idx, se)
        capacity = compute_capacity(x.shape[0], self.num_experts,
                                    idx.shape[-1], self.capacity_factor)
        return capacity_glu(x, gates, idx, self.num_experts, capacity,
                            self.gate_up.to(self.dtype),
                            self.down.to(self.dtype), self.dtype,
                            expert_parallel=ep > 1)

    def _ep(self) -> int:
        """The expert-parallel size, which the ranks' layout must match."""
        if self.ep_size > 1 and comm.axis_size(ps.EP_AXIS) != self.ep_size:
            raise ValueError(
                f"an expert bank built for ep_size={self.ep_size} on a "
                f"layout of expert-parallel size "
                f"{comm.axis_size(ps.EP_AXIS)}")
        return self.ep_size

    def _run_grouped_glu(self, xs, be, sentinel_empty: bool):
        """K5 (differentiable: K7 and K8 in the backward), or K6 with
        ``sentinel_empty``; ``bi = min(block_i, I)``, or all of I where
        that does not divide it."""
        i = self.gate_up.shape[-1]
        bi = min(self.block_i, i)
        if i % bi:
            bi = i
        glu = (ops_bw.grouped_glu_decode if sentinel_empty
               else ops_bw.grouped_glu)
        return glu(xs, self.gate_up.to(self.dtype), self.down.to(self.dtype),
                   be, self.block_size, bi)

    def _forward_blockwise(self, x, gates, idx, sentinel_empty: bool):
        t = x.shape[0]
        order, src, dest, be, _, padded = bw.compute_block_metadata(
            idx, self.num_experts, self.block_size,
            sentinel_empty=sentinel_empty)
        x = mappings.copy_to_tensor_parallel_region(x, ps.TP_AXIS)
        xs = bw.scatter_to_blocks(x.to(self.dtype), src, dest, padded)
        ys = self._run_grouped_glu(xs, be, sentinel_empty)
        # the gates enter by copy_to (backward: the tp sum of their
        # cotangent), so that the router's gradient is complete, and the
        # combined [T, H] leaves by one all-reduce (JAX :186-197)
        gates = mappings.copy_to_tensor_parallel_region(gates, ps.TP_AXIS)
        y = bw.combine_from_blocks(ys, gates, order, src, dest, t)
        y = mappings.reduce_from_tensor_parallel_region(y, ps.TP_AXIS)
        return y.to(self.dtype), {
            "dropped_fraction": torch.zeros((), device=x.device)}

    def _local_expert_partial(self, x, gates, idx, sentinel_empty: bool,
                              off: int) -> torch.Tensor:
        """The partial expert output of ``x``'s tokens through this rank's
        experts ``[off, off + E/ep)``: every other (token, choice) pair goes
        to the sentinel expert ``E/ep``, sorted last, its gate zero; the
        grouped GLU writes zero rows for its blocks and reads no weight for
        them, and their dx and dW are zero (JAX ``:199-238``). The
        monolithic and per-chunk paths share it. ``sentinel_empty`` (a
        forward-only decode step) also sentinels the blocks of the local
        experts no token hit."""
        e_local = self.gate_up.shape[0]
        local = (idx >= off) & (idx < off + e_local)
        idx_local = torch.where(local, idx - off,
                                torch.full_like(idx, e_local))
        gates_local = torch.where(local, gates, torch.zeros_like(gates))
        order, src, dest, be, _, padded = bw.compute_block_metadata(
            idx_local, e_local + 1, self.block_size,
            sentinel_empty=sentinel_empty)
        x = mappings.copy_to_tensor_parallel_region(x, ps.TP_AXIS)
        xs = bw.scatter_to_blocks(x.to(self.dtype), src, dest, padded)
        ys = self._run_grouped_glu(xs, be, sentinel_empty)
        gates_local = mappings.copy_to_tensor_parallel_region(gates_local,
                                                              ps.TP_AXIS)
        y = bw.combine_from_blocks(ys, gates_local, order, src, dest,
                                   x.shape[0])
        return mappings.reduce_from_tensor_parallel_region(y, ps.TP_AXIS)

    def _forward_blockwise_ep(self, x, gates, idx, sentinel_empty: bool,
                              ep: int):
        """Dropless blockwise at ``ep`` expert-parallel ranks (JAX
        ``_forward_blockwise_ep``). Monolithic (fp32 wire, no ring): one
        all-gather of x, the gates and the ids over ep, the gathers of x
        and the gates with a reduce-scatter backward (each rank makes
        gradients for every token, which must be summed over the ranks and
        re-sharded), this rank's partial through the grouped GLU, one
        reduce-scatter back. Per chunk (a quantized wire or the ring): the
        tokens cross by :func:`...parallel.ep_dispatch.gather_token_chunks`,
        the grouped GLU runs per source rank's chunk, and the partials go
        back by :func:`...parallel.ep_dispatch.combine_token_chunks`, in
        ascending source order: the fp32 ring equals the monolithic path
        bit for bit, int8 ring equals int8 monolithic."""
        # imported here: the wire codec's package imports this module
        from ...parallel import ep_dispatch

        r = ps.get_expert_model_parallel_rank()
        off = r * self.gate_up.shape[0]
        wire = ep_dispatch.wire_config(self.ep_wire_dtype)
        overlap = ep_dispatch.overlap_engaged(self.ep_overlap, ps.EP_AXIS)
        aux = {"dropped_fraction": torch.zeros((), device=x.device)}
        if wire is None and not overlap:
            x_g = mappings.gather_from_sequence_parallel_region(
                x, ps.EP_AXIS, 0, to_model_parallel=True)
            gates_g = mappings.gather_from_sequence_parallel_region(
                gates, ps.EP_AXIS, 0, to_model_parallel=True)
            idx_g = comm.all_gather(idx, ps.EP_AXIS, 0)
            y = self._local_expert_partial(x_g, gates_g, idx_g,
                                           sentinel_empty, off)
            y = mappings.reduce_scatter_to_sequence_parallel_region(
                y, ps.EP_AXIS, 0)
            return y.to(self.dtype), aux
        t_local = x.shape[0]
        gates_g = mappings.gather_from_sequence_parallel_region(
            gates, ps.EP_AXIS, 0, to_model_parallel=True)
        idx_g = comm.all_gather(idx, ps.EP_AXIS, 0)
        chunks = ep_dispatch.gather_token_chunks(x, ps.EP_AXIS, wire=wire,
                                                 overlap=overlap)
        ys = []
        for t in range(ep):
            start = (r + t) % ep * t_local   # chunk t's source rank's rows
            ys.append(self._local_expert_partial(
                chunks[t], gates_g[start:start + t_local],
                idx_g[start:start + t_local], sentinel_empty, off))
        y = ep_dispatch.combine_token_chunks(ys, ps.EP_AXIS, wire=wire,
                                             overlap=overlap)
        return y.to(self.dtype), aux
