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
over tp, in JAX's order (``:174-197``). The expert-parallel form comes
with a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops import blockwise_moe as ops_bw
from ...parallel import mappings
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
                 contraction_last: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The capacity path's mask einsums in ``dtype``: dispatch the tokens
    to ``capacity`` slots per expert, ``silu(x Wg) (x Wu) Wd`` per slot,
    combine by gate. ``gate_up [E, H, 2, I]`` and ``down [E, I, H]``, or
    with ``contraction_last`` (the MX banks' layout) ``[E, 2, I, H]`` and
    ``[E, H, I]``; across tensor-parallel ranks ``I`` is this rank's
    shard, and the slots enter the TP region by ``copy_to`` and leave it
    by ``reduce_from`` (the reference's expert-fused column and row
    parallel linears). Returns ``(y [T, H], {"dropped_fraction"})``."""
    dispatch, combine, dropped = build_dispatch_combine(
        gates, idx, num_experts, capacity)
    xin = torch.einsum("tec,th->ech", dispatch.to(dtype), x.to(dtype))
    xin = mappings.copy_to_tensor_parallel_region(xin, ps.TP_AXIS)
    h = torch.einsum("ech,ekih->ecki" if contraction_last
                     else "ech,ehki->ecki", xin, gate_up)
    h = ops_bw._silu(h[..., 0, :]) * h[..., 1, :]
    out = torch.einsum("eci,ehi->ech" if contraction_last
                       else "eci,eih->ech", h, down)
    out = mappings.reduce_from_tensor_parallel_region(out, ps.TP_AXIS)
    y = torch.einsum("tec,ech->th", combine.to(dtype), out)
    return y.to(dtype), {"dropped_fraction": dropped}


class ExpertMLPs(nn.Module):
    """Stacked GLU experts at ep = 1, at ``tp_size`` ranks of tensor
    parallelism (``I / tp_size`` of the intermediate width here). ``block_i``
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
                 tp_size: int = 1):
        super().__init__()
        if intermediate % tp_size:
            raise ValueError(f"intermediate {intermediate} not divisible by "
                             f"tp_size {tp_size}")
        intermediate //= tp_size
        if dispatch_mode not in ("capacity", "blockwise"):
            raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self.block_size = block_size
        self.block_i = block_i
        self.sentinel_empty = sentinel_empty
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.gate_up = nn.Parameter(torch.empty(
            (num_experts, hidden, 2, intermediate), dtype=pdt, device=device))
        self.down = nn.Parameter(torch.empty(
            (num_experts, intermediate, hidden), dtype=pdt, device=device))

    def forward(self, x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``x [T, H]``, ``gates``/``idx [T, K]`` -> ``([T, H] in dtype,
        {"dropped_fraction"})``. ``sentinel_empty`` overrides the module's
        for one call (the decode step turns it on)."""
        if self.dispatch_mode == "blockwise":
            se = self.sentinel_empty if sentinel_empty is None \
                else sentinel_empty
            return self._forward_blockwise(x, gates, idx, se)
        capacity = compute_capacity(x.shape[0], self.num_experts,
                                    idx.shape[-1], self.capacity_factor)
        return capacity_glu(x, gates, idx, self.num_experts, capacity,
                            self.gate_up.to(self.dtype),
                            self.down.to(self.dtype), self.dtype)

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
