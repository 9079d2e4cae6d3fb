"""Argmax and top-k over a tp-sharded dim (counterpart of
``neuronx_distributed_tpu/ops/operators.py``, JAX ``:23-64``): each rank
takes its local winners, offsets their indices by its shard's start, and
an all-gather and a last reduction pick the global result, so the whole
(vocab) dim never exists on one rank."""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import comm
from ..parallel import mesh as ps


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: descending, and of tied values
    the lowest index first (a stable sort; ``torch.topk`` orders ties
    arbitrarily)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def distributed_argmax(x: torch.Tensor, axis: ps.Axis = ps.TP_AXIS,
                       dim: int = -1) -> torch.Tensor:
    """Global argmax indices over the sharded ``dim`` (reference
    ``argmax:55``); ties go to the lowest global index."""
    n = comm.axis_size(axis)
    if n == 1:
        return torch.argmax(x, dim=dim)
    dim = dim % x.dim()
    local_size = x.shape[dim]
    local_max, local_idx = torch.max(x, dim=dim)
    global_idx = local_idx + ps.axis_rank(axis) * local_size
    maxes = comm.all_gather(local_max[None], axis, 0)      # [n, ...]
    idxs = comm.all_gather(global_idx[None], axis, 0)      # [n, ...]
    winner = torch.argmax(maxes, dim=0)
    return torch.gather(idxs, 0, winner[None])[0]


def distributed_topk(x: torch.Tensor, k: int, axis: ps.Axis = ps.TP_AXIS,
                     dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k ``(values, indices)`` over the sharded ``dim``
    (reference ``topk:31``): local top-k, the n*k candidates gathered,
    top-k again. The result's last dim is k."""
    n = comm.axis_size(axis)
    xm = torch.movedim(x, dim, -1)
    if n == 1:
        return _top_k(xm, k)
    local_size = xm.shape[-1]
    if k > local_size:
        raise ValueError(f"k={k} exceeds local shard size {local_size}")
    lv, li = _top_k(xm, k)
    li = li + ps.axis_rank(axis) * local_size
    cv = comm.all_gather(lv, axis, -1)
    ci = comm.all_gather(li, axis, -1)
    gv, gpos = _top_k(cv, k)
    return gv, torch.gather(ci, -1, gpos)
