"""The MoE routers (counterpart of
``neuronx_distributed_tpu/modules/moe/routing.py``): top-k, Sinkhorn
(top-1, balanced) and group-limited (top-k within the best groups).

A router computes in fp32 from an fp32 kernel ``[H, E]``, whatever the
model's dtypes: a serving model that holds its other weights in bf16 keeps
this one in fp32, so it routes as the JAX package does from the same
checkpoint. Each returns ``(gates [T, k] fp32, idx [T, k] int32, aux)``,
aux holding ``load_balance_loss`` and ``z_loss``; ties go to the lowest
expert index, as ``jax.lax.top_k`` and ``jnp.argmax`` break them.

Across data-parallel ranks the load-balance loss is the reference's over
the global tokens (its GSPMD step sees the whole batch): ``f`` and ``p``
are averaged over the data ranks before their product, ``p`` with its
cotangent passed back whole (:class:`_DataMean`), so that the
data-parallel mean of the ranks' gradients is the global loss's gradient.
A product of local means averaged over the ranks is another number. The z-loss is a plain mean
over tokens: each rank's local mean, averaged with the loss. The Sinkhorn
router normalises over every token: across data ranks its log-sum-exp and
its column sums are taken over every data rank's tokens (two all-reduces
for the log-sum-exp, one per iteration for the columns; none carries a
gradient, since the choice is an argmax), as the reference's GSPMD step
normalises over the global batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ...parallel import comm
from ...parallel import mesh as ps


class _DataMean(torch.autograd.Function):
    """The mean over the data-parallel ranks forward; the cotangent passed
    back unchanged, since the train step averages the ranks' gradients
    (each rank's share of the global mean is then carried whole)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x, ps.DATA_AXES) / comm.axis_size(
            ps.DATA_AXES)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def _load_balance_loss(probs: torch.Tensor,
                       expert_mask: torch.Tensor) -> torch.Tensor:
    """``E · Σ_e f_e · p_e``: ``f_e`` the share of tokens sent to expert
    ``e``, ``p_e`` its mean router probability, over the tokens of every
    data-parallel rank (each rank holds as many). ``probs``/``expert_mask``
    ``[T, E]``."""
    e = probs.shape[-1]
    f, p = expert_mask.mean(0), probs.mean(0)
    if comm.axis_size(ps.DATA_AXES) > 1:
        f, p = _DataMean.apply(f.detach()), _DataMean.apply(p)
    return e * torch.sum(f * p)


def _z_loss(logits: torch.Tensor) -> torch.Tensor:
    """Router z-loss: ``mean(logsumexp(logits)²)``."""
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


def top_k_lowest_first(probs: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row and their indices, the lowest
    index first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` does not promise an order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux(logits: torch.Tensor, probs: torch.Tensor,
         idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The load-balance loss over the chosen experts ``idx [T, k]`` and the
    z-loss."""
    mask = torch.zeros_like(probs).scatter_add_(
        1, idx, torch.ones(idx.shape, dtype=probs.dtype, device=idx.device))
    return {"load_balance_loss": _load_balance_loss(probs, mask),
            "z_loss": _z_loss(logits)}


class RouterBase(nn.Module):
    """The fp32 linear router: ``logits = x @ kernel`` with ``kernel [H,
    E]`` held in fp32."""

    def __init__(self, hidden: int, num_experts: int, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.kernel = nn.Parameter(torch.empty((hidden, num_experts),
                                               dtype=torch.float32,
                                               device=device))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel.float()


class RouterTopK(RouterBase):
    """Top-k softmax router with the top-k gates renormalised to sum 1."""

    def __init__(self, hidden: int, num_experts: int, top_k: int = 2,
                 device=None):
        super().__init__(hidden, num_experts, device)
        self.top_k = top_k

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """``x [T, H]`` -> ``(gates [T, k] fp32, idx [T, k] int32, aux)``."""
        logits = self.logits(x)
        probs = torch.softmax(logits, dim=-1)
        gates, idx = top_k_lowest_first(probs, self.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates, idx.to(torch.int32), _aux(logits, probs, idx)


class RouterSinkhorn(RouterBase):
    """Sinkhorn-balanced top-1 router: ``num_iters`` alternating column and
    row normalisations of ``exp(logits - logsumexp(all logits))`` push the
    token x expert matrix toward doubly stochastic before the argmax; the
    gate is the chosen expert's raw softmax probability."""

    def __init__(self, hidden: int, num_experts: int, num_iters: int = 4,
                 device=None):
        super().__init__(hidden, num_experts, device)
        self.num_iters = num_iters

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """``x [T, H]`` -> ``(gates [T, 1] fp32, idx [T, 1] int32, aux)``."""
        logits = self.logits(x)
        probs = torch.softmax(logits, dim=-1)
        lg = logits.detach()
        pi = torch.exp(lg - _global_logsumexp(lg))
        for _ in range(self.num_iters):
            cols = comm.all_reduce(pi.sum(0, keepdim=True), ps.DATA_AXES)
            pi = pi / torch.clamp(cols, min=1e-9)
            pi = pi / torch.clamp(pi.sum(1, keepdim=True), min=1e-9)
        idx = torch.argmax(pi, dim=-1)[:, None]
        gates = torch.gather(probs, 1, idx)
        return gates, idx.to(torch.int32), _aux(logits, probs, idx)


def _global_logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over every element of ``logits`` on every data rank
    (this rank's alone where it is the only one): the global max, then the
    sum of ``exp(logits - max)`` over the ranks."""
    if comm.axis_size(ps.DATA_AXES) == 1:
        return torch.logsumexp(logits, dim=(0, 1))
    m = comm.all_reduce(logits.amax().reshape(1), ps.DATA_AXES, op="max")
    s = comm.all_reduce(torch.exp(logits - m).sum().reshape(1),
                        ps.DATA_AXES)
    return (m + torch.log(s))[0]


class GroupLimitedRouter(RouterBase):
    """Node-limited routing: the experts form ``num_groups`` groups; each
    token keeps its best ``topk_groups`` groups by their best probability,
    then takes its top-k experts inside them (gates renormalised)."""

    def __init__(self, hidden: int, num_experts: int, top_k: int = 2,
                 num_groups: int = 2, topk_groups: int = 1, device=None):
        super().__init__(hidden, num_experts, device)
        if num_experts % num_groups != 0:
            raise ValueError("num_experts must divide into num_groups")
        allowed = topk_groups * (num_experts // num_groups)
        if top_k > allowed:
            raise ValueError(
                f"top_k {top_k} exceeds the {allowed} experts reachable "
                f"through topk_groups={topk_groups} (zero-gated -inf "
                "picks would waste expert capacity)")
        self.top_k = top_k
        self.num_groups = num_groups
        self.topk_groups = topk_groups

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        logits = self.logits(x)
        probs = torch.softmax(logits, dim=-1)
        t, g = logits.shape[0], self.num_groups
        per_group = self.num_experts // g
        group_score = probs.reshape(t, g, per_group).amax(-1)     # [T, G]
        _, top_groups = top_k_lowest_first(group_score, self.topk_groups)
        group_allowed = torch.zeros_like(group_score).scatter_(
            1, top_groups, 1.0)
        allowed = torch.repeat_interleave(group_allowed, per_group, dim=-1)
        masked = torch.where(allowed > 0, probs,
                             torch.full_like(probs, -float("inf")))
        gates, idx = top_k_lowest_first(masked, self.top_k)
        gates = torch.where(torch.isfinite(gates), gates,
                            torch.zeros_like(gates))
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates, idx.to(torch.int32), _aux(logits, probs, idx)
