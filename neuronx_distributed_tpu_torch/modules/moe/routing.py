"""The top-k MoE router (counterpart of ``RouterTopK`` in
``neuronx_distributed_tpu/modules/moe/routing.py``).

The router computes in fp32 from an fp32 kernel, whatever the model's
dtypes: a serving model that holds its other weights in bf16 keeps this one
in fp32, so it routes as the JAX package does from the same checkpoint.
The Sinkhorn and group-limited routers are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


def _load_balance_loss(probs: torch.Tensor,
                       expert_mask: torch.Tensor) -> torch.Tensor:
    """``E · Σ_e f_e · p_e``: ``f_e`` the share of tokens sent to expert
    ``e``, ``p_e`` its mean router probability. ``probs``/``expert_mask``
    ``[T, E]``."""
    e = probs.shape[-1]
    return e * torch.sum(expert_mask.mean(0) * probs.mean(0))


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


class RouterTopK(nn.Module):
    """Top-k softmax router with the top-k gates renormalised to sum 1.
    ``kernel [H, E]`` is held in fp32."""

    def __init__(self, hidden: int, num_experts: int, top_k: int = 2,
                 device=None):
        super().__init__()
        self.top_k = top_k
        self.kernel = nn.Parameter(torch.empty((hidden, num_experts),
                                               dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """``x [T, H]`` -> ``(gates [T, k] fp32, idx [T, k] int32, aux)``,
        aux holding ``load_balance_loss`` and ``z_loss``."""
        logits = x.float() @ self.kernel
        probs = torch.softmax(logits, dim=-1)
        gates, idx = top_k_lowest_first(probs, self.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        mask = torch.zeros_like(probs).scatter_add_(
            1, idx, torch.ones_like(gates))
        aux = {"load_balance_loss": _load_balance_loss(probs, mask),
               "z_loss": _z_loss(logits)}
        return gates, idx.to(torch.int32), aux
