"""The MoE layer: router and expert bank (counterpart of ``MoE`` in
``neuronx_distributed_tpu/modules/moe/model.py``).

The top-k router and float experts only; shared experts, the other routers
and the quantized or MX expert banks are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .expert_mlps import ExpertMLPs
from .routing import RouterTopK


class MoE(nn.Module):
    """Mixture-of-experts block over flat ``[T, H]`` or ``[B, S, H]``
    inputs. Returns ``(y, aux)``, aux holding the router's
    ``load_balance_loss`` and ``z_loss`` and the experts'
    ``dropped_fraction``."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 dispatch_mode: str = "capacity", block_size: int = 512,
                 sentinel_empty: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.hidden = hidden
        self.router = RouterTopK(hidden, num_experts, top_k, device=device)
        self.experts = ExpertMLPs(
            num_experts, hidden, intermediate, top_k=top_k,
            capacity_factor=capacity_factor, dispatch_mode=dispatch_mode,
            block_size=block_size, sentinel_empty=sentinel_empty,
            dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor, sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        flat = x.reshape(-1, self.hidden)
        gates, idx, aux = self.router(flat)
        y, eaux = self.experts(flat, gates, idx, sentinel_empty)
        aux.update(eaux)
        return y.reshape(x.shape), aux
