"""RMSNorm (counterpart of ``neuronx_distributed_tpu/modules/norms.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class RMSNorm(nn.Module):
    """RMSNorm in fp32 accumulation (llama-style); the output is cast to
    ``dtype``. The weight keeps the JAX name ``scale`` and is held in
    ``param_dtype`` (default ``dtype``)."""

    def __init__(self, hidden: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(hidden,
                                             dtype=param_dtype or dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(self.dtype)
