"""RMSNorm and LayerNorm (counterparts of
``neuronx_distributed_tpu/modules/norms.py`` at tp=1)."""

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


class LayerNorm(nn.Module):
    """LayerNorm with fp32 mean and variance; the output is cast to
    ``dtype``. Weights keep the JAX names ``scale`` and (with ``use_bias``)
    ``bias``, held in ``param_dtype`` (default ``dtype``)."""

    def __init__(self, hidden: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.scale = nn.Parameter(torch.ones(hidden, dtype=pdt,
                                             device=device))
        self.bias = (nn.Parameter(torch.zeros(hidden, dtype=pdt,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)
