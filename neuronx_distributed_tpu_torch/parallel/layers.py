"""The tp=1 forward of the layers Llama uses from
``neuronx_distributed_tpu/parallel/layers.py``.

At one tensor-parallel rank the column- and row-parallel linears are the
same product, ``x @ kernel`` with the kernel in the JAX layout ``[in,
out]``, so one :class:`Linear` stands for both. The large products stay
``torch.matmul``, as the JAX package leaves them to XLA. The sharded forms
come with the parallel substrate in a later slice.

As in flax (``dtype`` and ``param_dtype``), each layer holds its weights in
``param_dtype`` (default: ``dtype``) and casts them, and its input, to the
compute ``dtype`` at use; no second copy of the weights is stored. With
fp32 weights and bf16 compute, gradients arrive in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Linear(nn.Module):
    """``ColumnParallelLinear`` / ``RowParallelLinear`` at tp=1, without
    bias (Llama uses none): ``y = x @ kernel``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _empty((in_features, out_features),
                             param_dtype or dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))


class ParallelEmbedding(nn.Module):
    """Vocab embedding at tp=1: a row lookup in ``embedding [V, H]``, cast
    to ``dtype``. The lookup is ``F.embedding``, whose backward sums a
    row's gradients in a fixed order: the backward of an indexed read
    (``index_put_`` with accumulate) gave other bits from run to run on
    the CPU, which broke bitwise resume and remat checks."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _empty((num_embeddings, features),
                                param_dtype or dtype, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding).to(self.dtype)


class GQAQKVColumnParallelLinear(nn.Module):
    """Fused Q/K/V projection with grouped-query attention at tp=1:
    ``q_kernel [H, N*D]``, ``k_kernel``/``v_kernel`` ``[H, KV*D]``."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.bfloat16,
                 device=None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.q_kernel = _empty((hidden, num_heads * head_dim), pdt, device)
        self.k_kernel = _empty((hidden, num_kv_heads * head_dim), pdt, device)
        self.v_kernel = _empty((hidden, num_kv_heads * head_dim), pdt, device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        return tuple(torch.matmul(x, w.to(self.dtype))
                     for w in (self.q_kernel, self.k_kernel, self.v_kernel))
