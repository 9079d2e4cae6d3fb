"""Attention-head padding for a head count that tp does not divide
(counterpart of ``neuronx_distributed_tpu/parallel/pad.py``, JAX
``:21-49``): the q and o kernels gain zero head columns and rows, so each
shard owns a whole number of heads, and a mask marks the real ones."""

from __future__ import annotations

from typing import Tuple

import torch


def get_number_of_extra_heads(num_heads: int, tp: int) -> int:
    """Reference ``get_number_of_extra_heads:14``."""
    return (tp - num_heads % tp) % tp


def pad_attention_params(q_kernel, o_kernel, num_heads: int, head_dim: int,
                         tp: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Zero-pad ``q_kernel [.., H, num_heads*hd]`` and ``o_kernel [..,
    num_heads*hd, H]`` to a tp-divisible head count (reference
    ``pad_model:32``). Returns ``(q_padded, o_padded, padded_heads)``."""
    q, o = torch.as_tensor(q_kernel), torch.as_tensor(o_kernel)
    extra = get_number_of_extra_heads(num_heads, tp)
    if extra == 0:
        return q, o, num_heads
    q_pad = q.new_zeros((*q.shape[:-1], extra * head_dim))
    o_pad = o.new_zeros((*o.shape[:-2], extra * head_dim, o.shape[-1]))
    return (torch.cat([q, q_pad], dim=-1), torch.cat([o, o_pad], dim=-2),
            num_heads + extra)


def generate_padding_mask(num_real_heads: int, num_padded_heads: int,
                          head_dim: int) -> torch.Tensor:
    """``[num_padded * hd]`` fp32 mask, 1 for real heads' features
    (reference ``generate_padding_mask:114``)."""
    m = torch.zeros(num_padded_heads * head_dim, dtype=torch.float32)
    m[:num_real_heads * head_dim] = 1.0
    return m
