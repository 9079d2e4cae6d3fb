"""KV cache helpers shared by the paged pool: the pad sentinel and the
int8 per-vector quantizer (counterparts of
``neuronx_distributed_tpu/inference/kv_cache.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

# Sentinel "position" for unwritten / padding slots: greater than any real
# position, so the causal mask (qpos >= slot_pos) always excludes them.
PAD_POSITION = (2 ** 31 - 1) // 2


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., D] -> (int8 [..., D], fp32 scale [...])`` symmetric
    per-vector. ``torch.round`` rounds half to even like ``jnp.round``, so
    the codes match the JAX quantizer bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)
