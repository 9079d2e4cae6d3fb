"""KV caches (counterparts of ``neuronx_distributed_tpu/inference/
kv_cache.py``): the contiguous per-request cache of :mod:`.generation`,
its int8 variant, the pad sentinel and the int8 per-vector quantizer that
the paged pool shares.

A contiguous cache holds k/v ``[L, B, S_max, KV, D]``, the true token
position stored in every slot (``pos [B, S_max]``, ``PAD_POSITION`` when
empty) and the int ``index`` of the next write slot. Masking is by stored
position, not slot index, so right-padded prompts need no extra mask.
Unlike the JAX cache, which is functional and donated to the step, the
forward writes these tensors **in place** and hands back the cache with
``index`` advanced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

# Sentinel "position" for unwritten / padding slots: greater than any real
# position, so the causal mask (qpos >= slot_pos) always excludes them.
PAD_POSITION = (2 ** 31 - 1) // 2


@dataclass
class KVCache:
    """Stacked per-layer cache: k/v ``[L, B, S_max, KV, D]``, ``pos [B,
    S_max]`` int32 and the next write slot ``index``: a host int (the
    step reads no device value to place its write), or, as in the
    reference, a 0-dim int32 tensor on the cache's device, which one
    captured step serves at every position (a bundle's programs)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    index: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclass
class QuantizedKVCache(KVCache):
    """Int8 k/v with one fp32 scale per (layer, batch, slot, kv head):
    ``k_scale``/``v_scale`` ``[L, B, S_max, KV]``."""

    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class ContiguousCacheView:
    """One layer's slice of a contiguous cache plus this step's write slot,
    handed to ``LlamaAttention``: k/v ``[B, S_max, KV, D]`` (int8 codes,
    with ``k_scale``/``v_scale`` ``[B, S_max, KV]``, for a quantized
    cache), the stored positions ``pos [B, S_max]`` with this step's
    already recorded, and ``index``, where this step's rows land."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    pos: torch.Tensor
    index: int


def _pos(batch: int, max_len: int, dev: torch.device) -> torch.Tensor:
    return torch.full((batch, max_len), PAD_POSITION, dtype=torch.int32,
                      device=dev)


def init_kv_cache(num_layers: int, batch: int, max_len: int,
                  num_kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = None) -> KVCache:
    """An empty cache on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   pos=_pos(batch, max_len, dev))


def init_quantized_kv_cache(num_layers: int, batch: int, max_len: int,
                            num_kv_heads: int, head_dim: int,
                            device: DeviceLike = None) -> QuantizedKVCache:
    """An empty int8 cache on ``device`` (``None``: the CUDA card); scales
    start at 1."""
    dev = resolve_device(device)
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return QuantizedKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=dev),
        v=torch.zeros(shape, dtype=torch.int8, device=dev),
        pos=_pos(batch, max_len, dev),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev))


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


def write_slots(index, steps: int, max_len: int):
    """The slots a step of ``steps`` rows writes at ``index``: a slice for
    a host int, an int64 index tensor for a device scalar (its start
    clamped so that the rows fit, as the reference's
    ``dynamic_update_slice`` clamps)."""
    if isinstance(index, torch.Tensor):
        start = torch.clamp(index.long(), 0, max_len - steps)
        return start + torch.arange(steps, device=index.device)
    return slice(index, index + steps)
