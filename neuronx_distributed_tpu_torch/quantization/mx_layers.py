"""Layers whose weights are packed MX payloads (counterpart of
``neuronx_distributed_tpu/quantization/mx_layers.py``) at tp = ep = 1.

Every MX tensor stores its contraction dim last (``[out, in_packed]``), the
blocks of 32 running along it: fp4 codes two to a byte (``uint8``), or fp8
elements (``float8_e4m3fn``), beside fp32 E8M0 scales ``[out, in/32]``.
Each call dequantizes (fp32 product, one rounding to the compute dtype)
and multiplies with ``torch.matmul``/``einsum``, as the JAX package leaves
the product to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..modules.moe import expert_mlps
from .microscaling import (MX_BLOCK, mx_dequantize_fp4, mx_dequantize_fp8,
                           mx_quantize_fp4, mx_quantize_fp8)
from .quantization_layers import frozen


def mx_dequant(packed: torch.Tensor, scales: torch.Tensor, mx_format: str,
               dtype: torch.dtype) -> torch.Tensor:
    if mx_format == "fp4":
        return mx_dequantize_fp4(packed, scales, dtype=dtype)
    if mx_format == "fp8":
        return mx_dequantize_fp8(packed, scales, dtype=dtype)
    raise ValueError(f"unknown mx_format {mx_format!r}")


def mx_storage(mx_format: str) -> Tuple[int, torch.dtype]:
    """``(elements per stored value, storage dtype)``: fp4 packs two codes
    a ``uint8``; fp8 stores e4m3 elements."""
    if mx_format == "fp4":
        return 2, torch.uint8
    if mx_format == "fp8":
        return 1, torch.float8_e4m3fn
    raise ValueError(f"unknown mx_format {mx_format!r}")


def mx_quantizer(mx_format: str):
    if mx_format == "fp4":
        return mx_quantize_fp4
    if mx_format == "fp8":
        return mx_quantize_fp8
    raise ValueError(f"unknown mx_format {mx_format!r}")


def mx_params(out_dim: int, in_dim: int, mx_format: str, device
              ) -> Tuple[nn.Parameter, nn.Parameter]:
    """Frozen ``(packed [out, in/pack], scale [out, in/32])``."""
    pack, store = mx_storage(mx_format)
    return (frozen((out_dim, in_dim // pack), store, device),
            frozen((out_dim, in_dim // MX_BLOCK), torch.float32, device))


def mx_pack_linear(w: torch.Tensor, mx_format: str = "fp4"
                   ) -> Dict[str, torch.Tensor]:
    """A float kernel ``[in, out]`` -> ``{"kernel_packed": [out, in/pack],
    "kernel_scale": [out, in/32]}``, contraction dim last."""
    packed, scale = mx_quantizer(mx_format)(w.float().t())
    return {"kernel_packed": packed, "kernel_scale": scale}


class _MXLinear(nn.Module):
    """``y = x @ W^T`` with ``W [out, in]`` dequantized from
    ``kernel_packed``/``kernel_scale`` (+ bias)."""

    def __init__(self, in_features: int, out_features: int,
                 mx_format: str = "fp4", use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mx_format = mx_format
        self.dtype = dtype
        self.kernel_packed, self.kernel_scale = mx_params(
            out_features, in_features, mx_format, device)
        self.bias = (nn.Parameter(torch.empty(
            (out_features,), dtype=param_dtype or dtype, device=device))
            if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = mx_dequant(self.kernel_packed, self.kernel_scale, self.mx_format,
                       self.dtype)
        y = torch.matmul(x.to(self.dtype), w.t())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class MXQuantizedColumnParallel(_MXLinear):
    """The reference's ``MXQuantizedColumnParallel`` at tp = 1."""


class MXQuantizedRowParallel(_MXLinear):
    """The reference's ``MXQuantizedRowParallel`` at tp = 1."""


class MXGQAQKVColumnParallelLinear(nn.Module):
    """Fused Q/K/V projection from packed MX weights:
    ``{q,k,v}_kernel_packed [out, H/pack]`` and ``{q,k,v}_kernel_scale
    [out, H/32]``."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, mx_format: str = "fp4",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        self.mx_format = mx_format
        self.dtype = dtype
        for name, out in (("q_kernel", num_heads * head_dim),
                          ("k_kernel", num_kv_heads * head_dim),
                          ("v_kernel", num_kv_heads * head_dim)):
            packed, scale = mx_params(out, hidden, mx_format, device)
            setattr(self, f"{name}_packed", packed)
            setattr(self, f"{name}_scale", scale)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        return tuple(
            torch.matmul(x, mx_dequant(getattr(self, f"{n}_kernel_packed"),
                                       getattr(self, f"{n}_kernel_scale"),
                                       self.mx_format, self.dtype).t())
            for n in "qkv")


class MXExpertMLPs(nn.Module):
    """Stacked GLU experts from packed MX weights, contraction dim last:
    ``gate_up_packed [E, 2, I, H/pack]`` with ``gate_up_scale [E, 2, I,
    H/32]``, ``down_packed [E, H, I/pack]`` with ``down_scale [E, H,
    I/32]``. Capacity dispatch; ``dropless`` (the default, the decode
    contract) raises the capacity to T, which no expert can overflow."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 capacity_factor: float = 2.0, dropless: bool = True,
                 mx_format: str = "fp4", dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dropless = dropless
        self.mx_format = mx_format
        self.dtype = dtype
        pack, store = mx_storage(mx_format)
        e, h, i = num_experts, hidden, intermediate
        self.gate_up_packed = frozen((e, 2, i, h // pack), store, device)
        self.gate_up_scale = frozen((e, 2, i, h // MX_BLOCK), torch.float32,
                                    device)
        self.down_packed = frozen((e, h, i // pack), store, device)
        self.down_scale = frozen((e, h, i // MX_BLOCK), torch.float32, device)

    def bank(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(gate_up [E, 2, I, H], down [E, H, I])`` in the compute
        dtype."""
        return (mx_dequant(self.gate_up_packed, self.gate_up_scale,
                           self.mx_format, self.dtype),
                mx_dequant(self.down_packed, self.down_scale, self.mx_format,
                           self.dtype))

    def forward(self, x: torch.Tensor, gates: torch.Tensor,
                idx: torch.Tensor, sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        t = x.shape[0]
        capacity = expert_mlps.compute_capacity(
            t, self.num_experts, idx.shape[-1], self.capacity_factor)
        if self.dropless:
            capacity = max(capacity, t)
        gate_up, down = self.bank()
        return expert_mlps.capacity_glu(x, gates, idx, self.num_experts,
                                        capacity, gate_up, down, self.dtype,
                                        contraction_last=True)


def mx_pack_expert_params(params, mx_format: str = "fp4"
                          ) -> Dict[str, torch.Tensor]:
    """An :class:`ExpertMLPs` state (``gate_up [E, H, 2, I]``, ``down [E, I,
    H]``) -> :class:`MXExpertMLPs`'s (contraction dim last, packed)."""
    quant = mx_quantizer(mx_format)
    gu = torch.as_tensor(params["gate_up"]).float().permute(0, 2, 3, 1)
    dn = torch.as_tensor(params["down"]).float().permute(0, 2, 1)
    gu_packed, gu_scale = quant(gu)
    dn_packed, dn_scale = quant(dn)
    return {"gate_up_packed": gu_packed, "gate_up_scale": gu_scale,
            "down_packed": dn_packed, "down_scale": dn_scale}
