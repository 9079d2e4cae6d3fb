"""Weight-quantized linear layers and expert bank (counterpart of
``neuronx_distributed_tpu/quantization/quantization_layers.py``) at tp = ep
= 1, where the column- and row-parallel layers are the same product and
every collective is the identity.

Each layer stores its kernel quantized (``kernel_q`` int8 or fp8, the JAX
layout ``[in, out]``) beside fp32 scales (``kernel_scale``), frozen; the
products stay ``torch.matmul``/``einsum`` on the dequantized weight, as
the JAX package leaves them to XLA. Two modes:

* ``w8a16`` (default): dequantize the kernel to the compute dtype (fp32
  product, one rounding) and multiply;
* ``w8a8`` (``activation_quantization=True``): quantize the input per
  tensor and multiply the codes, scaled by both scales afterwards. int8
  codes are multiplied in fp64, which holds their int32 sum exactly.

Scales are per out-channel (``[out]``), per tensor (``[1]``) or, with
``PER_BLOCK_SYMMETRIC``, per block of the contraction dim (``[in/B,
out]``, w8a16 only).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..modules.moe import expert_mlps
from .quantization_utils import (QuantizationType, QuantizedDtype,
                                 dequantize, dequantize_blockwise, div_exact,
                                 quantize)


def frozen(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """A parameter that takes no gradient (integer dtypes cannot)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _QuantLinear(nn.Module):
    """``y = x @ dequantize(kernel_q, kernel_scale)`` (+ bias)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = False,
                 quantized_dtype: QuantizedDtype = QuantizedDtype.INT8,
                 quantization_type: QuantizationType = (
                     QuantizationType.PER_CHANNEL_SYMMETRIC),
                 activation_quantization: bool = False,
                 scale_block_size: int = 128,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.quantized_dtype = quantized_dtype
        self.quantization_type = quantization_type
        self.activation_quantization = activation_quantization
        self.dtype = dtype
        per_block = quantization_type == QuantizationType.PER_BLOCK_SYMMETRIC
        if per_block and in_features % scale_block_size:
            raise ValueError(
                f"contraction dim {in_features} not divisible by "
                f"scale_block_size {scale_block_size}")
        if per_block and activation_quantization:
            raise ValueError(
                "per-block weight quantisation is w8a16-only (block "
                "rescale inside the accumulation is not worth the MXU "
                "throughput loss)")
        self.kernel_q = frozen((in_features, out_features),
                               quantized_dtype.torch_dtype, device)
        scale_shape = ((in_features // scale_block_size, out_features)
                       if per_block else (out_features,)
                       if quantization_type
                       == QuantizationType.PER_CHANNEL_SYMMETRIC else (1,))
        self.kernel_scale = frozen(scale_shape, torch.float32, device)
        self.bias = (nn.Parameter(torch.empty(
            (out_features,), dtype=param_dtype or dtype, device=device))
            if use_bias else None)

    def weight(self) -> torch.Tensor:
        """The kernel dequantized to the compute dtype."""
        if self.quantization_type == QuantizationType.PER_BLOCK_SYMMETRIC:
            return dequantize_blockwise(self.kernel_q, self.kernel_scale,
                                        self.dtype)
        return dequantize(self.kernel_q, self.kernel_scale[None, :],
                          self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation_quantization:
            y = self._w8a8(x)
        else:
            y = torch.matmul(x.to(self.dtype), self.weight())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    def _w8a8(self, x: torch.Tensor) -> torch.Tensor:
        qx, x_scale = quantize(x, self.quantized_dtype,
                               QuantizationType.PER_TENSOR_SYMMETRIC)
        wide = (torch.float64 if self.quantized_dtype == QuantizedDtype.INT8
                else torch.float32)
        acc = torch.matmul(qx.to(wide), self.kernel_q.to(wide)).float()
        return (acc * x_scale * self.kernel_scale[None, :]).to(self.dtype)


class QuantizedColumnParallel(_QuantLinear):
    """The reference's ``QuantizedColumnParallel`` at tp = 1."""


class QuantizedRowParallel(_QuantLinear):
    """The reference's ``QuantizedRowParallel`` at tp = 1."""


class QuantizedGQAQKVColumnParallelLinear(nn.Module):
    """Fused Q/K/V projection with weight-quantized kernels (w8a16):
    ``{q,k,v}_kernel_q [H, out]`` with per-out-channel fp32
    ``{q,k,v}_kernel_scale [out]``."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int,
                 quantized_dtype: QuantizedDtype = QuantizedDtype.INT8,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        self.dtype = dtype
        qdt = quantized_dtype.torch_dtype
        for name, out in (("q_kernel", num_heads * head_dim),
                          ("k_kernel", num_kv_heads * head_dim),
                          ("v_kernel", num_kv_heads * head_dim)):
            setattr(self, f"{name}_q", frozen((hidden, out), qdt, device))
            setattr(self, f"{name}_scale",
                    frozen((out,), torch.float32, device))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        return tuple(
            torch.matmul(x, dequantize(getattr(self, f"{n}_kernel_q"),
                                       getattr(self, f"{n}_kernel_scale")[
                                           None, :], self.dtype))
            for n in "qkv")


class QuantizedExpertMLPs(nn.Module):
    """Weight-quantized stacked GLU experts (w8a16) with capacity dispatch:
    ``gate_up_q [E, H, 2, I]`` with ``gate_up_scale [E, 2, I]`` and
    ``down_q [E, I, H]`` with ``down_scale [E, H]``, per expert and
    out-channel. The whole bank is dequantized each call, then the
    capacity einsums run (:func:`..modules.moe.expert_mlps.capacity_glu`),
    with ``top_k`` read from the router's choices as in JAX."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 capacity_factor: float = 2.0,
                 quantized_dtype: QuantizedDtype = QuantizedDtype.INT8,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        qdt = quantized_dtype.torch_dtype
        e, h, i = num_experts, hidden, intermediate
        self.gate_up_q = frozen((e, h, 2, i), qdt, device)
        self.gate_up_scale = frozen((e, 2, i), torch.float32, device)
        self.down_q = frozen((e, i, h), qdt, device)
        self.down_scale = frozen((e, h), torch.float32, device)

    def bank(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(gate_up [E, H, 2, I], down [E, I, H])`` in the compute dtype,
        each made through one fp32 temporary."""
        return (dequantize(self.gate_up_q, self.gate_up_scale[:, None],
                           self.dtype),
                dequantize(self.down_q, self.down_scale[:, None], self.dtype))

    def forward(self, x: torch.Tensor, gates: torch.Tensor,
                idx: torch.Tensor, sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As the float bank's capacity path; ``sentinel_empty`` is for the
        blockwise path only and ignored."""
        capacity = expert_mlps.compute_capacity(
            x.shape[0], self.num_experts, idx.shape[-1],
            self.capacity_factor)
        gate_up, down = self.bank()
        return expert_mlps.capacity_glu(x, gates, idx, self.num_experts,
                                        capacity, gate_up, down, self.dtype)


def quantize_expert_params(params, quantized_dtype=QuantizedDtype.INT8
                           ) -> Dict[str, torch.Tensor]:
    """An :class:`ExpertMLPs` state (``gate_up [E, H, 2, I]``, ``down [E, I,
    H]``, tensors or arrays) -> :class:`QuantizedExpertMLPs`'s, per expert
    and out-channel over the contraction dim, where the tensors lie; scales
    floored at 1e-12, as in JAX (which casts fp8 without a clip: the values
    stay within ±max by construction)."""
    out = {}
    for name in ("gate_up", "down"):
        w = torch.as_tensor(params[name]).float()
        scale = torch.clamp(div_exact(w.abs().amax(dim=1),
                                      quantized_dtype.max_value), min=1e-12)
        q = w / scale.unsqueeze(1)
        out[f"{name}_q"] = (
            torch.clamp(torch.round(q), -127, 127).to(torch.int8)
            if quantized_dtype == QuantizedDtype.INT8
            else q.to(quantized_dtype.torch_dtype))
        out[f"{name}_scale"] = scale
    return out
