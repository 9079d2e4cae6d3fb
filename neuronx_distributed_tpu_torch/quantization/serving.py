"""Offline weight quantization for the serving tiers (counterpart of
``neuronx_distributed_tpu/quantization/serving.py``).

Converts the port's float state dict into the one a ``weight_quant``
model holds, per layer, with the JAX package's contraction axes and
names: ``int8``/``fp8`` make per-out-channel symmetric pairs (``*_q`` and
``*_scale``), ``mxfp4``/``mxfp8`` packed microscaling pairs (``*_packed``
and ``*_scale``, the contraction dim moved last). The embedding, the
norms, the MoE router and the shared experts stay float.

The quantizers run where the tensors lie, so a state dict on the card is
quantized there; each kernel's fp32 temporaries go before the next
kernel's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from .mx_layers import mx_quantizer
from .quantization_utils import QuantizedDtype, div_exact

# per-layer name suffix -> (the quantized pair's base name, contraction
# axis of the kernel as one layer holds it)
_KERNELS = {
    "attn.qkv.q_kernel": ("attn.qkv.q_kernel", 0),      # [H, N*D]
    "attn.qkv.k_kernel": ("attn.qkv.k_kernel", 0),      # [H, KV*D]
    "attn.qkv.v_kernel": ("attn.qkv.v_kernel", 0),
    "attn.o_proj.kernel": ("attn.o_proj.kernel", 0),    # [N*D, H]
    "mlp.gate_up_kernel": ("mlp.gate_up", 0),           # [H, 2, I]
    "mlp.down.kernel": ("mlp.down.kernel", 0),          # [I, H]
    "moe.experts.gate_up": ("moe.experts.gate_up", 1),  # [E, H, 2, I]
    "moe.experts.down": ("moe.experts.down", 1),        # [E, I, H]
}
_LM_HEAD = ("lm_head.kernel", ("lm_head.kernel", 0))    # [H, V]


def params_are_quantized(params: Mapping[str, torch.Tensor]) -> bool:
    """Whether the state dict already holds quantized kernels (a name ending
    in ``_q`` or ``_packed``)."""
    return any(k.endswith(("_q", "_packed")) for k in params)


def symmetric_pair(w: torch.Tensor, contract_axis: int,
                   qdt: QuantizedDtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel symmetric quantization along ``contract_axis``:
    ``(q of w's shape, fp32 scale of w's shape without that axis)``. An
    all-zero channel keeps scale 1 and gives exact zeros back."""
    q = w.to(torch.float32, copy=True)
    amax = q.abs().amax(dim=contract_axis)
    scale = div_exact(amax, qdt.max_value)
    scale = torch.where(amax == 0.0, torch.ones_like(scale), scale)
    q.div_(scale.unsqueeze(contract_axis))
    if qdt == QuantizedDtype.INT8:
        return q.round_().clamp_(-127, 127).to(torch.int8), scale
    return q.to(qdt.torch_dtype), scale


def mx_pair(w: torch.Tensor, contract_axis: int, fmt: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack ``w`` into MX ``fmt`` (``"fp4"``/``"fp8"``) with the contraction
    axis moved last."""
    return mx_quantizer(fmt)(torch.movedim(w, contract_axis, -1))


def _rule(name: str) -> Optional[Tuple[str, str, int]]:
    """``(prefix, base, axis)`` when ``name`` is a kernel the tiers
    quantize."""
    if name == _LM_HEAD[0]:
        return ("",) + _LM_HEAD[1]
    for suffix, (base, axis) in _KERNELS.items():
        if name.endswith("." + suffix):
            return name[:-len(suffix)], base, axis
    return None


def quantize_params_for_serving(cfg, params: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """Quantize a float state dict to ``cfg.weight_quant``'s format. Every
    projection kernel becomes its quantized pair; the other tensors pass
    through. A dict that is already quantized comes back unchanged (the
    same object)."""
    fmt = getattr(cfg, "weight_quant", None)
    if fmt is None:
        raise ValueError(
            "quantize_params_for_serving needs cfg.weight_quant set")
    if params_are_quantized(params):
        return params
    mx = fmt.startswith("mx")
    qdt = None if mx else (QuantizedDtype.INT8 if fmt == "int8"
                           else QuantizedDtype.FP8E4M3)
    out: Dict[str, torch.Tensor] = {}
    for name, w in params.items():
        rule = _rule(name)
        if rule is None:
            out[name] = w
            continue
        prefix, base, axis = rule
        if mx:
            packed, scale = mx_pair(w, axis, fmt[2:])
            out[f"{prefix}{base}_packed"] = packed
        else:
            packed, scale = symmetric_pair(w, axis, qdt)
            out[f"{prefix}{base}_q"] = packed
        out[f"{prefix}{base}_scale"] = scale
    return out
