"""Float-to-quantized state-dict conversion (counterpart of
``neuronx_distributed_tpu/quantization/quantize.py``): every 2-D tensor
named ``kernel`` (the last part of its name) becomes ``kernel_q`` and a
flat ``kernel_scale``, the names the quantized linears hold."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from .quantization_utils import QuantizationType, QuantizedDtype, quantize


def convert(params: Mapping[str, torch.Tensor],
            dtype: QuantizedDtype = QuantizedDtype.INT8,
            qtype: QuantizationType = QuantizationType.PER_CHANNEL_SYMMETRIC,
            kernel_keys: Sequence[str] = ("kernel",)
            ) -> Dict[str, torch.Tensor]:
    """Quantize every ``kernel_keys`` tensor of two dims along its last
    (out-channel) axis; the other tensors pass through."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in params.items():
        prefix, _, key = name.rpartition(".")
        if key in kernel_keys and v.dim() == 2:
            q, scale = quantize(v, dtype, qtype, channel_axis=-1)
            stem = f"{prefix}.{key}" if prefix else key
            out[f"{stem}_q"] = q
            out[f"{stem}_scale"] = scale.reshape(-1)
        else:
            out[name] = v
    return out
