"""Weight quantization (counterpart of ``neuronx_distributed_tpu/
quantization/``): int8/fp8 quantizers and MX (microscaling) formats, the
quantized linears and expert banks, and the serving tiers' converter."""

from .microscaling import (MX_BLOCK, mx_dequantize_fp4, mx_dequantize_fp8,
                           mx_quantize_fp4, mx_quantize_fp8)
from .mx_layers import (MXExpertMLPs, MXGQAQKVColumnParallelLinear,
                        MXQuantizedColumnParallel, MXQuantizedRowParallel,
                        mx_pack_expert_params, mx_pack_linear)
from .quantization_layers import (QuantizedColumnParallel,
                                  QuantizedExpertMLPs,
                                  QuantizedGQAQKVColumnParallelLinear,
                                  QuantizedRowParallel,
                                  quantize_expert_params)
from .quantize import convert
# after the submodule of the same name: ``quantization.quantize`` is the
# function, as in the JAX package
from .quantization_utils import (QuantizationType, QuantizedDtype,
                                 dequantize, dequantize_blockwise,
                                 direct_cast_quantize, quantize)
from .serving import params_are_quantized, quantize_params_for_serving

__all__ = [
    "MX_BLOCK", "mx_dequantize_fp4", "mx_dequantize_fp8", "mx_quantize_fp4",
    "mx_quantize_fp8", "MXExpertMLPs", "MXGQAQKVColumnParallelLinear",
    "MXQuantizedColumnParallel", "MXQuantizedRowParallel",
    "mx_pack_expert_params", "mx_pack_linear", "QuantizedColumnParallel",
    "QuantizedExpertMLPs", "QuantizedGQAQKVColumnParallelLinear",
    "QuantizedRowParallel", "quantize_expert_params", "QuantizationType",
    "QuantizedDtype", "dequantize", "dequantize_blockwise",
    "direct_cast_quantize", "quantize", "convert", "params_are_quantized",
    "quantize_params_for_serving"]
