"""Quantize and dequantize primitives (counterpart of
``neuronx_distributed_tpu/quantization/quantization_utils.py``).

Symmetric per-tensor, per-channel and per-block quantization to int8 or
fp8, with ``x ≈ q · scale``. The codes and scales equal the JAX package's
bit for bit: the values are scaled in fp32, int8 rounds half to even and
clips to ±127, fp8 clips to the format's largest value before the cast.
Dequantizing multiplies in fp32 and rounds to the target dtype once.

Two behaviours of JAX on the CPU are reproduced where they decide codes:

* XLA's CPU arithmetic flushes denormals, in its inputs and its results.
  :func:`quantize` reads its input and makes its scale through
  :func:`flush_denormals`, so a row of denormals gets scale 1 and zero codes
  as in JAX, and the dequantizers flush their scales, so a block whose
  scale is a denormal (a maximum below about 1e-37) gives zeros. A product
  of a normal scale and a small fp8 or fp4 code that falls below fp32's
  normal range stays a denormal here where XLA gives 0: an absolute
  difference under 1.2e-38, left so that serving makes no extra pass over
  its weights.
* ``.to(torch.float8_e4m3fn)`` saturates at ±448, where JAX's cast gives
  NaN for every ``|x| > 464`` (the values that round past 448).
  :func:`direct_cast_quantize` reproduces the NaN.

And one of CUDA's: a tensor divided by a Python number is multiplied by the
number's reciprocal, which can differ from the quotient in the last bit, so
every such division here goes through :func:`div_exact`.
"""

from __future__ import annotations

from enum import Enum
from typing import Tuple

import torch


class QuantizationType(str, Enum):
    PER_TENSOR_SYMMETRIC = "per_tensor_symmetric"
    PER_CHANNEL_SYMMETRIC = "per_channel_symmetric"
    # one scale per (contraction-dim block, out-channel)
    PER_BLOCK_SYMMETRIC = "per_block_symmetric"


class QuantizedDtype(str, Enum):
    INT8 = "int8"
    FP8E4M3 = "f8e4m3"
    FP8E5M2 = "f8e5m2"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {QuantizedDtype.INT8: torch.int8,
                QuantizedDtype.FP8E4M3: torch.float8_e4m3fn,
                QuantizedDtype.FP8E5M2: torch.float8_e5m2}[self]

    @property
    def max_value(self) -> float:
        return {QuantizedDtype.INT8: 127.0,
                QuantizedDtype.FP8E4M3: 448.0,
                QuantizedDtype.FP8E5M2: 57344.0}[self]


# e4m3fn has no infinity: an fp32 value past the midpoint between 448 and
# the next step (480) rounds to NaN in JAX's cast
_E4M3_NAN_ABOVE = 464.0
_FP32_TINY = torch.finfo(torch.float32).tiny


def flush_denormals(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its fp32 denormals made zeros of the same sign, as XLA's
    CPU arithmetic treats them."""
    return t * (t.abs() >= _FP32_TINY)


def div_exact(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded as numpy rounds it, on any device: the divisor is a
    tensor on ``t``'s device, which CUDA divides by (a Python number it
    would multiply by ``1 / c``)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def scaled_to(q: torch.Tensor, scale: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``q · scale`` in fp32, rounded to ``dtype`` once: the dequantize of
    every format. Integer or fp32 ``q`` takes one pass (the product is
    made in fp32 and rounded as it is stored); fp8 codes, which torch does
    not promote, are widened to fp32 first. ``scale`` is flushed as XLA
    reads it."""
    if q.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        q = q.float()
    scale = flush_denormals(scale)
    out = torch.empty(torch.broadcast_shapes(q.shape, scale.shape),
                      dtype=dtype, device=q.device)
    return torch.mul(q, scale, out=out)


def abs_max(x: torch.Tensor, dim=None, keepdim: bool = False
            ) -> torch.Tensor:
    """``max |x|`` in fp32, over ``dim`` (all dims when ``None``)."""
    a = x.float().abs()
    if dim is None:
        return a.amax()
    return a.amax(dim=dim, keepdim=keepdim)


def cast_to(q: torch.Tensor, dtype: QuantizedDtype) -> torch.Tensor:
    """Round (int8, half to even), clip and cast values already scaled."""
    if dtype == QuantizedDtype.INT8:
        return torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    return torch.clamp(q, -dtype.max_value, dtype.max_value).to(
        dtype.torch_dtype)


def _scale_of(amax: torch.Tensor, dtype: QuantizedDtype) -> torch.Tensor:
    """``amax / max_value`` in fp32 (flushed); a group whose scale is zero
    keeps scale 1."""
    scale = flush_denormals(div_exact(amax, dtype.max_value))
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def quantize(x: torch.Tensor, dtype: QuantizedDtype = QuantizedDtype.INT8,
             qtype: QuantizationType = (
                 QuantizationType.PER_CHANNEL_SYMMETRIC),
             channel_axis: int = -1, block_size: int = 128,
             block_axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization; returns ``(q, scale fp32)``.

    Per channel, ``scale`` keeps every dim (size 1 but ``channel_axis``);
    per tensor it is a scalar; per block (2-D kernels only) it is ``[n/B,
    out]``, one scale per ``block_size`` segment of ``block_axis`` (the
    contraction dim) per other-dim element; dequantize that with
    :func:`dequantize_blockwise`."""
    if qtype == QuantizationType.PER_BLOCK_SYMMETRIC:
        if x.dim() != 2:
            raise ValueError("per-block quantisation expects a 2-D kernel, "
                             f"got {tuple(x.shape)}")
        ba = block_axis % 2
        n = x.shape[ba]
        if n % block_size != 0:
            raise ValueError(f"dim {ba} size {n} not divisible by "
                             f"block_size {block_size}")
        xb = torch.movedim(flush_denormals(x.float()), ba, 0).reshape(
            n // block_size, block_size, -1)
        amax = abs_max(xb, dim=1, keepdim=True)            # [nb, 1, out]
        scale = torch.where(amax == 0, torch.ones_like(amax),
                            flush_denormals(div_exact(amax,
                                                      dtype.max_value)))
        q = torch.movedim(cast_to(xb / scale, dtype).reshape(n, -1), 0, ba)
        return q, scale[:, 0]
    x = flush_denormals(x.float())
    if qtype == QuantizationType.PER_TENSOR_SYMMETRIC:
        amax = abs_max(x)
    else:
        ca = channel_axis % x.dim()
        amax = abs_max(x, dim=[i for i in range(x.dim()) if i != ca],
                       keepdim=True)
    scale = _scale_of(amax, dtype)
    return cast_to(x / scale, dtype), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(q · scale)`` in fp32, rounded to ``dtype`` once
    (:func:`scaled_to`)."""
    return scaled_to(q, scale, dtype)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16,
                         block_axis: int = 0) -> torch.Tensor:
    """Inverse of per-block :func:`quantize`: ``q [in, out]`` with ``scale
    [in/B, out]``."""
    ba = block_axis % q.dim()
    qb = torch.movedim(q, ba, 0)
    nb = scale.shape[0]
    blocks = scaled_to(qb.reshape(nb, qb.shape[0] // nb, -1),
                       scale[:, None], dtype)
    return torch.movedim(blocks.reshape(qb.shape), 0, ba)


def direct_cast_quantize(x: torch.Tensor,
                         dtype: QuantizedDtype) -> torch.Tensor:
    """The scale-free cast, with JAX's overflow: ``float8_e4m3fn`` gives NaN
    past ±464 (and for ±inf) where torch's cast saturates."""
    q = x.to(dtype.torch_dtype)
    if dtype == QuantizedDtype.FP8E4M3:
        # the NaN keeps x's sign: byte 0x7f, or 0xff below zero
        x32 = x.float()
        nan = torch.where(torch.signbit(x32), 0xFF, 0x7F).to(torch.uint8)
        bits = torch.where(x32.abs() > _E4M3_NAN_ABOVE, nan,
                           q.view(torch.uint8))
        q = bits.view(dtype.torch_dtype)
    return q
