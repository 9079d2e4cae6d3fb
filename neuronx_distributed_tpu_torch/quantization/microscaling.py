"""MX (microscaling) weight formats (counterpart of
``neuronx_distributed_tpu/quantization/microscaling.py``): fp4 (E2M1) or
fp8 (E4M3) elements in blocks of 32 along the last dim, each block with one
power-of-two (E8M0) scale.

fp4 codes go two to a byte, the even element in the low nibble; a code is
``sign << 3 | magnitude index`` into the E2M1 grid. The quantizers take
tensors on any device, so the card quantizes a layer where it lies, and
give JAX's codes, bytes and scales bit for bit:

* the scale is ``2 ** ceil(log2(amax / 6))`` (``/ 448`` for fp8), with the
  logarithm rounded to fp32 as numpy's is. It is taken in fp64 and then
  rounded to fp32, so a device ``log2f`` that is an ulp off cannot move the
  ceiling at a power of two, and the power of two is written as its bits;
* the fp4 magnitude is JAX's ``argmin`` over the grid, which keeps the
  lower point on a tie (0.25 -> 0, 2.5 -> 2, 5 -> 4), not
  round-to-nearest-even. It is found as the count of grid midpoints below
  the magnitude (``bucketize``), which is that argmin: next to a midpoint
  both distances to the neighbouring grid points are exact in fp32, so the
  argmin's comparison is the comparison with the midpoint, a tie included;
  ``tests/test_torch_quantization.py`` holds the two to each other over
  every fp32 value near each midpoint.

The quantizers run over chunks of rows, so the fp32 temporaries of a large
tensor never exist whole. The dequantizers flush
a denormal scale to zero, as XLA's CPU arithmetic does
(:func:`.quantization_utils.flush_denormals`).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .quantization_utils import div_exact, scaled_to

MX_BLOCK = 32

# E2M1 magnitudes (the sign is bit 3 of the code)
FP4_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
# the value of each 4-bit code (code 8 is -0.0, as JAX's sign x magnitude)
_FP4_VALUES = FP4_GRID + tuple(-g for g in FP4_GRID)
# midpoints between neighbouring grid points
_FP4_MIDS = tuple((a + b) / 2 for a, b in zip(FP4_GRID, FP4_GRID[1:]))
_FP4_MAX = 6.0
_FP8_MAX = 448.0
# elements quantized at a time
_CHUNK = 1 << 24


def _block_scales(blocks: torch.Tensor, elem_max: float) -> torch.Tensor:
    """E8M0 scales ``[..., nb, 1]`` of fp32 ``blocks [..., nb, B]``; an
    all-zero block keeps scale 1."""
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    live = amax > 0
    ratio = div_exact(torch.where(live, amax, torch.ones_like(amax)),
                      elem_max)
    exp = torch.ceil(torch.log2(ratio.double()).float()).to(torch.int32)
    exp = torch.where(live, exp, torch.zeros_like(exp))
    return _pow2(exp)


def _pow2(exp: torch.Tensor) -> torch.Tensor:
    """``2 ** exp`` in fp32 from int32 ``exp``, made from its bits: exact on
    every device, denormals (down to 2^-149) and underflow to 0 included,
    as ``np.exp2`` gives them."""
    one = torch.ones_like(exp)
    normal = (exp + 127) << 23
    denormal = torch.where(exp >= -149,
                           one << torch.clamp(exp + 149, min=0, max=22),
                           torch.zeros_like(exp))
    return torch.where(exp >= -126, normal, denormal).view(torch.float32)


def _chunked(w: torch.Tensor, block_size: int, fn: Callable
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(rows [r, n] fp32)`` over chunks of rows of ``w`` seen as ``[R,
    n]``; the two outputs concatenated and given back ``w``'s leading
    dims."""
    n = w.shape[-1]
    if n % block_size != 0:
        raise ValueError(f"last dim {n} must be divisible by {block_size}")
    rows = w.reshape(-1, n)
    step = max(1, _CHUNK // n)
    parts = [fn(rows[r:r + step].float().contiguous(), block_size)
             for r in range(0, rows.shape[0], step)]
    lead = w.shape[:-1]
    return tuple(torch.cat([p[i] for p in parts]).reshape(
        *lead, parts[0][i].shape[-1]) for i in range(2))


def _fp4_rows(rows: torch.Tensor, block_size: int):
    r, n = rows.shape
    blocks = rows.reshape(r, n // block_size, block_size)
    scale = _block_scales(blocks, _FP4_MAX)
    scaled = blocks / scale
    mids = torch.tensor(_FP4_MIDS, dtype=torch.float32, device=rows.device)
    code = torch.bucketize(scaled.abs(), mids, out_int32=True)
    nibble = ((scaled < 0).to(torch.uint8) << 3) | code.to(torch.uint8)
    flat = nibble.reshape(r, n)
    return (flat[:, 1::2] << 4) | flat[:, 0::2], scale[..., 0]


def _fp8_rows(rows: torch.Tensor, block_size: int):
    r, n = rows.shape
    blocks = rows.reshape(r, n // block_size, block_size)
    scale = _block_scales(blocks, _FP8_MAX)
    q = (blocks / scale).to(torch.float8_e4m3fn)
    return q.reshape(r, n), scale[..., 0]


def mx_quantize_fp4(w: torch.Tensor, block_size: int = MX_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last dim: ``(packed uint8 [..., n/2], scales fp32
    [..., n/block])``."""
    return _chunked(w, block_size, _fp4_rows)


def mx_dequantize_fp4(packed: torch.Tensor, scales: torch.Tensor,
                      block_size: int = MX_BLOCK,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`mx_quantize_fp4`, multiplied in fp32 and rounded to
    ``dtype`` once."""
    codes = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)
    lut = torch.tensor(_FP4_VALUES, dtype=torch.float32,
                       device=packed.device)
    vals = lut[codes.int()].reshape(*codes.shape[:-1],
                                     codes.shape[-1] // block_size,
                                     block_size)
    return scaled_to(vals, scales[..., None], dtype).reshape(codes.shape)


def mx_quantize_fp8(w: torch.Tensor, block_size: int = MX_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MXFP8: ``(e4m3 elements [..., n], scales fp32 [..., n/block])``. The
    scaled values stay within ±448, where torch's cast and JAX's agree."""
    return _chunked(w, block_size, _fp8_rows)


def mx_dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                      block_size: int = MX_BLOCK,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    vals = q.reshape(*q.shape[:-1], q.shape[-1] // block_size, block_size)
    return scaled_to(vals, scales[..., None], dtype).reshape(q.shape)
