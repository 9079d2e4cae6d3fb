"""Shared wire codec for compressed payloads (counterpart of
``neuronx_distributed_tpu/parallel/wire_codec.py``).

* **Blockwise symmetric quantization**: a payload is flattened into
  ``block_size``-element blocks, each block sent as int8 (or
  float8_e4m3fn) values plus one fp32 scale ``amax / qmax``. All-zero
  blocks get scale 1.0 so their round trip is exact. int8 at the default
  256-element blocks moves ``1 + 4/256 ≈ 1.016`` bytes per element, a
  ~3.94x wire reduction against fp32.

* **Scale layout**: scales ride beside the quantized values with the same
  leading block structure (``q: [..., nb, b]``, ``scales: [..., nb, 1]``),
  so the receiver dequantizes positionally.

The functions take tensors on any device and give the JAX package's codes
and scales bit for bit. Three behaviours decide that:

* XLA's CPU arithmetic flushes denormals in its inputs and results. The
  quantizer reads its input through :func:`flush_denormals` (a block of
  denormals has ``amax == 0``: scale 1 and zero codes) and flushes the
  scale, so a block whose ``amax / qmax`` falls below fp32's normal range
  gets scale 0, where every code is what XLA's division by zero gives: int8
  ±127 for ±x and 0 for 0/0; fp8 NaN (byte ``0x7f`` for x > 0, else
  ``0xff``, the sign of x86's default NaN). The dequantizer flushes its
  products.
* CUDA divides a tensor by a Python number by multiplying by its
  reciprocal, so ``amax / qmax`` goes through :func:`div_exact`.
* int8 rounds half to even (``torch.round``, as ``jnp.round``); fp8 is the
  plain cast (``y`` stays within 448 by a few ulps when the scale is
  normal, which both casts round to 448).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..quantization.quantization_utils import div_exact, flush_denormals

#: Largest representable magnitude of each wire dtype (int8 symmetric;
#: float8_e4m3fn max finite = 448).
_QMAX = {"int8": 127.0, "fp8": 448.0}

_WIRE_DTYPES = ("fp32", "int8", "fp8")


def wire_bytes_per_element(dtype: str, block_size: int = 256) -> float:
    """Static wire accounting for one payload element at ``dtype``: 1
    quantized byte + one fp32 scale per block, 4 bytes unquantized.
    :attr:`CompressionConfig.wire_bytes_per_element` delegates here."""
    if dtype not in _WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {dtype!r}")
    if dtype == "fp32":
        return 4.0
    return 1.0 + 4.0 / block_size


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """How a compressed payload moves bytes.

    ``dtype``: wire dtype — ``"fp32"`` (no quantization), ``"int8"``
    (blockwise symmetric int8) or ``"fp8"`` (float8_e4m3fn).
    ``block_size``: elements per quantization block (one fp32 scale each).
    ``hierarchical`` and ``error_feedback`` are the compressed collectives'
    options, kept so that a config means the same in both packages."""

    dtype: str = "int8"
    block_size: int = 256
    hierarchical: bool = False
    error_feedback: bool = True

    def __post_init__(self) -> None:
        if self.dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"wire dtype must be one of {_WIRE_DTYPES}, got "
                f"{self.dtype!r}")
        if not isinstance(self.block_size, int) or self.block_size < 1:
            raise ValueError(
                f"block_size must be a positive int, got {self.block_size!r}")

    @property
    def quantized(self) -> bool:
        return self.dtype != "fp32"

    @property
    def wire_bytes_per_element(self) -> float:
        """Payload bytes per element including the per-block scales
        (1 fp32 scale per ``block_size`` elements)."""
        return wire_bytes_per_element(self.dtype, self.block_size)

    @property
    def ratio(self) -> float:
        """Wire-compression ratio vs fp32 (same payload shape)."""
        return 4.0 / self.wire_bytes_per_element


# --------------------------------------------------------------------------
# Blockwise quantization
# --------------------------------------------------------------------------

def _quantize(x: torch.Tensor, dtype: str
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize ``x`` (fp32, blocks along the last dim) → ``(q, scales)``;
    identity ``(x, None)`` for fp32."""
    if dtype == "fp32":
        return x, None
    qmax = _QMAX[dtype]
    x = flush_denormals(x)
    amax = x.abs().amax(dim=-1, keepdim=True)
    # all-zero blocks get scale 1.0: q is exactly 0, dequant exact
    scale = torch.where(amax > 0, flush_denormals(div_exact(amax, qmax)),
                        torch.ones_like(amax))
    y = x / scale
    if dtype == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax)
        # 0/0 under a flushed scale: XLA converts the NaN to 0
        return torch.where(torch.isnan(q), 0.0, q).to(torch.int8), scale
    bits = y.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(x > 0, 0x7F, 0xFF).to(torch.uint8)
    bits = torch.where(scale == 0, nan, bits)
    return bits.view(torch.float8_e4m3fn), scale


def _dequantize(q: torch.Tensor, scale: Optional[torch.Tensor],
                dtype: str) -> torch.Tensor:
    if dtype == "fp32":
        return q
    return flush_denormals(q.float() * scale)


def quantize_blockwise(x: torch.Tensor, config: CompressionConfig
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """Flatten + zero-pad ``x`` into ``[n_blocks, block_size]`` and quantize.
    Returns ``(q, scales, n_elements)``; for fp32 configs ``q`` is the
    padded fp32 blocks and ``scales`` is None."""
    flat = x.float().reshape(-1)
    m = flat.shape[0]
    b = config.block_size
    nb = max(1, -(-m // b))
    pad = nb * b - m
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = _quantize(flat.reshape(nb, b), config.dtype)
    return q, s, m


def dequantize_blockwise(q: torch.Tensor, scales: Optional[torch.Tensor],
                         shape: Sequence[int],
                         config: CompressionConfig) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (drops the padding)."""
    flat = _dequantize(q, scales, config.dtype).reshape(-1)
    n = 1
    for d in shape:
        n *= int(d)
    return flat[:n].reshape(tuple(int(d) for d in shape))


def quantize_dequantize(x: torch.Tensor,
                        config: CompressionConfig) -> torch.Tensor:
    """The round-trip operator ``DQ(Q(x))``: what the receiving side
    reconstructs from this payload."""
    if not config.quantized:
        return x
    q, s, _ = quantize_blockwise(x, config)
    return dequantize_blockwise(q, s, x.shape, config).to(x.dtype)


# --------------------------------------------------------------------------
# Ring-payload codec (fixed tensor layout, no flattening)
# --------------------------------------------------------------------------

def encode_payload(x: torch.Tensor, config: Optional[CompressionConfig]
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize a payload in its own layout (no flatten, no pad): the
    trailing dim splits into whole ``block_size`` blocks when it divides
    evenly, else the whole trailing dim is one block. Returns ``(q,
    scales)`` with ``scales`` broadcastable against the blocked view;
    identity ``(x, None)`` for fp32 / None configs."""
    if config is None or not config.quantized:
        return x, None
    d = x.shape[-1] if x.dim() else 1
    b = config.block_size
    if d % b == 0 and d >= b:
        blocked = x.float().reshape(tuple(x.shape[:-1]) + (d // b, b))
        q, s = _quantize(blocked, config.dtype)
        return q.reshape(x.shape), s
    return _quantize(x.float(), config.dtype)


def decode_payload(q: torch.Tensor, scales: Optional[torch.Tensor],
                   config: Optional[CompressionConfig],
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`encode_payload`; fp32 payloads pass through."""
    if config is None or not config.quantized or scales is None:
        return q
    d = q.shape[-1] if q.dim() else 1
    b = config.block_size
    if d % b == 0 and d >= b:
        blocked = q.reshape(tuple(q.shape[:-1]) + (d // b, b))
        return _dequantize(blocked, scales, config.dtype) \
            .reshape(q.shape).to(out_dtype)
    return _dequantize(q, scales, config.dtype).to(out_dtype)


# --------------------------------------------------------------------------
# Wire-integrity spot checks
# --------------------------------------------------------------------------

def spot_check_roundtrip(x: torch.Tensor,
                         config: Optional[CompressionConfig],
                         fingerprint_fn, corrupt=None,
                         out_dtype: torch.dtype = torch.float32):
    """One sampled hop with integrity accounting: encode ``x``, fingerprint
    the encoded payload sender-side, (optionally) corrupt it in transit,
    fingerprint receiver-side, decode. Returns ``(decoded, fp_tx,
    fp_rx)``; ``fp_tx != fp_rx`` means the bytes that arrived are not the
    bytes that were sent, whatever the codec's loss.
    ``fingerprint_fn(q, scales)`` and ``corrupt(q, scales) -> (q, scales)``
    are the caller's."""
    q, s = encode_payload(x, config)
    fp_tx = fingerprint_fn(q, s)
    if corrupt is not None:
        q, s = corrupt(q, s)
    fp_rx = fingerprint_fn(q, s)
    return decode_payload(q, s, config, out_dtype), fp_tx, fp_rx


# --------------------------------------------------------------------------
# Exact byte accounting
# --------------------------------------------------------------------------

def blockwise_wire_bytes(n_elements: int,
                         config: Optional[CompressionConfig]) -> float:
    """Bytes shipped for an ``n_elements`` payload through
    :func:`quantize_blockwise`: padded int8/fp8 values + one fp32 scale per
    block; ``4 * n`` for fp32/None configs."""
    n = int(n_elements)
    if config is None or not config.quantized:
        return 4.0 * n
    b = config.block_size
    nb = max(1, -(-n // b))
    return float(nb * b) + 4.0 * nb


def payload_wire_bytes(shape: Sequence[int],
                       config: Optional[CompressionConfig]) -> float:
    """Bytes shipped for a payload of ``shape`` through
    :func:`encode_payload` (trailing-dim blocks; the whole trailing dim is
    one block when ``block_size`` doesn't divide it)."""
    dims = tuple(int(d) for d in shape)
    n = 1
    for d in dims:
        n *= d
    if config is None or not config.quantized:
        return 4.0 * n
    d = dims[-1] if dims else 1
    b = config.block_size
    n_scales = (n // b) if (d % b == 0 and d >= b) else (n // max(d, 1))
    return float(n) + 4.0 * max(1, n_scales)
