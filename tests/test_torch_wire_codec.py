"""The PyTorch port's wire codec against the JAX package's
(``neuronx_distributed_tpu/parallel/wire_codec.py``): codes and scales bit
for bit for int8, fp8 and fp32 at block sizes 1, 7 and 256, with padding,
all-zero blocks, ties at .5, values that round to ±448 and blocks whose
``amax`` (or ``amax / qmax``) lies below fp32's normal range; the
dequantized values bit for bit; the in-layout payload codec, the spot
check and the byte formulas."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuronx_distributed_tpu.parallel import wire_codec as jw
from neuronx_distributed_tpu_torch.parallel import wire_codec as tw

DTYPES = ("int8", "fp8", "fp32")


def _bits(a):
    """Raw bytes of a codec output (fp8 and fp32 by their bit patterns, so
    that NaN codes compare too)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _cases():
    rng = np.random.RandomState(0)
    out = {}
    for n in (1, 5, 300, 1000):
        scale = np.exp(rng.uniform(-20, 20))
        out[f"randn{n}"] = (rng.randn(n) * scale).astype(np.float32)
    # ties at .5 once scaled: amax 127 makes the scale exactly 1
    out["ties"] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.0, 3.5],
                           np.float32)
    # a value 2 ulp past the block's amax / scale rounds to ±448 in fp8
    out["fp8_edge"] = np.array([448.0, np.nextafter(np.float32(447.99),
                                                     np.float32(500)),
                                -448.0, 1.0, 0.25, -3.0, 0.0],
                               np.float32)
    out["zeros"] = np.zeros(9, np.float32)
    # amax a denormal (flushed: scale 1, zero codes) and amax normal whose
    # amax / qmax is a denormal (flushed: scale 0)
    out["denormal"] = np.array([1e-39, -5e-40, 0, 0, 1e-37, 3e-38, -1e-37,
                                0, 1e-36, 1e-38, 0, -0.0], np.float32)
    return out


CASES = _cases()


def _assert_same_values(got, want):
    """Bit for bit, except that NaNs (the dequantized codes of a block
    whose scale flushed to 0) need only be NaN in both: their payload bits
    are whatever the fp8-to-fp32 widening of each library gives."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("block", [1, 7, 256, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_codes_and_scales_match_jax_bit_for_bit(case, dtype,
                                                          block):
    x = CASES[case]
    jc = jw.CompressionConfig(dtype=dtype, block_size=block)
    tc = tw.CompressionConfig(dtype=dtype, block_size=block)
    q1, s1, n1 = jw.quantize_blockwise(jnp.asarray(x), jc)
    q2, s2, n2 = tw.quantize_blockwise(torch.from_numpy(x), tc)
    assert n1 == n2 == x.size
    assert tuple(q2.shape) == tuple(q1.shape)
    np.testing.assert_array_equal(_bits(q2), _bits(q1))
    if dtype == "fp32":
        assert s1 is None and s2 is None
    else:
        assert s2.dtype == torch.float32
        np.testing.assert_array_equal(_bits(s2), _bits(s1))
    d1 = jw.dequantize_blockwise(q1, s1, x.shape, jc)
    d2 = tw.dequantize_blockwise(q2, s2, x.shape, tc)
    _assert_same_values(d2, d1)


def test_denormal_blocks_decide_their_scale_as_xla_does():
    x = torch.tensor([1e-39, -5e-40, 0, 0, 1e-37, 3e-38, -1e-37, 0])
    q, s, _ = tw.quantize_blockwise(x, tw.CompressionConfig("int8", 4))
    assert s[:, 0].tolist() == [1.0, 0.0]
    assert q.tolist() == [[0, 0, 0, 0], [127, 127, -127, 0]]
    q, s, _ = tw.quantize_blockwise(x, tw.CompressionConfig("fp8", 4))
    assert q.view(torch.uint8)[1].tolist() == [0x7F, 0x7F, 0xFF, 0xFF]


def test_bf16_input_is_widened_exactly():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 50).astype(np.float32)).bfloat16()
    for dtype in ("int8", "fp8"):
        cfg = tw.CompressionConfig(dtype=dtype, block_size=16)
        q1, s1, _ = tw.quantize_blockwise(x, cfg)
        q2, s2, _ = tw.quantize_blockwise(x.float(), cfg)
        assert torch.equal(q1.view(torch.uint8), q2.view(torch.uint8))
        assert torch.equal(s1, s2)
        rt = tw.quantize_dequantize(x, cfg)
        assert rt.dtype == torch.bfloat16 and rt.shape == x.shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,block", [((4, 64), 32), ((3, 10), 4),
                                         ((2, 3, 256), 256), ((7,), 8),
                                         ((5, 1), 4)])
def test_payload_codec_matches_jax(dtype, shape, block):
    rng = np.random.RandomState(2)
    x = np.asarray(rng.randn(*shape), np.float32)
    jc = jw.CompressionConfig(dtype=dtype, block_size=block)
    tc = tw.CompressionConfig(dtype=dtype, block_size=block)
    q1, s1 = jw.encode_payload(jnp.asarray(x), jc)
    q2, s2 = tw.encode_payload(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(_bits(q2), _bits(q1))
    assert (s1 is None) == (s2 is None)
    if s1 is not None:
        assert tuple(s2.shape) == tuple(s1.shape)
        np.testing.assert_array_equal(_bits(s2), _bits(s1))
    d1 = jw.decode_payload(q1, s1, jc)
    d2 = tw.decode_payload(q2, s2, tc)
    _assert_same_values(d2, d1)
    assert tw.payload_wire_bytes(shape, tc) == jw.payload_wire_bytes(
        shape, jc)


def test_quantize_dequantize_and_none_configs_follow_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 33).astype(np.float32)
    for dtype in DTYPES:
        jc = jw.CompressionConfig(dtype=dtype, block_size=16)
        tc = tw.CompressionConfig(dtype=dtype, block_size=16)
        np.testing.assert_array_equal(
            tw.quantize_dequantize(torch.from_numpy(x), tc).numpy(),
            np.asarray(jw.quantize_dequantize(jnp.asarray(x), jc)))
    t = torch.from_numpy(x)
    q, s = tw.encode_payload(t, None)
    assert q is t and s is None
    assert tw.decode_payload(t, None, None) is t


def test_spot_check_roundtrip_sees_corruption_not_quantization():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 32).astype(np.float32))
    cfg = tw.CompressionConfig(dtype="int8", block_size=32)

    def fp(q, s):
        return int(q.to(torch.int64).sum()) * 31 + int(
            s.view(torch.int32).to(torch.int64).sum())

    def flip(q, s):
        q = q.clone()
        q.view(-1)[0] ^= 1
        return q, s

    dec, tx, rx = tw.spot_check_roundtrip(x, cfg, fp)
    assert tx == rx
    assert torch.equal(dec, tw.decode_payload(*tw.encode_payload(x, cfg),
                                              cfg))
    _, tx, rx = tw.spot_check_roundtrip(x, cfg, fp, corrupt=flip)
    assert tx != rx


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_byte_formulas_match_jax(n, dtype):
    for b in (1, 7, 256):
        jc = jw.CompressionConfig(dtype=dtype, block_size=b)
        tc = tw.CompressionConfig(dtype=dtype, block_size=b)
        assert tw.blockwise_wire_bytes(n, tc) == jw.blockwise_wire_bytes(
            n, jc)
        assert tw.wire_bytes_per_element(dtype, b) == \
            jw.wire_bytes_per_element(dtype, b)
        assert tc.wire_bytes_per_element == jc.wire_bytes_per_element
        assert tc.ratio == jc.ratio and tc.quantized == jc.quantized
    assert tw.blockwise_wire_bytes(n, None) == jw.blockwise_wire_bytes(
        n, None)
    if n and dtype != "fp32":
        # the bytes a quantized block payload ships, counted from the codec
        cfg = tw.CompressionConfig(dtype=dtype, block_size=7)
        q, s, _ = tw.quantize_blockwise(torch.zeros(n), cfg)
        assert tw.blockwise_wire_bytes(n, cfg) == (
            q.numel() * q.element_size() + s.numel() * 4)


def test_config_validation_matches_jax():
    for mod in (jw, tw):
        with pytest.raises(ValueError, match="wire dtype"):
            mod.CompressionConfig(dtype="int4")
        with pytest.raises(ValueError, match="block_size"):
            mod.CompressionConfig(block_size=0)
        with pytest.raises(ValueError, match="unknown wire dtype"):
            mod.wire_bytes_per_element("bf16")
