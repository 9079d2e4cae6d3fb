"""The PyTorch port's quantization primitives and layers against the JAX
package: int8/fp8 quantize in every mode, dequantize (plain and per
block), the scale-free cast with JAX's fp8 overflow, the MX (fp4, fp8)
quantizers with their boundaries (all-zero, denormal and mixed blocks,
scales at powers of two, the fp4 grid's ties), codes, packed bytes and
scales bit for bit; then the quantized and MX linears and expert banks,
the converters, and the checkpoint converter, within the fp32 tolerance.
No card is needed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.quantization import microscaling as jmx
from neuronx_distributed_tpu.quantization import mx_layers as jmxl
from neuronx_distributed_tpu.quantization import quantization_layers as jql
from neuronx_distributed_tpu.quantization import quantization_utils as jqu
from neuronx_distributed_tpu.quantization.quantize import convert as jconvert
from neuronx_distributed_tpu_torch.quantization import microscaling as tmx
from neuronx_distributed_tpu_torch.quantization import mx_layers as tmxl
from neuronx_distributed_tpu_torch.quantization import (
    quantization_layers as tql)
from neuronx_distributed_tpu_torch.quantization import (
    quantization_utils as tqu)
from neuronx_distributed_tpu_torch.quantization.quantize import (
    convert as tconvert)

_INTS = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16),
         4: (np.uint32, torch.int32)}


def _bits(a) -> np.ndarray:
    """The bytes of a torch tensor or a numpy/JAX array, as unsigned ints of
    the element's width (so fp8, bf16 and NaN payloads compare exactly)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(_INTS[a.element_size()][1]).numpy().view(
            _INTS[a.element_size()][0])
    a = np.asarray(a)
    return a.view(_INTS[a.dtype.itemsize][0])


def _same_bits(got, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, (tuple(got.shape), ref.shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _jdt(tdt):
    return jqu.QuantizedDtype(tdt.value)


@pytest.fixture(autouse=True)
def _mesh():
    ps.initialize_model_parallel()
    yield
    ps.destroy_model_parallel()


def _weights(seed=0, shape=(64, 48)):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    w *= np.exp(rng.randn(1, shape[1])).astype(np.float32)   # channel scales
    w[:, 5] = 0.0                                             # a zero channel
    return w


@pytest.mark.parametrize("dtype,qtype,kw", [
    (tqu.QuantizedDtype.INT8, "per_tensor_symmetric", {}),
    (tqu.QuantizedDtype.INT8, "per_channel_symmetric", {}),
    (tqu.QuantizedDtype.INT8, "per_channel_symmetric", dict(channel_axis=0)),
    (tqu.QuantizedDtype.FP8E4M3, "per_channel_symmetric", {}),
    (tqu.QuantizedDtype.FP8E4M3, "per_tensor_symmetric", {}),
    (tqu.QuantizedDtype.FP8E5M2, "per_channel_symmetric", {}),
    (tqu.QuantizedDtype.INT8, "per_block_symmetric", dict(block_size=16)),
    (tqu.QuantizedDtype.FP8E4M3, "per_block_symmetric",
     dict(block_size=8, block_axis=1)),
])
def test_quantize_and_dequantize_are_jax_bit_for_bit(dtype, qtype, kw):
    w = _weights()
    jq, js = jqu.quantize(jnp.asarray(w), _jdt(dtype),
                          jqu.QuantizationType(qtype), **kw)
    tq, ts = tqu.quantize(torch.from_numpy(w), dtype,
                          tqu.QuantizationType(qtype), **kw)
    assert tq.dtype == dtype.torch_dtype and ts.dtype == torch.float32
    _same_bits(tq, jq)
    _same_bits(ts, js)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        if qtype == "per_block_symmetric":
            ba = kw.get("block_axis", 0)
            ref = jqu.dequantize_blockwise(jq, js, jdt, block_axis=ba)
            got = tqu.dequantize_blockwise(tq, ts, tdt, block_axis=ba)
        else:
            ref = jqu.dequantize(jq, js, jdt)
            got = tqu.dequantize(tq, ts, tdt)
        assert got.dtype == tdt
        _same_bits(got, ref)


def test_per_block_rejects_what_jax_rejects():
    w = torch.zeros(48, 16)
    for bad, kw in ((torch.zeros(4, 4, 4), {}), (w, dict(block_size=32))):
        with pytest.raises(ValueError):
            tqu.quantize(bad, qtype=tqu.QuantizationType.PER_BLOCK_SYMMETRIC,
                         **kw)
        with pytest.raises(ValueError):
            jqu.quantize(jnp.asarray(bad.numpy()),
                         qtype=jqu.QuantizationType.PER_BLOCK_SYMMETRIC,
                         **kw)


@pytest.mark.parametrize("dtype", [tqu.QuantizedDtype.FP8E4M3,
                                   tqu.QuantizedDtype.FP8E5M2])
def test_direct_cast_keeps_jax_overflow(dtype):
    """``float8_e4m3fn`` has no infinity: JAX's cast gives NaN (keeping the
    sign) past ±464, where torch's own cast saturates at ±448; 449 and 464
    still round to 448. e5m2 overflows to ±inf in both."""
    x = np.array([449., 464., 465., 480., 1e4, -1e4, -465., -464., np.inf,
                  -np.inf, 0.3, -7.5, 448., 57344., 61440., 1e6],
                 np.float32)
    ref = jqu.direct_cast_quantize(jnp.asarray(x), _jdt(dtype))
    got = tqu.direct_cast_quantize(torch.from_numpy(x), dtype)
    _same_bits(got, ref)
    if dtype == tqu.QuantizedDtype.FP8E4M3:
        g = got.float().numpy()
        assert np.isnan(g[2:7]).all() and (g[:2] == 448).all()


def _mx(fmt):
    return ((jmx.mx_quantize_fp4, jmx.mx_dequantize_fp4, tmx.mx_quantize_fp4,
             tmx.mx_dequantize_fp4) if fmt == "fp4" else
            (jmx.mx_quantize_fp8, jmx.mx_dequantize_fp8, tmx.mx_quantize_fp8,
             tmx.mx_dequantize_fp8))


def _mx_same(fmt, w):
    jq, jd, tq, td = _mx(fmt)
    jp, js = jq(w)
    tp, ts = tq(torch.from_numpy(w))
    _same_bits(tp, jp)
    _same_bits(ts, js)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        _same_bits(td(tp, ts, dtype=tdt), jd(jp, js, dtype=jdt))
    return tp, ts


@pytest.mark.parametrize("fmt", ["fp4", "fp8"])
def test_mx_quantizers_are_jax_bit_for_bit(fmt):
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 6, 128) * np.exp(3 * rng.randn(3, 6, 1))).astype(
        np.float32)
    _mx_same(fmt, w)
    with pytest.raises(ValueError):
        _mx(fmt)[2](torch.zeros(4, 48))


@pytest.mark.parametrize("fmt", ["fp4", "fp8"])
def test_mx_zero_denormal_and_mixed_blocks(fmt):
    """The blocks of ``tests/test_weight_quant.py``: all-zero rows keep
    scale 1 and give exact zeros; denormal rows beside ordinary ones stay
    finite; all as JAX's, bit for bit."""
    _, js = _mx(fmt)[2](torch.zeros(4, 64))
    assert (js == 1.0).all()
    w = np.zeros((3, 64), np.float32)
    w[0] = 1e-42
    w[1] = np.linspace(-2.0, 2.0, 64)
    tp, ts = _mx_same(fmt, w)
    out = _mx(fmt)[3](tp, ts, dtype=torch.float32)
    assert torch.isfinite(out).all() and torch.isfinite(ts).all()
    assert (out[2] == 0).all()


def test_denormal_products_stay_within_the_smallest_normal():
    """The one divergence left from XLA's flushing: a normal scale times a
    small fp8 code whose product falls below fp32's normal range. JAX gives
    0; the port keeps the denormal, which the dequantize would need one
    more pass over every weight to flush. The gap is under 1.2e-38."""
    q = np.array([[2.0 ** -9, 1.0, -2.0 ** -9]], np.float32)
    jq = jnp.asarray(q).astype(jnp.float8_e4m3fn)
    scale = np.array([2.0 ** -120], np.float32)
    ref = np.asarray(jqu.dequantize(jq, jnp.asarray(scale), jnp.float32))
    got = tqu.dequantize(torch.from_numpy(q).to(torch.float8_e4m3fn),
                         torch.from_numpy(scale), torch.float32).numpy()
    assert ref[0, 0] == 0 and got[0, 0] == 2.0 ** -129
    assert got[0, 1] == ref[0, 1] == 2.0 ** -120
    tiny = np.finfo(np.float32).tiny
    assert np.abs(got - ref).max() < tiny


def test_int8_fp8_zero_and_denormal_rows():
    w = np.zeros((3, 64), np.float32)
    w[0] = 1e-42
    w[1] = np.linspace(-2.0, 2.0, 64)
    for dtype in (tqu.QuantizedDtype.INT8, tqu.QuantizedDtype.FP8E4M3):
        jq, js = jqu.quantize(jnp.asarray(w), _jdt(dtype), channel_axis=0)
        tq, ts = tqu.quantize(torch.from_numpy(w), dtype, channel_axis=0)
        _same_bits(tq, jq)
        _same_bits(ts, js)
        out = tqu.dequantize(tq, ts, torch.float32)
        assert torch.isfinite(out).all() and (out[2] == 0).all()
        zq, zs = tqu.quantize(torch.zeros(8, 16), dtype)
        assert (tqu.dequantize(zq, zs, torch.float32) == 0).all()


@pytest.mark.parametrize("fmt", ["fp4", "fp8"])
def test_mx_scales_at_powers_of_two(fmt):
    """Block maxima at and within 3 ulps of every ``2^k x max`` where the
    scale's exponent steps: the port's fp64 logarithm rounded to fp32 gives
    numpy's ``ceil(log2(.))`` in every case."""
    elem_max = 6.0 if fmt == "fp4" else 448.0
    amax = (np.float32(2.0) ** np.arange(-120, 100, dtype=np.float32)
            * np.float32(elem_max)).astype(np.float32)
    near = [amax]
    for direction in (np.float32(np.inf), np.float32(0)):
        x = amax
        for _ in range(3):
            x = np.nextafter(x, direction).astype(np.float32)
            near.append(x)
    amax = np.concatenate(near)
    rng = np.random.RandomState(2)
    w = (rng.rand(amax.size, 32) * amax[:, None]).astype(np.float32)
    w[:, 0] = amax
    _mx_same(fmt, w)


def test_fp4_keeps_the_lower_grid_point_on_a_tie():
    """A block whose maximum is 6 has scale 1: 0.25, 0.75, 1.25, 1.75, 2.5,
    3.5 and 5 lie midway between grid points, and ``argmin`` keeps the
    lower one, as JAX does (not round-to-nearest-even)."""
    w = np.zeros((1, 32), np.float32)
    ties = [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0]
    w[0, :7] = ties
    w[0, 7:14] = [-t for t in ties]
    w[0, 14] = 6.0
    tp, ts = _mx_same("fp4", w)
    assert ts.item() == 1.0
    out = tmx.mx_dequantize_fp4(tp, ts, dtype=torch.float32)[0]
    assert out[:7].tolist() == [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0]
    assert out[7:14].tolist() == [-0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0]


def test_fp4_midpoint_count_is_the_grid_argmin():
    """The port finds an fp4 magnitude by counting the grid midpoints below
    it; JAX takes the first argmin of the distances to the grid. They agree
    on every fp32 value within 4096 ulps of each midpoint (ties included),
    at the grid points, past 6 and on random magnitudes."""
    grid = torch.tensor(tmx.FP4_GRID)
    mids = (grid[1:] + grid[:-1]) / 2
    steps = torch.arange(-4096, 4097, dtype=torch.int32)
    near = (mids.view(torch.int32)[:, None] + steps).flatten().view(
        torch.float32)
    gen = torch.Generator().manual_seed(0)
    mags = torch.cat([near, grid, torch.tensor([6.0000005, 7.0, 100.0]),
                      torch.rand(100000, generator=gen) * 6.5])
    argmin = torch.argmin((mags[:, None] - grid).abs(), dim=-1)
    count = torch.bucketize(mags, mids)
    assert torch.equal(count, argmin)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got.detach().float().numpy() - ref).max() <= rtol * scale


def _load(mod, params):
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in params.items()})
    return mod


def _t(a):
    """A numpy or JAX array as torch, fp8 crossing as its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype,qtype,act", [
    (tqu.QuantizedDtype.INT8, "per_channel_symmetric", False),
    (tqu.QuantizedDtype.INT8, "per_tensor_symmetric", False),
    (tqu.QuantizedDtype.FP8E4M3, "per_channel_symmetric", False),
    (tqu.QuantizedDtype.INT8, "per_block_symmetric", False),
    (tqu.QuantizedDtype.INT8, "per_channel_symmetric", True),
    (tqu.QuantizedDtype.FP8E4M3, "per_channel_symmetric", True),
])
@pytest.mark.parametrize("row", [False, True])
def test_quantized_linears_match_jax(dtype, qtype, act, row):
    w = _weights(3)
    x = np.random.RandomState(4).randn(2, 5, 64).astype(np.float32)
    q, s = jqu.quantize(jnp.asarray(w), _jdt(dtype),
                        jqu.QuantizationType(qtype), block_size=16)
    s = s if qtype == "per_block_symmetric" else s.reshape(-1)
    jcls = jql.QuantizedRowParallel if row else jql.QuantizedColumnParallel
    tcls = tql.QuantizedRowParallel if row else tql.QuantizedColumnParallel
    kw = dict(quantized_dtype=_jdt(dtype),
              quantization_type=jqu.QuantizationType(qtype),
              activation_quantization=act, scale_block_size=16,
              dtype=jnp.float32)
    ref = jcls(features=48, **kw).apply(
        {"params": {"kernel_q": q, "kernel_scale": s}}, jnp.asarray(x))
    mod = tcls(64, 48, quantized_dtype=dtype,
               quantization_type=tqu.QuantizationType(qtype),
               activation_quantization=act, scale_block_size=16,
               dtype=torch.float32)
    _load(mod, {"kernel_q": _t(q), "kernel_scale": _t(s)})
    _close(mod(torch.from_numpy(x)), ref)


def test_per_block_w8a8_raises_as_jax():
    with pytest.raises(ValueError, match="w8a16-only"):
        tql.QuantizedColumnParallel(
            64, 8, quantization_type=tqu.QuantizationType.PER_BLOCK_SYMMETRIC,
            activation_quantization=True, scale_block_size=16)


@pytest.mark.parametrize("fmt", ["int8", "fp8", "mx_fp4", "mx_fp8"])
def test_quantized_qkv_matches_jax(fmt):
    h, n, kv, d = 64, 4, 2, 16
    rng = np.random.RandomState(5)
    ws = {k: rng.randn(h, o).astype(np.float32) * 0.1
          for k, o in (("q_kernel", n * d), ("k_kernel", kv * d),
                       ("v_kernel", kv * d))}
    x = rng.randn(2, 3, h).astype(np.float32)
    if fmt.startswith("mx"):
        params = {}
        for k, w in ws.items():
            p = jmxl.mx_pack_linear(w, fmt[3:])
            params[f"{k}_packed"], params[f"{k}_scale"] = (
                p["kernel_packed"], p["kernel_scale"])
        jmod = jmxl.MXGQAQKVColumnParallelLinear(
            num_heads=n, num_kv_heads=kv, head_dim=d, mx_format=fmt[3:],
            dtype=jnp.float32)
        tmod = tmxl.MXGQAQKVColumnParallelLinear(h, n, kv, d, fmt[3:],
                                                 dtype=torch.float32)
    else:
        qdt = (tqu.QuantizedDtype.INT8 if fmt == "int8"
               else tqu.QuantizedDtype.FP8E4M3)
        params = {}
        for k, w in ws.items():
            q, s = jqu.quantize(jnp.asarray(w), _jdt(qdt))
            params[f"{k}_q"], params[f"{k}_scale"] = q, s.reshape(-1)
        jmod = jql.QuantizedGQAQKVColumnParallelLinear(
            num_heads=n, num_kv_heads=kv, head_dim=d,
            quantized_dtype=_jdt(qdt), dtype=jnp.float32)
        tmod = tql.QuantizedGQAQKVColumnParallelLinear(
            h, n, kv, d, quantized_dtype=qdt, dtype=torch.float32)
    refs = jmod.apply({"params": params}, jnp.asarray(x))
    _load(tmod, {k: _t(v) for k, v in params.items()})
    for got, ref in zip(tmod(torch.from_numpy(x)), refs):
        _close(got, ref)


@pytest.mark.parametrize("fmt", ["fp4", "fp8"])
@pytest.mark.parametrize("row", [False, True])
def test_mx_linears_match_jax(fmt, row):
    w = _weights(6, (64, 96))
    x = np.random.RandomState(7).randn(3, 64).astype(np.float32)
    jp = jmxl.mx_pack_linear(w, fmt)
    tp = tmxl.mx_pack_linear(torch.from_numpy(w), fmt)
    for k in jp:
        _same_bits(tp[k], jp[k])
    jcls = (jmxl.MXQuantizedRowParallel if row
            else jmxl.MXQuantizedColumnParallel)
    tcls = (tmxl.MXQuantizedRowParallel if row
            else tmxl.MXQuantizedColumnParallel)
    ref = jcls(features=96, mx_format=fmt, dtype=jnp.float32).apply(
        {"params": jp}, jnp.asarray(x))
    _close(_load(tcls(64, 96, fmt, dtype=torch.float32), tp)(
        torch.from_numpy(x)), ref)


def _bank(seed, e=4, h=64, i=32, t=12, k=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, h).astype(np.float32)
    idx = np.stack([rng.choice(e, k, replace=False)
                    for _ in range(t)]).astype(np.int32)
    gates = rng.rand(t, k).astype(np.float32)
    params = {"gate_up": rng.randn(e, h, 2, i).astype(np.float32) * 0.2,
              "down": rng.randn(e, i, h).astype(np.float32) * 0.2}
    return x, idx, gates, params


@pytest.mark.parametrize("fmt,cf", [("int8", 2.0), ("fp8", 2.0),
                                    ("int8", 0.5), ("mx_fp4", 0.5),
                                    ("mx_fp8", 2.0)])
def test_quantized_expert_banks_match_jax(fmt, cf):
    """The int8/fp8 bank (capacity factor 0.5 drops pairs) and the MX bank
    (dropless: capacity raised to T) against JAX's; the converters'
    outputs bit for bit."""
    e, h, i = 4, 64, 32
    x, idx, gates, params = _bank(8, e, h, i)
    if fmt.startswith("mx"):
        jp = jmxl.mx_pack_expert_params(params, fmt[3:])
        tp = tmxl.mx_pack_expert_params(
            {k: torch.from_numpy(v) for k, v in params.items()}, fmt[3:])
        jmod = jmxl.MXExpertMLPs(num_experts=e, hidden_size=h,
                                 intermediate_size=i, top_k=2,
                                 capacity_factor=cf, mx_format=fmt[3:],
                                 dtype=jnp.float32)
        tmod = tmxl.MXExpertMLPs(e, h, i, capacity_factor=cf,
                                 mx_format=fmt[3:], dtype=torch.float32)
    else:
        qdt = (tqu.QuantizedDtype.INT8 if fmt == "int8"
               else tqu.QuantizedDtype.FP8E4M3)
        jp = jql.quantize_expert_params(params, _jdt(qdt))
        tp = tql.quantize_expert_params(params, qdt)
        jmod = jql.QuantizedExpertMLPs(num_experts=e, hidden_size=h,
                                       intermediate_size=i, top_k=2,
                                       capacity_factor=cf,
                                       quantized_dtype=_jdt(qdt),
                                       dtype=jnp.float32)
        tmod = tql.QuantizedExpertMLPs(e, h, i, capacity_factor=cf,
                                       quantized_dtype=qdt,
                                       dtype=torch.float32)
    for k in jp:
        _same_bits(tp[k], jp[k])
    ref, raux = jmod.apply({"params": jax.tree.map(jnp.asarray, jp)},
                           jnp.asarray(x), jnp.asarray(gates),
                           jnp.asarray(idx))
    got, aux = _load(tmod, tp)(torch.from_numpy(x), torch.from_numpy(gates),
                               torch.from_numpy(idx))
    _close(got, ref)
    assert aux["dropped_fraction"].item() == pytest.approx(
        float(raux["dropped_fraction"]), abs=1e-7)
    if cf < 1 and fmt == "int8":
        assert aux["dropped_fraction"].item() > 0


def test_convert_matches_jax():
    """Every 2-D ``kernel`` becomes ``kernel_q`` and a flat
    ``kernel_scale``; other leaves (a bias, a 3-D kernel) pass through."""
    rng = np.random.RandomState(9)
    tree = {"a": {"kernel": rng.randn(16, 8).astype(np.float32),
                  "bias": rng.randn(8).astype(np.float32)},
            "kernel": rng.randn(8, 4).astype(np.float32),
            "c": {"kernel": rng.randn(2, 8, 4).astype(np.float32)}}
    ref = jconvert(jax.tree.map(jnp.asarray, tree))
    flat = {"a.kernel": tree["a"]["kernel"], "a.bias": tree["a"]["bias"],
            "kernel": tree["kernel"], "c.kernel": tree["c"]["kernel"]}
    got = tconvert({k: torch.from_numpy(v) for k, v in flat.items()})
    assert set(got) == {"a.kernel_q", "a.kernel_scale", "a.bias",
                        "kernel_q", "kernel_scale", "c.kernel"}
    for name, r in (("a.kernel_q", ref["a"]["kernel_q"]),
                    ("a.kernel_scale", ref["a"]["kernel_scale"]),
                    ("a.bias", ref["a"]["bias"]),
                    ("kernel_q", ref["kernel_q"]),
                    ("kernel_scale", ref["kernel_scale"]),
                    ("c.kernel", ref["c"]["kernel"])):
        _same_bits(got[name], r)
