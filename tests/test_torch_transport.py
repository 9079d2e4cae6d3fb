"""The PyTorch port's KV stream transport against the JAX package's
(``neuronx_distributed_tpu/inference/transport.py``), mirroring
tests/test_transport.py and tests/test_cp_serving.py's ``cp_shards``
tests (the shard split on plain engines: CP engines are a later slice).

The same ticket gives the same chunk bytes in both packages — the meta
chunk, raw fp32 / bf16 / int8 / position slabs, the int8 and fp8 codecs,
shard parts — and each package decodes the other's chunks. ``DcnLink``
delivers the same sequence under every ``link_*`` fault, and a stream
between two port engines under each fault gives JAX's ``TransportStats``
(header bytes aside: each header carries a fingerprint of the engine's own
K/V, whose last bits are each package's), commits or aborts as JAX's does
and leaks no block."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import transport as jt
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.parallel import wire_codec as jw
from neuronx_distributed_tpu.resilience import FaultPlan as JFaultPlan
from neuronx_distributed_tpu.resilience import integrity as ji
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import transport as tt
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.parallel import wire_codec as tw
from neuronx_distributed_tpu_torch.resilience import integrity as ti
from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan
from neuronx_distributed_tpu_torch.utils.bfloat16 import BF16Words, is_bf16

_STREAM = dict(bandwidth=50e3, latency_s=1e-3)
STATS = ("chunks", "sends", "retries", "nacks", "wire_payload_bytes",
         "fp32_payload_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """tests/test_transport.py's tiny model (one head at head_dim 64) as
    JAX params and the port's state dict."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2, num_heads=1, num_kv_heads=1)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2, num_heads=1,
                          num_kv_heads=1)
    return jcfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


def _ecfg(mod, **kw):
    base = dict(block_size=4, num_blocks=16, max_slots=2,
                max_blocks_per_seq=8, token_budget=8, quantized=True)
    base.update(kw)
    if mod is je:
        base.setdefault("kv_dtype", jnp.float32)
    return mod.EngineConfig(**base)


def _engine(mod, models, name="e", **kw):
    jcfg, params, tcfg, sd = models
    if mod is je:
        ps.initialize_model_parallel()
        return je.ServingEngine(jcfg, params, _ecfg(je, **kw), name=name,
                                clock=lambda: 0.0)
    return te.ServingEngine(tcfg, sd, _ecfg(te, **kw), name=name,
                            clock=lambda: 0.0, device="cpu")


def _prompt(n=8, seed=7, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (n,)).tolist()


def _export_ticket(mod, models, n_decode=2, prompt=None, **kw):
    """A live, KV-bearing ticket: prefill + a couple of decode steps."""
    src = _engine(mod, models, "src", **kw)
    uid = src.submit(prompt or _prompt(), 6, uid="req0")
    for _ in range(1 + n_decode):
        src.step()
    assert src.handoff_ready(uid)
    return src, src.export_session(uid)


def _tmod(mod):
    return jt if mod is je else tt


def _drive(tr, link, t=0.0, t_max=30.0):
    """Event-driven fake clock: hop to the next link delivery or sender
    timer until the stream goes terminal (tests/test_transport.py)."""
    while tr.state == "streaming" and t < t_max:
        nxts = [x for x in (link.next_deliver(), tr.next_timer())
                if x is not None]
        if not nxts:
            break
        t = max(t, min(nxts))
        for _route, data in link.deliver(t):
            tr.on_wire(data, t)
        tr.pump(t)
    return t


def _finish(eng, uid, t_max=200):
    for _ in range(t_max):
        if uid in eng.results:
            return eng.results[uid]
        eng.step()
    raise AssertionError("request never completed")


# ---------------------------------------------------------------------------
# the same ticket, the same bytes
# ---------------------------------------------------------------------------

def _kv_pair(kind, seed=0, n_layers=2, n_blocks=5, bs=4, kvh=2, d=8):
    """One synthetic KV payload as JAX holds it (ml_dtypes bf16) and as the
    port does (BF16Words)."""
    rng = np.random.RandomState(seed)
    shape = (n_layers, n_blocks, bs, kvh, d)
    pos = np.arange(n_blocks * bs, dtype=np.int32).reshape(n_blocks, bs)
    pos[-1, 2:] = (2 ** 31 - 1) // 2
    if kind == "int8":
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.rand(*shape[:-1]).astype(np.float32)
        vs = rng.rand(*shape[:-1]).astype(np.float32)
        kv = {"k": k, "v": v, "pos": pos, "k_scale": ks, "v_scale": vs}
        return kv, dict(kv)
    k = (rng.randn(*shape) * 3).astype(np.float32)
    v = (rng.randn(*shape) * 0.1).astype(np.float32)
    if kind == "fp32":
        kv = {"k": k, "v": v, "pos": pos}
        return kv, dict(kv)
    jkv = {"k": k.astype(ml_dtypes.bfloat16),
           "v": v.astype(ml_dtypes.bfloat16), "pos": pos}
    tkv = {"k": jkv["k"].view(np.uint16).view(BF16Words),
           "v": jkv["v"].view(np.uint16).view(BF16Words), "pos": pos}
    return jkv, tkv


def _ticket_pair(kind, **kw):
    jkv, tkv = _kv_pair(kind, **kw)
    axes = {"k": 1, "v": 1, "pos": 0, "k_scale": 1, "v_scale": 1}
    jfp = ji.kv_payload_fingerprints(jkv, axes)
    tfp = ti.kv_payload_fingerprints(tkv, axes)
    assert jfp == tfp
    fields = dict(uid="s0", prompt=[3, 1, 4, 1, 5], generated=[9, 2],
                  max_new_tokens=6, n_cached=6, age_s=0.125, ttft_s=0.0625,
                  n_blocks=jkv["pos"].shape[0])
    return (je.SessionTicket(kv=jkv, kv_fp=jfp, **fields),
            te.SessionTicket(kv=tkv, kv_fp=tfp, **fields))


WIRE_CASES = [("fp32", "auto", 1), ("fp32", "fp8", 1), ("fp32", "fp32", 1),
              ("bf16", "auto", 1), ("bf16", "fp8", 1), ("bf16", "fp32", 1),
              ("int8", "auto", 1), ("int8", "fp32", 1), ("fp32", "auto", 2),
              ("bf16", "fp32", 3), ("int8", "auto", 4)]


@pytest.mark.parametrize("kind,wire,shards", WIRE_CASES)
def test_stream_chunks_are_jax_bytes(kind, wire, shards):
    jtk, ttk = _ticket_pair(kind)
    jtr = jt.KVStreamTransport(jtk, None, jt.DcnLink(), "r",
                               jt.StreamConfig(wire_dtype=wire,
                                               wire_block=16,
                                               cp_shards=shards))
    ttr = tt.KVStreamTransport(ttk, None, tt.DcnLink(), "r",
                               tt.StreamConfig(wire_dtype=wire,
                                               wire_block=16,
                                               cp_shards=shards))
    assert [st["wire"] for st in ttr._tx] == [st["wire"] for st in jtr._tx]
    for f in STATS + ("wire_bytes",):
        assert getattr(ttr.stats, f) == getattr(jtr.stats, f), f
    assert ttr.stats.wire_ratio == jtr.stats.wire_ratio
    # each package decodes the other's chunks to the same values
    for st in jtr._tx:
        jh, jp, ja = jt.decode_chunk(st["wire"])
        th, tp, ta = tt.decode_chunk(st["wire"])
        assert th == jh and tp == jp
        if ja is None:
            assert ta is None
            continue
        assert tuple(ta.shape) == tuple(ja.shape)
        if str(ja.dtype) == "bfloat16":
            assert is_bf16(ta)
            np.testing.assert_array_equal(np.asarray(ta),
                                          ja.view(np.uint16))
        else:
            assert ta.dtype == ja.dtype
            np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int32", "bfloat16"])
def test_raw_chunk_bytes_and_cross_decode(dtype):
    rng = np.random.RandomState(5)
    base = (rng.randn(3, 12) * 50).astype(np.float32)
    if dtype == "bfloat16":
        jarr = base.astype(ml_dtypes.bfloat16)
        tarr = jarr.view(np.uint16).view(BF16Words)
    else:
        jarr = tarr = base.astype(dtype)
    jw_ = jt.encode_chunk("s", 3, "data", "k", 1, jarr)
    tw_ = tt.encode_chunk("s", 3, "data", "k", 1, tarr)
    assert tw_ == jw_
    head, _, back = tt.decode_chunk(jw_)
    assert head["dtype"] == dtype and head["seq"] == 3
    np.testing.assert_array_equal(np.asarray(back).view(np.uint8),
                                  np.asarray(tarr).view(np.uint8))
    _, _, jback = jt.decode_chunk(tw_)
    np.testing.assert_array_equal(jback, jarr)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_chunk_bytes_and_cross_decode(codec, dtype):
    rng = np.random.RandomState(6)
    base = rng.randn(4, 50).astype(np.float32)
    if dtype == "bfloat16":
        jarr = base.astype(ml_dtypes.bfloat16)
        tarr = jarr.view(np.uint16).view(BF16Words)
    else:
        jarr = tarr = base
    jwire = jt.encode_chunk("s", 1, "data", "v", 0, jarr,
                            codec=jw.CompressionConfig(codec, 32))
    twire = tt.encode_chunk("s", 1, "data", "v", 0, tarr,
                            codec=tw.CompressionConfig(codec, 32))
    assert twire == jwire
    _, _, jback = jt.decode_chunk(twire)
    _, _, tback = tt.decode_chunk(jwire)
    assert tback.shape == jback.shape
    np.testing.assert_array_equal(np.asarray(tback).view(np.uint8),
                                  np.asarray(jback).view(np.uint8))


def test_chunk_raw_round_trip():
    arr = np.arange(24, dtype=np.int8).reshape(2, 12)
    wire = tt.encode_chunk("s", 3, "data", "k", 1, arr)
    assert wire.startswith(tt.CHUNK_MAGIC)
    head, _, back = tt.decode_chunk(wire)
    assert head["seq"] == 3 and head["tensor"] == "k"
    assert head["layer"] == 1 and head["kind"] == "data"
    assert back.dtype == np.int8
    np.testing.assert_array_equal(back, arr)


def test_chunk_blockwise_codec_round_trip():
    rng = np.random.RandomState(0)
    arr = rng.randn(4, 64).astype(np.float32)
    codec = tw.CompressionConfig(dtype="int8", block_size=32)
    wire = tt.encode_chunk("s", 1, "data", "v", 0, arr, codec=codec)
    head, _, back = tt.decode_chunk(wire)
    assert head["codec"]["dtype"] == "int8"
    assert back.dtype == np.float32 and back.shape == arr.shape
    assert np.max(np.abs(back - arr)) <= np.max(np.abs(arr)) / 64
    assert head["nbytes"] < arr.nbytes / 3


def test_chunk_rejects_corruption_with_seq():
    arr = np.ones((3, 8), np.float32)
    wire = bytearray(tt.encode_chunk("s", 5, "data", "k", 0, arr))
    wire[-2] ^= 0x10                     # payload bit, header intact
    for mod in (tt, jt):
        with pytest.raises(mod.ChunkIntegrityError) as ei:
            mod.decode_chunk(bytes(wire))
        assert ei.value.seq == 5
    with pytest.raises(tt.ChunkIntegrityError, match="arrived"):
        tt.decode_chunk(bytes(wire[:-4]))   # truncated payload
    with pytest.raises(tt.ChunkError, match="version skew"):
        tt.decode_chunk(b"NXDKVC9\n" + bytes(wire[8:]))
    with pytest.raises(tt.ChunkError, match="bad magic"):
        tt.decode_chunk(b"hello world")
    with pytest.raises(tt.ChunkError, match="no header line"):
        tt.decode_chunk(tt.CHUNK_MAGIC + b"x" * 4)
    with pytest.raises(tt.ChunkError, match="corrupt chunk header"):
        tt.decode_chunk(tt.CHUNK_MAGIC + b"{nope\n")


# ---------------------------------------------------------------------------
# SessionTicket wire format and import fail-closed (the port's engine)
# ---------------------------------------------------------------------------

def test_ticket_bytes_round_trip_and_skew(models):
    _, ticket = _export_ticket(te, models)
    data = ticket.to_bytes()
    assert data.startswith(te.TICKET_MAGIC)
    back = te.SessionTicket.from_bytes(data)
    for f in ("uid", "prompt", "generated", "n_cached", "n_blocks",
              "kv_fp"):
        assert getattr(back, f) == getattr(ticket, f)
    for name in ticket.kv:
        np.testing.assert_array_equal(np.asarray(ticket.kv[name]),
                                      back.kv[name])
    stripped = dataclasses.replace(ticket, kv=None)
    assert te.SessionTicket.from_bytes(stripped.to_bytes()).kv is None
    with pytest.raises(te.TicketWireError, match="bad magic"):
        te.SessionTicket.from_bytes(b"GARBAGE!" + data[8:])
    with pytest.raises(te.TicketWireError, match="version skew"):
        te.SessionTicket.from_bytes(b"NXDTKT9\n" + data[8:])
    with pytest.raises(te.TicketWireError, match="truncated ticket payload"):
        te.SessionTicket.from_bytes(data[:-3])
    buf = bytearray(data)
    buf[-1] ^= 0x40
    with pytest.raises(te.TicketWireError, match="integrity fingerprint"):
        te.SessionTicket.from_bytes(bytes(buf))


def test_import_rejects_unfingerprinted_kv_when_integrity_on(models):
    _, ticket = _export_ticket(te, models, integrity=False)
    assert ticket.kv is not None and ticket.kv_fp is None
    dst = _engine(te, models, "dst", integrity=True)
    base_free = dst.pool_free_blocks()
    with pytest.raises(ti.IntegrityError, match="no fingerprints"):
        dst.import_session(ticket)
    assert dst.pool_free_blocks() == base_free
    assert dst.stats.integrity_rejects == 1
    relaxed = _engine(te, models, "relaxed", integrity=False)
    relaxed.import_session(ticket)
    assert relaxed.handoff_ready(ticket.uid)


# ---------------------------------------------------------------------------
# DcnLink: pacing + fault enactment, the same sequence as JAX's
# ---------------------------------------------------------------------------

def test_link_bandwidth_pacing_serializes_sends():
    for mod in (tt, jt):
        link = mod.DcnLink(bandwidth=1000.0, latency_s=0.01)
        a = link.send("r", b"x" * 100, 0.0)
        b = link.send("r", b"y" * 100, 0.0)
        assert a == pytest.approx(0.11) and b == pytest.approx(0.21)
        assert link.deliver(0.11) == [("r", b"x" * 100)]
        assert link.next_deliver() == pytest.approx(0.21)
        assert link.deliver(0.5) == [("r", b"y" * 100)]


LINK_PLANS = [
    "seed=0; link|* : link_drop, times=1 ; "
    "link|* : link_delay, after=1, times=1, latency=0.5 ; "
    "link|* : link_partition, after=2, times=1",
    "seed=1; link|* : link_corrupt, times=3, p=0.5",
    "seed=3; link|* : link_drop, p=0.3, times=5",
    "seed=3; link|* : link_delay, p=0.5, times=6, latency=0.03",
    "seed=3; link|* : link_partition, after=8, times=1, latency=0.2",
    "seed=3; link|* : link_partition, after=4, times=1",
]


@pytest.mark.parametrize("spec", LINK_PLANS)
def test_link_delivers_the_same_sequence_as_jax(spec):
    wires = [tt.encode_chunk("s", i, "data", "k", 0,
                             np.full((4,), i, np.float32))
             for i in range(16)]
    out = []
    for mod, plan in ((tt, FaultPlan.parse(spec)),
                      (jt, JFaultPlan.parse(spec))):
        link = mod.DcnLink(bandwidth=1e4, latency_s=0.001, chaos=plan)
        sends = [link.send(f"r{i % 2}", w, 0.01 * i)
                 for i, w in enumerate(wires)]
        got = []
        t = 0.0
        while link.next_deliver() is not None:
            t = link.next_deliver()
            got.extend(link.deliver(t))
        out.append((sends, got, dataclasses.astuple(link.stats)))
    assert out[0] == out[1]


def test_link_corrupt_flips_payload_not_header():
    plan = FaultPlan.parse("seed=1; link|* : link_corrupt, times=1")
    link = tt.DcnLink(bandwidth=1e9, latency_s=0.0, chaos=plan)
    wire = tt.encode_chunk("s", 0, "data", "k", 0,
                           np.ones((4,), np.float32))
    link.send("r", wire, 0.0)
    [(route, data)] = link.deliver(1.0)
    assert link.stats.corrupted == 1 and data != wire
    with pytest.raises(tt.ChunkIntegrityError):
        tt.decode_chunk(data)


# ---------------------------------------------------------------------------
# streamed handoff engine to engine, against JAX's
# ---------------------------------------------------------------------------

STREAM_FAULTS = {
    "none": "",
    "corrupt": "seed=3; link|* : link_corrupt, times=2, p=0.5",
    "drop": "seed=3; link|* : link_drop, times=3, p=0.3",
    "delay": "seed=3; link|* : link_delay, times=4, p=0.5, latency=0.03",
    "partition": "seed=3; link|* : link_partition, times=1",
}


def _stream(mod, models, spec, prompt=None, scfg=None, **kw):
    src, ticket = _export_ticket(mod, models, prompt=prompt, **kw)
    dst = _engine(mod, models, "dst", **kw)
    base_free = dst.pool_free_blocks()
    m = _tmod(mod)
    plan = ((FaultPlan if mod is te else JFaultPlan).parse(spec)
            if spec else None)
    link = m.DcnLink(chaos=plan, **_STREAM)
    tr = m.KVStreamTransport(ticket, dst, link, "src->dst/req0",
                             scfg or m.StreamConfig(**_STREAM))
    tr.start(0.0)
    _drive(tr, link)
    return tr, link, dst, base_free


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("fault", list(STREAM_FAULTS))
def test_stream_between_port_engines_follows_jax(models, fault, quantized):
    spec = STREAM_FAULTS[fault]
    ttr, tlink, tdst, tfree = _stream(te, models, spec, quantized=quantized)
    jtr, jlink, jdst, jfree = _stream(je, models, spec, quantized=quantized)
    assert ttr.state == jtr.state
    assert ttr.reason == jtr.reason
    for f in STATS:
        assert getattr(ttr.stats, f) == getattr(jtr.stats, f), f
    assert ttr.stats.wire_ratio == jtr.stats.wire_ratio
    # header bytes carry fingerprints of each package's own K/V
    assert abs(ttr.stats.wire_bytes - jtr.stats.wire_bytes) \
        <= 12 * ttr.stats.sends
    lt, lj = dataclasses.asdict(tlink.stats), dataclasses.asdict(
        jlink.stats)
    assert abs(lt.pop("bytes") - lj.pop("bytes")) <= 12 * ttr.stats.sends
    assert lt == lj
    assert tdst.handoff_ready("req0") == jdst.handoff_ready("req0")
    if ttr.state == "aborted":
        assert "retransmit budget" in ttr.reason
        assert tdst.pool_free_blocks() == tfree
        assert "req0" not in tdst.results
    else:
        assert ttr.state == "committed"
        assert tdst.pool_free_blocks() < tfree
    # a terminal stream keeps no engine alive
    assert ttr.dest is None
    if quantized:
        assert ttr.stats.wire_ratio >= 3.5


def test_streamed_handoff_bit_identical_and_compressed(models):
    ref = _engine(te, models, "ref")
    ref.submit(_prompt(), 6, uid="req0")
    ref_tokens = _finish(ref, "req0").tokens
    tr, _, dst, _ = _stream(te, models, "")
    assert tr.state == "committed"
    assert tr.stats.retries == 0 and tr.stats.nacks == 0
    # a quantized pool ships raw int8 + scales: lossless against the pool,
    # and ~4x under the fp32 baseline at the same time
    assert tr.stats.wire_ratio >= 3.5
    assert _finish(dst, "req0").tokens == ref_tokens
    assert dst.compile_count() == 1


def test_fp32_wire_of_a_quantized_pool_ships_dequantized_values(models):
    tr, _, dst, _ = _stream(te, models, "",
                            scfg=tt.StreamConfig(wire_dtype="fp32",
                                                 **_STREAM))
    jtr, _, _, _ = _stream(je, models, "",
                           scfg=jt.StreamConfig(wire_dtype="fp32",
                                                **_STREAM))
    assert tr.state == jtr.state == "committed"
    assert tr.stats.wire_ratio == jtr.stats.wire_ratio
    assert tr.stats.wire_payload_bytes == jtr.stats.wire_payload_bytes


def test_transport_rejects_kv_less_ticket(models):
    _, ticket = _export_ticket(te, models)
    stripped = dataclasses.replace(ticket, kv=None)
    with pytest.raises(ValueError, match="KV-bearing"):
        tt.KVStreamTransport(stripped, None, tt.DcnLink(), "r")


def test_stream_config_validation():
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="wire_dtype"):
            mod.StreamConfig(wire_dtype="int4")
        with pytest.raises(ValueError, match="max_chunk_attempts"):
            mod.StreamConfig(max_chunk_attempts=0)
        with pytest.raises(ValueError, match="cp_shards"):
            mod.StreamConfig(cp_shards=0)
    assert dataclasses.asdict(tt.StreamConfig()) == dataclasses.asdict(
        jt.StreamConfig())


# ---------------------------------------------------------------------------
# cp_shards: block-subset chunks on plain engines (tests/test_cp_serving.py)
# ---------------------------------------------------------------------------

def _long_prompt():
    return _prompt(16, seed=11)


def test_sharded_stream_lands_every_part_like_jax(models):
    ref = _engine(te, models, "ref", quantized=False)
    ref.submit(_long_prompt(), 6, uid="req0")
    ref_tokens = _finish(ref, "req0").tokens
    shards = 4
    tr, _, dst, _ = _stream(
        te, models, "", prompt=_long_prompt(), quantized=False,
        scfg=tt.StreamConfig(cp_shards=shards, **_STREAM))
    jtr, _, _, _ = _stream(
        je, models, "", prompt=_long_prompt(), quantized=False,
        scfg=jt.StreamConfig(cp_shards=shards, **_STREAM))
    assert tr.state == jtr.state == "committed"
    # the per-layer K/V slabs (2 layers x k,v) each split into cp_shards
    # disjoint block-subset chunks
    assert tr.stats.chunks >= shards * 4
    for f in STATS:
        assert getattr(tr.stats, f) == getattr(jtr.stats, f), f
    assert _finish(dst, "req0").tokens == ref_tokens
    assert dst.compile_count() == 1


def test_sharded_torn_stream_is_all_or_nothing(models):
    tr, _, dst, base_free = _stream(
        te, models, "seed=3; link|* : link_partition, times=1",
        prompt=_long_prompt(),
        scfg=tt.StreamConfig(cp_shards=4, **_STREAM))
    assert tr.state == "aborted"
    assert dst.pool_free_blocks() == base_free
    assert not dst.handoff_ready("req0")
    assert "req0" not in dst.results


def test_destination_refusal_aborts_and_frees(models):
    _, ticket = _export_ticket(te, models)
    dst = _engine(te, models, "dst")
    dst.drain()
    link = tt.DcnLink(**_STREAM)
    tr = tt.KVStreamTransport(ticket, dst, link, "r",
                              tt.StreamConfig(**_STREAM))
    tr.start(0.0)
    _drive(tr, link)
    assert tr.state == "aborted"
    assert tr.reason.startswith("destination refused the stream")
    assert dst.allocator.num_allocated == 0
