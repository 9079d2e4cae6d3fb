"""Session migration, prefix shipping and the fleet controls of the
PyTorch port's ServingEngine, against the JAX engine on the same tiny fp32
model and requests.

Migration: a session exported mid-decode and imported elsewhere finishes
with the ids of an unmigrated run and prefills nothing; the two packages
export the same ticket (its fields and stored positions exactly, K/V within
1e-5 of the tensor's max in fp32) and land it the same way; the port's
ticket read back by JAX verifies against its fingerprints (the ticket
bytes themselves: tests/test_torch_speculative.py). Import is all or
nothing (no slot, draining, a corrupted block). The streamed import,
``handoff_ready``, prefix shipping, and the mirrors of
tests/test_elastic.py's migration tests, tests/test_integrity.py's ticket
tests and tests/test_engine.py's fleet-control tests (``queue_depth``,
``pool_free_blocks``, ``EngineStats.to_dict``, ``drain``, ``evict``); the
engine's spans, request traces and metrics through ``obs``."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import paging as jpg
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.resilience import integrity as ji
from neuronx_distributed_tpu_torch import obs
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import paging as tpg
from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.resilience import integrity as ti

STAT_FIELDS = ("steps", "completed", "prefill_tokens", "tokens_generated",
               "migrated_in", "migrated_out", "migrated_tokens",
               "integrity_rejects", "prefix_hit_tokens", "resubmitted")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny model's many
    small ops lose far more to thread start-up than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The tests/test_elastic.py tiny model as JAX params and the port's
    state dict."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    return jcfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _ecfg(mod, **kw):
    base = dict(block_size=4, num_blocks=16, max_slots=2,
                max_blocks_per_seq=8, token_budget=8)
    base.update(kw)
    if mod is je and not base.get("quantized"):
        base.setdefault("kv_dtype", jnp.float32)
    return mod.EngineConfig(**base)


def _teng(models, name="e", **kw):
    _, _, tcfg, sd = models
    return te.ServingEngine(tcfg, sd, _ecfg(te, **kw), clock=_clock(),
                            device="cpu", name=name)


def _jeng(models, name="e", **kw):
    jcfg, params, _, _ = models
    ps.initialize_model_parallel()
    return je.ServingEngine(jcfg, params, _ecfg(je, **kw), clock=_clock(),
                            name=name)


def _prompt(seed=0, length=6):
    return np.random.RandomState(seed).randint(0, 256, (length,)).tolist()


def _run_to_done(eng, uid, steps=24):
    for _ in range(steps):
        eng.step()
        if uid in eng.results:
            return eng.results.pop(uid)
    raise AssertionError(f"{uid} did not complete in {steps} steps")


def _stats(eng):
    return {f: getattr(eng.stats, f) for f in STAT_FIELDS}


def _migrate(eng_of, models, stream=False, **kw):
    """tests/test_elastic.py:253 in one package: three steps on ``src``,
    export, import into ``dst`` (through the stream when asked), run to
    done; ``ref`` serves the same request unmigrated."""
    src, dst, ref = (eng_of(models, n, **kw) for n in ("src", "dst", "ref"))
    p = _prompt(seed=3)
    src.submit(p, max_new_tokens=6, uid="m")
    ref.submit(p, max_new_tokens=6, uid="m")
    for _ in range(3):
        src.step()
    assert src.handoff_ready("m") and not dst.handoff_ready("m")
    ticket = src.export_session("m")
    before = dst.stats.prefill_tokens
    if stream:
        handle = dst.begin_stream_import(
            te.SessionTicket(**{**ticket.__dict__, "kv": None}))
        for name, arr in ticket.kv.items():
            if name == "pos":
                dst.stream_inject(handle, "pos", 0, arr)
            else:
                for layer in range(arr.shape[0]):
                    dst.stream_inject(handle, name, layer, arr[layer])
        dst.commit_stream_import(handle)
    else:
        dst.import_session(ticket)
    return (ticket, _run_to_done(dst, "m").tokens,
            _run_to_done(ref, "m").tokens, src, dst, before)


@pytest.mark.parametrize("quantized", [False, True])
def test_session_migration_bit_identical_and_like_jax(models, quantized):
    jt, jgot, jwant, jsrc, jdst, _ = _migrate(_jeng, models,
                                              quantized=quantized)
    tt, got, want, src, dst, before = _migrate(_teng, models,
                                               quantized=quantized)
    assert got == want == jgot == jwant
    assert tt.n_blocks > 0 and tt.n_cached > 0
    assert src.stats.migrated_out == 1 and "m" not in src.results
    assert dst.stats.migrated_in == 1
    assert dst.stats.migrated_tokens == tt.n_cached
    assert dst.stats.prefill_tokens == before     # zero re-prefill
    assert _stats(src) == _stats(jsrc) and _stats(dst) == _stats(jdst)
    # the same ticket: its fields and positions exactly; K/V (computed by
    # each package's own kernels) within 1e-5 of the tensor's max in fp32,
    # int8 codes at most one step apart, scales within 1e-5
    for f in ("uid", "prompt", "generated", "max_new_tokens", "n_cached",
              "age_s", "ttft_s", "n_blocks", "trace"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert list(tt.kv) == list(jt.kv) and list(tt.kv_fp) == list(jt.kv_fp)
    assert tt.kv_fp["pos"] == jt.kv_fp["pos"]
    np.testing.assert_array_equal(tt.kv["pos"], jt.kv["pos"])
    for name in jt.kv:
        want = np.asarray(jt.kv[name]).astype(np.float32)
        got = np.asarray(tt.kv[name]).astype(np.float32)
        tol = 1.0 if name in ("k", "v") and quantized else \
            1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
    # the port's ticket survives the wire and verifies on the JAX side
    back = je.SessionTicket.from_bytes(tt.to_bytes())
    assert ji.kv_payload_fingerprints(back.kv, jpg.PAYLOAD_BLOCK_AXES) \
        == tt.kv_fp


def test_streamed_import_bit_identical(models):
    _, got, want, _, dst, before = _migrate(_teng, models, stream=True)
    assert got == want
    assert dst.stats.migrated_in == 1 and dst.stats.prefill_tokens == before
    # a stream torn before commit leaves the pool as it was
    eng = _teng(models, "torn")
    free = eng.pool_free_blocks()
    handle = eng.begin_stream_import(te.SessionTicket(
        uid="t", prompt=_prompt(4), generated=[1], max_new_tokens=4,
        n_cached=6, age_s=0.0, ttft_s=0.0, n_blocks=2))
    assert eng.pool_free_blocks() == free - 2
    eng.abort_stream_import(handle)
    assert eng.pool_free_blocks() == free and not eng.has_work()
    eng.drain()
    with pytest.raises(te.RequestRejected, match="draining"):
        eng.begin_stream_import(te.SessionTicket(
            uid="u", prompt=[1], generated=[], max_new_tokens=1,
            n_cached=1, age_s=0.0, ttft_s=None, n_blocks=1))


def test_queued_session_migrates_without_kv(models):
    src, dst = _teng(models, "src"), _teng(models, "dst")
    src.submit(_prompt(seed=4), max_new_tokens=4, uid="q")
    ticket = src.export_session("q")
    assert ticket.n_blocks == 0 and ticket.kv is None
    dst.import_session(ticket)
    assert _run_to_done(dst, "q").status == "completed"


def test_import_session_atomic_when_full(models):
    """An import that cannot be hosted raises before it changes the
    destination: no slot, no block, no result."""
    src, dst = _teng(models, "src"), _teng(models, "dst")
    for i in range(2):
        dst.submit(_prompt(seed=10 + i), max_new_tokens=8, uid=f"busy{i}")
    dst.step()
    src.submit(_prompt(seed=5), max_new_tokens=4, uid="m")
    for _ in range(2):
        src.step()
    ticket = src.export_session("m")
    free_before = dst.pool_free_blocks()
    tables = dst._tables.copy()
    with pytest.raises(tpg.CacheExhaustedError):
        dst.import_session(ticket)
    assert dst.pool_free_blocks() == free_before
    assert (dst._tables == tables).all()
    assert "m" not in dst.results and dst.stats.migrated_in == 0
    dst.drain()
    with pytest.raises(te.RequestRejected, match="draining"):
        dst.import_session(ticket)
    with pytest.raises(te.RequestRejected) as exc:
        _teng(models, "small").import_session(te.SessionTicket(
            uid="big", prompt=_prompt(6, 30), generated=[],
            max_new_tokens=10, n_cached=0, age_s=0.0, ttft_s=None))
    assert exc.value.reason == "never_fits"


def test_prefix_trie_ships_with_kv_like_jax(models):
    """export_prefixes / import_prefixes move the hottest trie subtrees
    with their KV blocks: the importer serves prefix hits at once and
    decodes the same ids; both packages ship and land the same."""
    out = {}
    for eng_of in (_jeng, _teng):
        donor = eng_of(models, "donor", prefix_sharing=True)
        p = _prompt(seed=6, length=8)
        donor.submit(p, max_new_tokens=4, uid="w")
        ref_tokens = _run_to_done(donor, "w").tokens
        assert donor.prefix_cache.size > 0
        newcomer = eng_of(models, "newcomer", prefix_sharing=True)
        shipped = donor.export_prefixes(4)
        assert shipped and shipped["nodes"]
        n = newcomer.import_prefixes(shipped)
        assert n == len(shipped["nodes"]) == newcomer.prefix_cache.size
        newcomer.submit(p, max_new_tokens=4, uid="w")
        res = _run_to_done(newcomer, "w")
        assert res.tokens == ref_tokens
        assert newcomer.stats.prefix_hit_tokens > 0
        out[eng_of] = (shipped, res.tokens, _stats(newcomer),
                       newcomer.allocator._refs)
    (js_, jtok, jst, jrefs), (ts_, ttok, tst, trefs) = out[_jeng], out[_teng]
    assert ts_["nodes"] == js_["nodes"]
    np.testing.assert_array_equal(ts_["kv"]["pos"], js_["kv"]["pos"])
    for name in ("k", "v"):
        want = np.asarray(js_["kv"][name])
        np.testing.assert_allclose(ts_["kv"][name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert (ttok, tst, trefs) == (jtok, jst, jrefs)
    # nothing to ship, nothing to land
    plain = _teng(models, "plain")
    assert plain.export_prefixes() is None
    assert plain.import_prefixes(ts_) == 0


# ---------------------------------------------------------------------------
# tickets on the wire (their bytes against JAX's:
# tests/test_torch_speculative.py::test_ticket_bytes_are_jax_bytes)
# ---------------------------------------------------------------------------

def test_ticket_wire_errors():
    cache = tpg.init_paged_kv_cache(2, 6, 4, 2, 8, 2, 4,
                                    dtype=torch.float32, device="cpu")
    cache.k.normal_()
    kv = tpg.extract_blocks(cache, [4, 0, 2], keep_upto=17)
    raw = te.SessionTicket(uid="w", prompt=[1], generated=[],
                           max_new_tokens=2, n_cached=1, age_s=0.0,
                           ttft_s=None, n_blocks=3, kv=kv).to_bytes()
    bad = [b"nope", b"NXDTKT2\n{}\n", raw[:len(te.TICKET_MAGIC)],
           raw[:-1], raw[:-1] + bytes([raw[-1] ^ 1])]
    for data in bad:
        with pytest.raises(te.TicketWireError):
            te.SessionTicket.from_bytes(data)
        with pytest.raises(je.TicketWireError):
            je.SessionTicket.from_bytes(data)


# ---------------------------------------------------------------------------
# integrity (tests/test_integrity.py:441, 475)
# ---------------------------------------------------------------------------

def test_kv_ticket_import_rejects_corrupt_block_atomically(models):
    src, dst = _teng(models, "src"), _teng(models, "dst")
    src.submit(_prompt(7), max_new_tokens=6, uid="m")
    for _ in range(3):
        src.step()
    ticket = src.export_session("m")
    assert ticket.kv is not None and ticket.kv_fp is not None
    assert ticket.kv_fp.keys() == ticket.kv.keys()
    orig_k = np.array(ticket.kv["k"])
    k = orig_k.copy()
    k.reshape(-1)[3] += 1.0
    ticket.kv = {**ticket.kv, "k": k}
    free, tables = dst.pool_free_blocks(), dst._tables.copy()
    pos = dst.cache.pos.clone()
    with pytest.raises(ti.IntegrityError, match="KV blocks"):
        dst.import_session(ticket)
    assert dst.pool_free_blocks() == free and (dst._tables == tables).all()
    assert torch.equal(dst.cache.pos, pos)
    assert "m" not in dst.results and dst.stats.migrated_in == 0
    assert dst.stats.integrity_rejects == 1
    # KV without fingerprints is refused too while integrity is on
    ticket.kv, fps = {**ticket.kv, "k": orig_k}, ticket.kv_fp
    ticket.kv_fp = None
    with pytest.raises(ti.IntegrityError, match="no fingerprints"):
        dst.import_session(ticket)
    assert dst.stats.integrity_rejects == 2
    ticket.kv_fp = fps
    dst.import_session(ticket)
    assert dst.stats.migrated_in == 1


def test_kv_ticket_fp_disabled_by_config(models):
    src = _teng(models, "src", integrity=False)
    src.submit(_prompt(8), max_new_tokens=4, uid="q")
    for _ in range(2):
        src.step()
    assert src.export_session("q").kv_fp is None


# ---------------------------------------------------------------------------
# fleet controls (tests/test_engine.py:230, 248, 262)
# ---------------------------------------------------------------------------

def test_router_hooks_gauges_and_stats_to_dict(models):
    eng = _teng(models)
    assert eng.queue_depth() == 0
    assert eng.pool_free_blocks() == eng.allocator.num_blocks
    eng.submit(_prompt(16), 4, uid="a")
    assert eng.queue_depth() == 1
    eng.step()
    assert eng.pool_free_blocks() < eng.allocator.num_blocks
    eng.run()
    assert eng.queue_depth() == 0
    d = eng.stats.to_dict()
    jd = je.EngineStats().to_dict()
    assert set(jd) <= set(d)
    assert d["queue_depth"] == 0 and d["resubmitted"] == 0
    assert d["completed"] == 1


def test_drain_mode_rejects_but_keeps_stepping(models):
    eng = _teng(models)
    eng.submit(_prompt(17), 4, uid="a")
    eng.step()
    eng.drain()
    assert eng.draining
    with pytest.raises(te.RequestRejected) as exc:
        eng.submit(_prompt(18, 4), 4, uid="late")
    assert exc.value.reason == "draining"
    assert eng.results["late"].status == "rejected"
    res = eng.run()
    assert res["a"].status == "completed" and len(res["a"].tokens) == 4


def test_evict_returns_progress_and_frees_blocks(models):
    """Evicted on one engine and resubmitted on another, with the ids of
    the uninterrupted run."""
    prompt = _prompt(19)
    eng = _teng(models)
    eng.submit(prompt, max_new_tokens=6, uid="a")
    for _ in range(3):
        eng.step()
    assert eng.allocator.num_allocated > 0
    got_prompt, got_gen = eng.evict("a")
    assert got_prompt == prompt and len(got_gen) >= 1
    assert eng.allocator.num_allocated == 0
    assert eng.stats.resubmitted == 1
    assert not eng.has_work() and "a" not in eng.results
    with pytest.raises(KeyError):
        eng.evict("a")
    eng2 = _teng(models)
    eng2.submit(prompt, max_new_tokens=2, uid="q", arrival_time=1e9)
    assert eng2.evict("q") == (prompt, [])
    other = _teng(models, "other")
    other.submit(got_prompt, max_new_tokens=6, uid="a")
    ref = _teng(models, "ref")
    ref.submit(prompt, max_new_tokens=6, uid="a")
    assert other.run()["a"].tokens == ref.run()["a"].tokens
    assert other.run()["a"].tokens[:len(got_gen)] == got_gen


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_spans_traces_and_metrics_follow_a_migrated_request(models):
    """With obs on: the step's spans, a request trace that rides the
    ticket (one trace-id across the hop, a migration counted), the
    per-request histograms and the engine gauges; off, nothing."""
    obs.reset()
    obs.enable()
    try:
        src, dst = _teng(models, "src"), _teng(models, "dst")
        src.submit(_prompt(21), max_new_tokens=5, uid="m")
        for _ in range(3):
            src.step()
        tracer = obs.get_tracer()
        trace_id = tracer.request_trace_id("m")
        ticket = src.export_session("m")
        assert ticket.trace["trace_id"] == trace_id
        assert tracer.request_trace_id("m") is None
        ticket = te.SessionTicket.from_bytes(ticket.to_bytes())
        dst.import_session(ticket)
        assert tracer.request_trace_id("m") == trace_id
        dst.run()
        stats = tracer.stats()
        for span in ("engine/admission", "engine/packed",
                     "engine/retirement"):
            assert span in stats, span
        done = [e for e in tracer.chrome_trace()["traceEvents"]
                if e.get("name") == "request:m"]
        assert done and done[-1]["args"]["migrations"] == 1
        reg = obs.get_registry()
        assert reg.get("nxd_request_e2e_seconds") is not None
        assert reg.get("nxd_engine_step_seconds").count == \
            src.stats.steps + dst.stats.steps
        assert reg.get("nxd_engine_stats").labels(
            field="migrated_in").value == 1
        rejected = _teng(models, "r")
        rejected.drain()
        with pytest.raises(te.RequestRejected) as exc:
            rejected.submit([1, 2], 2, uid="x")
        assert exc.value.trace_id == "trace-x"
    finally:
        obs.disable()
        obs.reset()
    eng = _teng(models, "quiet")
    eng.submit(_prompt(22), 3, uid="q")
    eng.run()
    assert obs.get_registry().get("nxd_engine_step_seconds") is None
    assert obs.get_tracer().stats() == {}


def test_extracted_positions_keep_only_the_session_rows(models):
    """``keep_upto=n_cached``: a block's rows past the session's cached
    tokens ship as PAD_POSITION."""
    eng = _teng(models)
    eng.submit(_prompt(23, 5), max_new_tokens=6, uid="a")
    for _ in range(2):
        eng.step()
    req = eng._slots[0]
    blocks = [int(b) for b in eng._tables[0] if b >= 0]
    kv = tpg.extract_blocks(eng.cache, blocks, keep_upto=req.n_cached - 2)
    flat = kv["pos"].reshape(-1)
    assert (flat[flat != PAD_POSITION] < req.n_cached - 2).all()
    assert (flat == PAD_POSITION).sum() >= 2
