"""The PyTorch port's executable cache against the JAX package's
(``neuronx_distributed_tpu/inference/aot_cache.py``), mirroring
tests/test_elastic.py's cache tests: the keys, the source fingerprints,
the read path's evictions (event names and fields), the disk layer that
degrades to memory, and the engine's warm start.

The port's executable is a serving step captured in a CUDA graph (on the
CPU, the eager step over the same buffers). Two divergences are stated
and held here: a captured step writes the pool it was captured over, so
an entry is leased to one live engine and a second live engine of the
same key misses and captures its own (JAX's engines share an executable);
and a captured graph is never written to disk (``put`` with a
``cache_dir`` counts a serialize skip, as JAX does for a runtime without
serialization)."""

import functools
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta
from torch.autograd import DeviceType

from neuronx_distributed_tpu.inference import aot_cache as jac
from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.obs.events import subscribe as jsubscribe
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import aot_cache as tac
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.obs.events import subscribe as tsubscribe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def events():
    """Events seen by each package's subscriber."""
    seen = {"jax": [], "torch": []}
    unsub = [jsubscribe(lambda e, f: seen["jax"].append((e, f))),
             tsubscribe(lambda e, f: seen["torch"].append((e, f)))]
    yield seen
    for u in unsub:
        u()


@pytest.fixture(scope="module")
def models():
    """tests/test_elastic.py's tiny model as JAX params and the port's
    state dict."""
    ps.initialize_model_parallel()
    try:
        cfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                             num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(cfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    return cfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


def _ecfg(pkg, **kw):
    base = dict(block_size=4, num_blocks=16, max_slots=2,
                max_blocks_per_seq=8, token_budget=8)
    base.update(kw)
    if pkg is je:
        base.setdefault("kv_dtype", jnp.float32)
    return pkg.EngineConfig(**base)


def _jax_engine(models, cache, name="e", **kw):
    ps.initialize_model_parallel()
    cfg, params = models[:2]
    return je.ServingEngine(cfg, params, _ecfg(je, **kw), aot_cache=cache,
                            name=name)


def _port_engine(models, cache, name="e", **kw):
    tcfg, sd = models[2:]
    return te.ServingEngine(tcfg, sd, _ecfg(te, **kw), device="cpu",
                            aot_cache=cache, name=name)


def _serve(eng, vocab=256):
    rng = np.random.RandomState(0)
    for i, n in enumerate((6, 9, 4)):
        eng.submit(rng.randint(0, vocab, (n,)).tolist(), 5, uid=f"r{i}")
    return {u: r.tokens for u, r in eng.run().items()}


# ---------------------------------------------------------------------------
# keys, fingerprints, the environment
# ---------------------------------------------------------------------------

def test_key_for_covers_env_and_parts(tmp_path):
    """tests/test_elastic.py's key cases on the port, and the same key as
    JAX's for the same environment and parts (one sha256 recipe)."""
    env = {"jax": "1", "mesh": "a=8"}
    c = tac.AotExecutableCache(str(tmp_path), env=env)
    j = jac.AotExecutableCache(str(tmp_path), env=env)
    k1 = c.key_for("engine-step", "packed", 8)
    assert k1 == c.key_for("engine-step", "packed", 8)
    assert k1 != c.key_for("engine-step", "packed", 16)
    assert k1 != c.key_for("engine-step", "decode", 8)
    skewed = tac.AotExecutableCache(str(tmp_path),
                                    env={"jax": "2", "mesh": "a=8"})
    assert k1 != skewed.key_for("engine-step", "packed", 8)
    assert c.key_for(b"\x00\x01") != c.key_for(b"\x00\x02")
    for parts in (("engine-step", "packed", 8), (b"\x00\x01",),
                  ("model-builder", (1, 2), None, 3.5)):
        assert c.key_for(*parts) == j.key_for(*parts)
    assert c.environment() == env


def test_runtime_environment_names_the_card():
    env = tac.runtime_environment()
    assert set(env) == {"torch", "cuda", "backend", "devices",
                        "device_name", "capability", "mesh"}
    assert env["torch"] == torch.__version__
    assert env["mesh"] == "none"
    if not torch.cuda.is_available():
        assert (env["backend"], env["devices"], env["capability"]) == (
            "cpu", "1", "none")
    cache = tac.AotExecutableCache()
    assert cache.environment() == env
    assert cache.key_for("x") == cache.key_for("x")


def _f(x):
    return x + 1


def _g(x):
    return x + 2


def test_source_fingerprint_equals_jax():
    for fns in ((_f,), (_g,), (_f, _g), (len,), (functools.partial(_f),),
                (tl.llama_forward_with_cache,)):
        assert tac.source_fingerprint(*fns) == jac.source_fingerprint(*fns)
    assert tac.source_fingerprint(_f) != tac.source_fingerprint(_g)


# ---------------------------------------------------------------------------
# the read and write paths
# ---------------------------------------------------------------------------

def _jax_entry(directory, env):
    """An entry JAX wrote under ``env``: its key and path."""
    c = jac.AotExecutableCache(str(directory), env=env)
    k = c.key_for("unit")
    c.compile_or_load(k, jax.jit(lambda x: x - 1), (jnp.arange(4.0),))
    return k, c._path(k)


def test_skewed_entry_is_evicted_like_jax(tmp_path, events):
    """JAX writes an entry under one environment; a JAX cache and a port
    cache under another read it (each from its own copy) and evict it with
    the same event, fields and stats."""
    k, path = _jax_entry(tmp_path / "jax", {"jax": "0.4.0"})
    (tmp_path / "torch").mkdir()
    shutil.copy(path, tmp_path / "torch")
    new_env = {"jax": "0.5.0"}
    j = jac.AotExecutableCache(str(tmp_path / "jax"), env=new_env)
    t = tac.AotExecutableCache(str(tmp_path / "torch"), env=new_env)
    assert j.get(k) is None and t.get(k) is None
    assert t.stats() == j.stats() == {
        "hits": 0, "misses": 1, "puts": 0, "evictions": 1,
        "serialize_skips": 0, "mem_entries": 0}
    ev = {p: [(e, f) for e, f in events[p] if e == "aot_cache_evicted"]
          for p in events}
    assert ev["torch"] == ev["jax"]
    assert "environment skew" in ev["torch"][0][1]["error"]
    assert not os.path.exists(t._path(k)) and not os.path.exists(path)


@pytest.mark.parametrize("garbage", [b"not an aot bundle",
                                     b"NXDAOT1\n{bad json", b"NXDAOT1\n"])
def test_corrupt_entry_is_evicted_like_jax(tmp_path, events, garbage):
    env = {"jax": "0.5.0"}
    stats = {}
    for name, mod in (("jax", jac), ("torch", tac)):
        c = mod.AotExecutableCache(str(tmp_path / name), env=env)
        k = c.key_for("unit")
        with open(c._path(k), "wb") as fh:
            fh.write(garbage)
        fresh = mod.AotExecutableCache(str(tmp_path / name), env=env)
        assert fresh.get(k) is None
        assert not os.path.exists(c._path(k))
        stats[name] = fresh.stats()
    assert stats["torch"] == stats["jax"]
    ev = {p: [(e, f) for e, f in events[p] if e == "aot_cache_evicted"]
          for p in events}
    assert len(ev["torch"]) == 1 and ev["torch"] == ev["jax"]


def test_an_entry_of_this_environment_is_evicted_too(tmp_path, events):
    """A file that passes the magic and header checks still cannot load
    (a graph is not serialized): the read path evicts it and misses."""
    c = tac.AotExecutableCache(str(tmp_path))
    k = c.key_for("unit")
    import json

    with open(c._path(k), "wb") as fh:
        fh.write(b"NXDAOT1\n" + json.dumps(c.environment(),
                                           sort_keys=True).encode()
                 + b"\npayload")
    assert c.get(k) is None
    assert c.stats()["evictions"] == 1 and not os.path.exists(c._path(k))
    (e, f), = [x for x in events["torch"] if x[0] == "aot_cache_evicted"]
    assert f == {"key": k[:16], "error": "ValueError: a captured CUDA "
                                         "graph does not load from disk"}


def test_serialize_failure_degrades_to_mem_only(tmp_path, events):
    """JAX's case on both packages: the same stats, no file, the same
    event name and key field."""
    out = {}
    for name, mod in (("jax", jac), ("torch", tac)):
        d = tmp_path / name
        c = mod.AotExecutableCache(str(d), env={"jax": "0.5.0"})
        k = c.key_for("unit")
        c.put(k, object())
        assert c.serialize_skips == 1
        assert c.get(k) is not None
        assert not os.listdir(d)
        out[name] = (c.stats(), k)
    assert out["torch"] == out["jax"]
    skipped = {p: [f["key"] for e, f in events[p]
                   if e == "aot_cache_serialize_skipped"] for p in events}
    assert skipped["torch"] == skipped["jax"] == [out["jax"][1][:16]]


def test_leases_hand_an_entry_to_one_holder_at_a_time():
    c = tac.AotExecutableCache()
    made = []

    def capture(tag):
        made.append(tag)
        return object()

    k = c.key_for("unit")
    a, hit = c.compile_or_load(k, capture, ("a",))
    assert not hit and c.leased() == 1
    b, hit = c.compile_or_load(k, capture, ("b",))
    assert not hit and b is not a and made == ["a", "b"]
    c.release(a)
    again, hit = c.compile_or_load(k, capture, ("c",))
    assert hit and again is a and made == ["a", "b"]
    assert c.get(k) is None          # both held
    c.release(a, b)
    assert c.get(k, match=lambda ex: ex is b) is b
    assert c.stats() == {"hits": 2, "misses": 3, "puts": 2,
                         "evictions": 0, "serialize_skips": 0,
                         "mem_entries": 2}


def test_captured_step_on_the_cpu_runs_the_step_over_its_buffers():
    buf = torch.zeros(3)
    step = tac.CapturedStep(lambda x: x * 2, (buf,), holds={"w": 1})
    assert step.graph is None and step.device.type == "cpu"
    buf.copy_(torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(step.run(), torch.tensor([2.0, 4.0, 6.0]))
    worker = tac.AotWorker(step, from_cache=False)
    worker()
    worker()
    assert worker.replays == 2 and worker._cache_size() == 1
    with pytest.raises(ValueError, match="one device"):
        tac.CapturedStep(lambda x: x, (torch.zeros(1),
                                       torch.zeros(1, device="meta")))


# ---------------------------------------------------------------------------
# the engine: cold, freed, warm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("disaggregated", [False, True])
def test_engine_lease_cold_freed_warm_like_jax(models, disaggregated):
    """A cold engine captures (misses) and serves JAX's greedy ids; a live
    second engine misses and captures its own (JAX's hits: the stated
    divergence); once both are freed a third leases a capture, reports
    ``aot_warm()`` and serves the same ids from a reset pool, as JAX's
    warm engine; one step shape a worker throughout."""
    kw = dict(disaggregated=disaggregated)
    jcache = jac.AotExecutableCache()
    jcold = _jax_engine(models, jcache, "cold", **kw)
    want = _serve(jcold)
    jwarm = _jax_engine(models, jcache, "warm", **kw)
    assert jwarm.aot_warm() and _serve(jwarm) == want
    workers = 2 if disaggregated else 1
    assert jcache.stats()["misses"] == workers

    cache = tac.AotExecutableCache()
    cold = _port_engine(models, cache, "cold", **kw)
    assert not cold.aot_warm()
    assert _serve(cold) == want
    assert cold.compile_count() == 1
    live = _port_engine(models, cache, "live", **kw)
    assert not live.aot_warm() and live.cache is not cold.cache
    assert cache.stats()["misses"] == 2 * workers
    del cold, live
    assert cache.leased() == 0
    warm = _port_engine(models, cache, "warm", **kw)
    assert warm.aot_warm()
    assert _serve(warm) == want
    assert warm.compile_count() == 1
    assert warm.worker_replays() == warm.worker_runs
    assert cache.stats() == {"hits": workers, "misses": 2 * workers,
                             "puts": 2 * workers, "evictions": 0,
                             "serialize_skips": 0,
                             "mem_entries": 2 * workers}
    if disaggregated:
        pools = {id(w.executable.holds["cache"])
                 for w in warm._aot_workers.values()}
        assert pools == {id(warm.cache)}


def test_engine_key_separates_token_budget(models):
    """As JAX's: another worker geometry misses and captures its own."""
    for mod, make in ((jac, _jax_engine), (tac, _port_engine)):
        cache = mod.AotExecutableCache()
        first = make(models, cache, "first")
        del first
        other = make(models, cache, "other", token_budget=12)
        assert not other.aot_warm()
        assert cache.misses == 2 and cache.hits == 0


def test_engine_without_a_cache_is_unchanged(models):
    eng = _port_engine(models, None)
    assert eng._aot_workers is None and not eng.aot_warm()
    assert eng.worker_replays() == {}
    cached = _port_engine(models, tac.AotExecutableCache())
    assert _serve(eng) == _serve(cached)


def test_speculation_with_a_cache_is_refused(models):
    from neuronx_distributed_tpu_torch.inference.speculative import (
        SpeculationConfig)

    with pytest.raises(NotImplementedError, match="speculation"):
        _port_engine(models, tac.AotExecutableCache(), num_blocks=32,
                     speculation=SpeculationConfig(2, 1))


@pytest.mark.parametrize("kernel, wrapper", [
    ("void (anonymous namespace)::tc::paged_attention_wgmma<128, 2>(...)",
     "paged_attention"),
    ("void (anonymous namespace)::paged_attention_kernel<float, float, 64>"
     "(...)", "paged_attention"),
    ("void (anonymous namespace)::tc::paged_combine<128>(...)", None),
    ("void (anonymous namespace)::tc::glu_act_wgmma<false>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_down_wgmma<false>(...)", None),
    ("void (anonymous namespace)::tc::glu_act_wgmma<true>(...)",
     "grouped_glu_decode"),
    ("void (anonymous namespace)::tc::glu_bwd_act_wgmma(...)", None),
    ("nvjet_tst_128x64_64x8_1x1_v_bz_coopA_TNN", None),
])
def test_chip_smoke_counts_each_kernel_run_once(kernel, wrapper):
    """``chip_smoke.traced_runs`` counts a run of K1, K5 or K6 once, by the
    first kernel each launch runs (K1's split combine and the GLU's second
    pass are not runs of their own)."""
    import chip_smoke

    ev = types.SimpleNamespace(device_type=DeviceType.CUDA, key=kernel,
                               count=3)
    runs = chip_smoke.traced_runs(types.SimpleNamespace(
        key_averages=lambda: [ev]))
    assert runs == {k: 3 if k == wrapper else 0 for k in runs}


@pytest.mark.parametrize("moe, replays, traced, want", [
    (False, {"packed": 4}, (32, 0, 0), {"paged_attention": (32, 32)}),
    (False, {"packed": 4}, (31, 0, 0), {"paged_attention": (31, 32)}),
    (False, {"packed": 4}, (0, 0, 0), None),
    (False, {"packed": 4}, (33, 0, 0), None),
    (False, {"packed": 4}, (32, 32, 0), None),
    (True, {"packed": 4}, (32, 32, 0), {"paged_attention": (32, 32),
                                        "grouped_glu": (32, 32)}),
    (True, {"packed": 4}, (32, 0, 0), None),
    (True, {"prefill": 0, "decode": 5}, (40, 0, 40),
     {"paged_attention": (40, 40), "grouped_glu_decode": (40, 40)}),
    (True, {"prefill": 0, "decode": 5}, (40, 8, 40), None),
])
def test_chip_smoke_holds_traced_runs_to_replays(moe, replays, traced,
                                                 want):
    """``chip_smoke.hold_traced``: every kernel the profiled replays ran
    (K1; K5 in the packed or prefill worker and K6 in the decode one of a
    blockwise MoE) shows in the trace, none more often than layers x
    replays, and no kernel the workers do not run."""
    import chip_smoke

    win = {"profiled_replays": replays, "traced_kernel_runs": dict(zip(
        ("paged_attention", "grouped_glu", "grouped_glu_decode"), traced))}
    if want is not None:
        assert chip_smoke.hold_traced("x", win, 8, moe) == {
            k: {"runs": r, "want": w} for k, (r, w) in want.items()}
    else:
        with pytest.raises(AssertionError, match="traced kernel runs"):
            chip_smoke.hold_traced("x", win, 8, moe)
