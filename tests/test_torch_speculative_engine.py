"""Speculative decoding in the PyTorch port's ServingEngine against the JAX
engine, in lockstep on the same tiny fp32 model and requests: after every
step the two engines agree on the step's return, every slot's generated
ids and speculation counters, the stats, the allocator's refcounts and
free list, the block tables (slots and lanes) and the stored positions of
both the target and the draft pool.

The mirrored cases are tests/test_speculative_engine.py's six: a
self-draft accepting all k every round, an unrelated draft accepting
about none, two requests speculating side by side, one step shape per
worker across accept swings and toggles, the lane lifecycle (clones of the
write window only, an atomic landing), and 100+ mixed rounds that leak no
block. Speculation never changes the greedy ids: each run's ids are also
the port's plain engine's."""

import gc
import itertools
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import speculative as js
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import speculative as ts
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax

STAT_FIELDS = ("steps", "completed", "preempted", "prefill_tokens",
               "tokens_generated", "cow_copies", "spec_rounds",
               "spec_accepted_tokens")



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny model's many
    small ops lose far more to thread start-up than they gain, above all
    beside other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
@pytest.fixture(scope="module")
def models():
    """tests/test_speculative_engine.py's tiny model and its "garbage"
    draft (the same config, other weights), as JAX params and port state
    dicts."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        init = jl.LlamaForCausalLM(jcfg).init
        params = meta.unbox(init(jax.random.key(0),
                                 jnp.zeros((1, 8), jnp.int32)))
        garbage = meta.unbox(init(jax.random.key(99),
                                  jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    sds = [params_from_jax(tcfg, jax.tree.map(np.asarray, p))
           for p in (params, garbage)]
    return (jcfg, params, garbage, tcfg) + tuple(sds)


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _ecfg(mod, **kw):
    base = dict(block_size=4, num_blocks=48, max_slots=2,
                max_blocks_per_seq=16, token_budget=12)
    base.update(kw)
    if mod is je and not base.get("quantized"):
        base.setdefault("kv_dtype", jnp.float32)
    return mod.EngineConfig(**base)


def _pair(models, k=3, nb=1, draft="self", **ekw):
    """The JAX and the port engine with the same speculation."""
    jcfg, params, garbage, tcfg, sd, gsd = models
    jkw, tkw = {}, {}
    if draft == "garbage":
        jkw = dict(draft_cfg=jcfg, draft_params=garbage)
        tkw = dict(draft_cfg=tcfg, draft_params=gsd)
    ps.initialize_model_parallel()
    jeng = je.ServingEngine(
        jcfg, params, _ecfg(je, speculation=js.SpeculationConfig(k, nb),
                            **ekw), clock=_clock(), **jkw)
    teng = te.ServingEngine(
        tcfg, sd, _ecfg(te, speculation=ts.SpeculationConfig(k, nb), **ekw),
        clock=_clock(), device="cpu", **tkw)
    return jeng, teng


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).tolist()


def _solo(models, prompt, max_new):
    """The port's plain engine (no speculation)."""
    _, _, _, tcfg, sd, _ = models
    eng = te.ServingEngine(tcfg, sd, _ecfg(te), device="cpu")
    eng.submit(prompt, max_new_tokens=max_new, uid="ref")
    return eng.run()["ref"].tokens


def _state(eng):
    a = eng.allocator
    return dict(
        tables=eng._tables.tolist(), allocator=(a._free, a._refs,
                                                a._allocated),
        stats={f: getattr(eng.stats, f) for f in STAT_FIELDS},
        slots=[None if s is None else
               (s.uid, s.n_cached, list(s.generated), s.spec_rounds,
                s.spec_accepted) for s in eng._slots],
        pos=np.asarray(eng.cache.pos).tolist(),
        dpos=np.asarray(eng.dcache.pos).tolist())


def _step_both(jeng, teng):
    n = jeng.step()
    assert teng.step() == n
    assert _state(teng) == _state(jeng)
    return n


def _drain_both(jeng, teng):
    while jeng.has_work() or teng.has_work():
        _step_both(jeng, teng)
    res = {u: (r.status, r.tokens, r.accept_rate)
           for u, r in teng.results.items()}
    assert res == {u: (r.status, r.tokens, r.accept_rate)
                   for u, r in jeng.results.items()}
    return teng.results


def _submit_both(jeng, teng, prompt, max_new, uid):
    jeng.submit(prompt, max_new_tokens=max_new, uid=uid)
    teng.submit(prompt, max_new_tokens=max_new, uid=uid)


def test_self_draft_full_accept_bit_identical(models):
    """Self-draft: every round accepts all k drafts, several tokens land
    a step, and the ids are the plain engine's."""
    prompt = _prompt(0, 7)
    ref = _solo(models, prompt, 12)
    jeng, teng = _pair(models, k=3)
    _submit_both(jeng, teng, prompt, 12, "a")
    res = _drain_both(jeng, teng)["a"]
    assert res.status == "completed" and res.tokens == ref
    assert teng.stats.spec_rounds > 0 and res.accept_rate == 1.0
    assert teng.stats.to_dict()["spec_accept_mean"] == 3.0
    assert teng.stats.steps < len(ref)


def test_garbage_draft_zero_accept_bit_identical(models):
    prompt = _prompt(1, 6)
    ref = _solo(models, prompt, 10)
    jeng, teng = _pair(models, k=3, draft="garbage")
    _submit_both(jeng, teng, prompt, 10, "a")
    res = _drain_both(jeng, teng)["a"]
    assert res.tokens == ref and teng.stats.spec_rounds > 0
    assert res.accept_rate is not None and res.accept_rate < 0.5


def test_two_requests_speculating_stay_independent(models):
    pa, pb = _prompt(2, 9), _prompt(3, 5)
    jeng, teng = _pair(models, k=3)
    _submit_both(jeng, teng, pa, 8, "a")
    _submit_both(jeng, teng, pb, 8, "b")
    res = _drain_both(jeng, teng)
    assert res["a"].tokens == _solo(models, pa, 8)
    assert res["b"].tokens == _solo(models, pb, 8)


def test_compile_once_across_accept_swings_and_toggles(models):
    """Accept swings (a garbage draft) and ``set_speculation`` flapping
    change which workers run, never what shape any worker sees."""
    jeng, teng = _pair(models, k=3, draft="garbage")
    for i, on in enumerate((True, False, True)):
        jeng.set_speculation(on)
        teng.set_speculation(on)
        assert teng.speculating == on
        prompt = _prompt(10 + i, 5 + i)
        _submit_both(jeng, teng, prompt, 6, f"r{i}")
        res = _drain_both(jeng, teng)[f"r{i}"]
        assert res.tokens == _solo(models, prompt, 6)
    assert teng.compile_count() == 1
    assert teng.worker_compile_counts() == {
        "packed": 1, "spec_draft": 1, "spec_verify": 1}
    assert teng.results["r1"].accept_rate is None
    # a plain engine's toggle is a no-op
    plain = te.ServingEngine(models[3], models[4], _ecfg(te), device="cpu")
    plain.set_speculation(True)
    assert not plain.speculating


def test_branch_lanes_share_prefix_and_land_atomically(models):
    """The round's lifecycle, white box, on both engines: lanes clone only
    the write window (the prefix stays shared by reference), and landing a
    verdict swaps the winner in while freeing the losers and the displaced
    originals in one allocator call."""
    k, nb = 3, 2
    jeng, teng = _pair(models, k=k, nb=nb, token_budget=16)
    _submit_both(jeng, teng, _prompt(4, 9), 20, "a")
    _step_both(jeng, teng)                       # prefill
    base_alloc = teng.allocator.num_allocated
    jrs, trs = jeng._begin_spec_round(), teng._begin_spec_round()
    assert teng._tables.tolist() == jeng._tables.tolist()
    assert teng._pending_cow == jeng._pending_cow
    assert len(trs) == 1 and trs[0] is not None
    req, lane_blocks, blk0, blk_last = trs[0]
    assert (lane_blocks, blk0, blk_last) == tuple(jrs[0][1:])
    e = teng.ecfg
    assert teng.allocator.num_allocated == base_alloc + nb * (
        blk_last - blk0 + 1)
    assert teng.stats.cow_copies > 0
    for b in range(nb):
        lane = e.max_slots + b
        assert (teng._tables[lane, :blk0]
                == teng._tables[req.slot, :blk0]).all()
        for bi in range(blk0, blk_last + 1):
            assert teng._tables[lane, bi] != teng._tables[req.slot, bi]
    assert set(lane_blocks[0]).isdisjoint(lane_blocks[1])
    grown = sum(1 for bi in range(blk0, blk_last + 1)
                if int(teng._tables[req.slot, bi]) < 0)
    win = list(lane_blocks[1])
    emit = np.asarray([[7, 8, 9, 10]])
    for eng, rs in ((jeng, jrs), (teng, trs)):
        eng._land_spec_round(rs, emit, np.asarray([k]), np.asarray([1]),
                             0.0)
    assert teng.allocator.num_allocated == base_alloc + grown
    assert [int(teng._tables[req.slot, bi])
            for bi in range(blk0, blk_last + 1)] == win
    assert req.generated[-(k + 1):] == [7, 8, 9, 10]
    assert (teng._tables[e.max_slots:, :] == -1).all()
    assert teng._tables.tolist() == jeng._tables.tolist()
    assert (teng.allocator._refs, teng.allocator._free) == (
        jeng.allocator._refs, jeng.allocator._free)


def test_hundred_mixed_accept_rounds_leak_no_blocks(models):
    """100+ rounds with a garbage draft over two branches (mixed accept
    lengths) across overlapping requests: the pool drains to zero and
    every table row is unmapped."""
    jeng, teng = _pair(models, k=3, nb=2, draft="garbage", token_budget=16)
    for i in range(6):
        _submit_both(jeng, teng, _prompt(20 + i, 4 + (i % 3)), 30,
                     f"r{i}")
        _step_both(jeng, teng)
    res = _drain_both(jeng, teng)
    assert {r.status for r in res.values()} == {"completed"}
    for i in range(6):
        assert res[f"r{i}"].tokens == _solo(
            models, _prompt(20 + i, 4 + (i % 3)), 30)
    assert teng.stats.spec_rounds >= 100
    assert teng.compile_count() == 1
    assert teng.allocator.num_allocated == 0
    assert (teng._tables == -1).all()


SCENARIOS = {
    # an int8 pool: the clones copy the scales of both pools too
    "int8_pool": (dict(k=2, nb=2, quantized=True),
                  [(30, 6, 9), (31, 10, 7)]),
    # a pool so small that lanes cannot always be had (those slots decode
    # plainly) and requests are preempted
    "pool_pressure": (dict(k=3, nb=2, num_blocks=8, max_blocks_per_seq=8,
                           draft="garbage"),
                      [(40, 7, 10), (41, 9, 9), (42, 5, 6)]),
    # shared prompt prefixes: trie blocks under the lanes' clones
    "prefix_sharing": (dict(k=3, nb=1, prefix_sharing=True),
                       [(50, 9, 6), (50, 9, 6), (51, 5, 6)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_scenarios_match_jax_step_by_step(models, name):
    kw, reqs = SCENARIOS[name]
    jeng, teng = _pair(models, **kw)
    for i, (seed, n, new) in enumerate(reqs):
        _submit_both(jeng, teng, _prompt(seed, n), new, f"r{i}")
        _step_both(jeng, teng)
    res = _drain_both(jeng, teng)
    for i, (seed, n, new) in enumerate(reqs):
        assert res[f"r{i}"].tokens == _solo(models, _prompt(seed, n), new)
    assert teng.stats.spec_rounds > 0
    assert teng.compile_count() == 1
    if name == "pool_pressure":
        assert teng.stats.preempted > 0
    if name == "prefix_sharing":
        assert teng.stats.prefix_hit_tokens > 0
        teng.release_prefix_cache()
    assert teng.allocator.num_allocated == 0


def test_speculation_refuses_what_jax_refuses(models):
    _, _, _, tcfg, sd, _ = models
    spec = ts.SpeculationConfig(2, 1)
    for kw in (dict(sampling=te.SamplingConfig(greedy=False)),
               dict(disaggregated=True)):
        with pytest.raises(ValueError):
            te.ServingEngine(tcfg, sd, _ecfg(te, speculation=spec, **kw),
                             device="cpu")


@pytest.mark.parametrize("draft", [None, "self", "garbage"])
def test_engine_is_freed_without_gc(models, draft):
    """``del`` alone frees an engine's model, pools and draft (no
    reference cycle through its workers or compile trackers): the card
    needs the memory back before the next model is built."""
    _, _, _, tcfg, sd, gsd = models
    kw = dict(draft_cfg=tcfg, draft_params=gsd) if draft == "garbage" \
        else {}
    spec = ts.SpeculationConfig(2, 2) if draft else None
    gc.collect()
    gc.disable()
    try:
        eng = te.ServingEngine(tcfg, sd, _ecfg(te, speculation=spec),
                               device="cpu", **kw)
        eng.submit(_prompt(60, 5), 6, uid="a")
        eng.run()
        refs = [weakref.ref(x) for x in (eng, eng.model, eng.cache.k)]
        if draft:
            refs += [weakref.ref(eng.draft_model), weakref.ref(eng.dcache.k)]
        del eng
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()
