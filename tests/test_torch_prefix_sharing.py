"""The PyTorch port's prefix sharing against the JAX package: the prefix
trie driven through the same calls gives the same returns and allocator
state, ``cow_copy_blocks`` writes the same pool bit for bit (fp and int8),
and the engine with ``prefix_sharing=True`` matches the JAX engine step by
step: greedy ids, stats, the allocator's refcounts and free list, the block
tables and the pool's stored positions."""

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
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import paging as tpg
from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax

SYS = list(range(1, 13))                 # 12 tokens = 3 full blocks of 4
STAT_FIELDS = ("steps", "completed", "preempted", "prefill_tokens",
               "tokens_generated", "cow_copies", "prefix_hit_tokens")


def _allocator_state(a):
    return a._free, a._refs, a._allocated


# ---------------------------------------------------------------------------
# the prefix trie
# ---------------------------------------------------------------------------

class _Trie:
    """One package's allocator and trie, driven by package-neutral calls;
    each call returns what the trie returned, chain hashes left out (they
    are per process), named by the caller's own chain handles instead."""

    def __init__(self, mod, num_blocks, block_size):
        self.alloc = mod.BlockAllocator(num_blocks)
        self.pc = mod.PrefixCache(self.alloc, block_size)
        self.chains = {None: None}

    def __call__(self, op, *args):
        if op == "alloc":
            return self.alloc.alloc(*args)
        if op == "free":
            return self.alloc.free(*args)
        if op == "insert":
            name, parent, tokens, block = args
            chain, inserted = self.pc.insert(self.chains[parent], tokens,
                                             block)
            self.chains[name] = chain
            return chain is None, inserted
        if op == "match":
            name, prompt, max_tokens = args
            full, matched, partial, chain = self.pc.match(prompt, max_tokens)
            self.chains[name] = chain
            return full, matched, partial, chain is None
        if op == "lookup":
            return self.pc.lookup(*args)
        if op == "evict":
            return self.pc.evict(*args)
        if op == "clear":
            return self.pc.clear()
        raise ValueError(op)


def _script_jax_tests():
    """The calls of the JAX package's own trie tests
    (``tests/test_prefix_sharing.py``): match with a partial tail, an
    idempotent insert, an insert under an evicted parent, LRU leaves."""
    s = [("alloc", 3)]
    parent = None
    for i in range(3):
        s.append(("insert", f"c{i}", parent, SYS[i * 4:(i + 1) * 4], i))
        parent = f"c{i}"
    s += [("match", "m0", SYS + [99, 98], 13),
          ("match", "m1", SYS[:8] + [9, 10, 77, 78], 11),
          ("insert", "again", None, SYS[:4], 99),
          ("lookup", SYS[:8] + [9, 10, 5], 11),
          ("evict", 3), ("free", [0, 1, 2]),
          ("insert", "orphan", "c2", [50, 51, 52, 53], 0),
          ("alloc", 3)]
    parent = None
    for i in range(3):
        s.append(("insert", f"d{i}", parent, [10 + i] * 4,
                  ("last_alloc", i)))
        parent = f"d{i}"
    s += [("free", ("last_alloc",)), ("match", "m2", [10] * 4, 4),
          ("evict", 2), ("lookup", [10] * 4 + [11] * 2, 6), ("clear",)]
    return 8, 4, s


def _script_random(seed):
    """Prompts over a 3-token vocabulary (so prefixes collide often) are
    matched, their new full blocks inserted on freshly allocated blocks,
    the caller's refs dropped; evictions and lookups in between."""
    rng = np.random.RandomState(seed)
    bs, s = 2, []
    for step in range(40):
        prompt = rng.randint(0, 3, rng.randint(1, 9)).tolist()
        s.append(("match", f"m{step}", prompt, len(prompt) - 1))
        s.append(("lookup", prompt, len(prompt)))
        parent = None
        for i in range(len(prompt) // bs):
            s.append(("alloc", 1))
            s.append(("insert", f"i{step}.{i}", parent,
                      prompt[i * bs:(i + 1) * bs], ("last_alloc", 0)))
            s.append(("free", ("last_alloc",)))
            parent = f"i{step}.{i}"
        if rng.rand() < 0.3:
            s.append(("evict", int(rng.randint(1, 4))))
    s.append(("clear",))
    return 256, bs, s


@pytest.mark.parametrize("script", ["jax_tests", "random0", "random1"])
def test_prefix_cache_matches_jax(script):
    num_blocks, bs, calls = (_script_jax_tests() if script == "jax_tests"
                             else _script_random(int(script[-1])))
    sides = [_Trie(jpg, num_blocks, bs), _Trie(tpg, num_blocks, bs)]
    last = [None, None]
    for call in calls:
        outs = []
        for i, side in enumerate(sides):
            # ("last_alloc",) names the blocks of this side's last alloc,
            # ("last_alloc", j) the j-th of them
            args = [(last[i] if len(a) == 1 else last[i][a[1]])
                    if isinstance(a, tuple) and a[:1] == ("last_alloc",)
                    else a for a in call[1:]]
            out = side(call[0], *args)
            if call[0] == "alloc":
                last[i] = out
            outs.append(out)
        assert outs[1] == outs[0], call
        assert (_allocator_state(sides[1].alloc)
                == _allocator_state(sides[0].alloc)), call
        assert sides[1].pc.size == sides[0].pc.size, call
    assert sides[1].alloc.num_allocated == 0


# ---------------------------------------------------------------------------
# copy-on-write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_cow_copy_blocks_matches_jax_bitwise(quantized):
    """Five live clones (one a source that is also another's destination)
    into a 12-block pool; JAX gets them padded to 8 entries with ``dst ==
    num_blocks``, the port only the live ones."""
    rng = np.random.RandomState(4)
    nl, nb, bs, kv, d = 2, 12, 4, 2, 8
    shape = (nl, nb, bs, kv, d)
    if quantized:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        scales = [rng.rand(*shape[:-1]).astype(np.float32) for _ in "kv"]
    else:
        k, v = (rng.randn(*shape).astype(np.float32) for _ in "kv")
    pos = rng.randint(0, 40, (nb, bs)).astype(np.int32)
    pos[3, 2:] = PAD_POSITION
    src, dst, keep = [1, 3, 5, 7, 9], [2, 4, 6, 8, 1], [10, 30, 0, 41, 20]
    if quantized:
        jc = jpg.init_quantized_paged_kv_cache(nl, nb, bs, kv, d, 2, 3)
        jc = jc.replace(k_scale=jnp.asarray(scales[0]),
                        v_scale=jnp.asarray(scales[1]))
        tc = tpg.init_quantized_paged_kv_cache(nl, nb, bs, kv, d, 2, 3,
                                               device="cpu")
        tc.k_scale.copy_(torch.from_numpy(scales[0]))
        tc.v_scale.copy_(torch.from_numpy(scales[1]))
    else:
        jc = jpg.init_paged_kv_cache(nl, nb, bs, kv, d, 2, 3,
                                     dtype=jnp.float32)
        tc = tpg.init_paged_kv_cache(nl, nb, bs, kv, d, 2, 3,
                                     dtype=torch.float32, device="cpu")
    jc = jc.replace(k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.asarray(pos))
    for name, a in (("k", k), ("v", v), ("pos", pos)):
        getattr(tc, name).copy_(torch.from_numpy(a))
    pad = 8 - len(src)
    jc = jpg.cow_copy_blocks(
        jc, jnp.asarray(src + [0] * pad, jnp.int32),
        jnp.asarray(dst + [nb] * pad, jnp.int32),
        jnp.asarray(keep + [0] * pad, jnp.int32))
    out = tpg.cow_copy_blocks(tc, src, dst, keep)
    assert out is tc
    names = ("k", "v", "pos") + (("k_scale", "v_scale") if quantized else ())
    for name in names:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    # the clone of block 5 into 6 kept nothing (keep_upto 0); 1 -> 2 read
    # block 1 before 9 -> 1 overwrote it
    assert (tc.pos[6] == PAD_POSITION).all()
    np.testing.assert_array_equal(tc.k[:, 2].numpy(), k[:, 1])


# ---------------------------------------------------------------------------
# the engine, step by step against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The tests/test_prefix_sharing.py tiny model, as JAX params and the
    port's state dict."""
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
    base = dict(block_size=4, num_blocks=32, max_slots=4,
                max_blocks_per_seq=12, token_budget=16, prefix_sharing=True)
    base.update(kw)
    return mod.EngineConfig(**base)


def _engines(models, **ekw):
    jcfg, params, tcfg, sd = models
    ps.initialize_model_parallel()
    jkw = dict(ekw)
    jkw.setdefault("kv_dtype", None if ekw.get("quantized") else jnp.float32)
    return (je.ServingEngine(jcfg, params, _ecfg(je, **jkw), clock=_clock()),
            te.ServingEngine(tcfg, sd, _ecfg(te, **ekw), clock=_clock(),
                             device="cpu"))


def _state(eng):
    """Everything the two engines must agree on after a step."""
    return dict(
        tables=eng._tables.tolist(),
        allocator=_allocator_state(eng.allocator),
        stats={f: getattr(eng.stats, f) for f in STAT_FIELDS},
        trie=eng.prefix_cache.size if eng.prefix_cache else None,
        slots=[None if s is None else
               (s.uid, s.n_cached, s.shared_tokens, s.trie_blocks,
                list(s.generated)) for s in eng._slots],
        pos=np.asarray(eng.cache.pos).tolist())


def _lockstep(jeng, teng, waves):
    """Submit each wave of ``(uid, prompt, max_new)`` to both engines and
    step both until they drain, comparing their state after every step."""
    for wave in waves:
        for uid, prompt, n in wave:
            jeng.submit(prompt, n, uid=uid)
            teng.submit(prompt, n, uid=uid)
        while jeng.has_work() or teng.has_work():
            assert jeng.step() == teng.step()
            assert _state(teng) == _state(jeng)
    tres = {u: (r.status, r.tokens) for u, r in teng.results.items()}
    assert tres == {u: (r.status, r.tokens)
                    for u, r in jeng.results.items()}
    assert {s for s, _ in tres.values()} == {"completed"}
    return tres


PREFIX_SCENARIOS = {
    # tests/test_prefix_sharing.py:148: one request after another, each
    # sees the earlier ones' trie (full hit, then a miss)
    "hit_then_miss": (
        [[("r0", SYS, 3)], [("r1", SYS + [20, 21, 22], 4)],
         [("r2", [77, 78, 79, 80, 81], 4)]], {}),
    # :169: two live sharers, one diverging mid-block (copy-on-write)
    "cow_concurrent": (
        [[("a", SYS + [20, 21, 22, 23, 24], 4)],
         [("a2", SYS + [20, 21, 22, 23, 24], 4),
          ("b", SYS + [20, 21, 40, 41], 4)]], {}),
    "cow_concurrent_int8": (
        [[("a", SYS + [20, 21, 22, 23, 24], 4)],
         [("a2", SYS + [20, 21, 22, 23, 24], 4),
          ("b", SYS + [20, 21, 40, 41], 4)]], dict(quantized=True)),
    # :191 without evict: an 8-block pool, trie eviction and preemption
    "pool_pressure": (
        [[("seed", SYS[:8], 1)],
         [("p0", SYS[:8] + [30, 31], 6), ("p1", SYS[:8] + [40, 41], 6),
          ("p2", SYS[:8] + [50, 51], 6)]],
        dict(num_blocks=8, max_slots=2, token_budget=8)),
    # the same with 5 blocks: the sharers' growth preempts one of them
    "pool_pressure_tight": (
        [[("seed", SYS[:8], 1)],
         [("p0", SYS[:8] + [30, 31], 6), ("p1", SYS[:8] + [40, 41], 6)]],
        dict(num_blocks=5, max_slots=2, token_budget=8)),
    # a cold prompt needs the blocks the trie holds alone: its leaves are
    # evicted (and actually free) before anything is preempted
    "trie_eviction": (
        [[("warm", SYS[:8], 1)], [("warm2", [70] * 9, 1)],
         [("cold", [90 + i for i in range(12)], 8)]],
        dict(num_blocks=6, max_slots=2, token_budget=8)),
    # :229: disaggregated prefill and decode workers over shared blocks
    "disaggregated": (
        [[("d0", SYS + [20], 4)],
         [(f"d{i}", SYS + [20 + i], 4) for i in (1, 2, 3)]],
        dict(disaggregated=True, prefill_budget=8)),
    # more sharers than slots, partial tails in several blocks
    "queue_of_sharers": (
        [[("s0", SYS + [5, 6], 3)],
         [(f"s{i}", SYS[:4 + i] + [60 + i] * 3, 3) for i in range(1, 7)]],
        dict(max_slots=3)),
}


@pytest.mark.parametrize("name", sorted(PREFIX_SCENARIOS))
def test_prefix_sharing_engine_matches_jax(models, name):
    waves, ekw = PREFIX_SCENARIOS[name]
    jeng, teng = _engines(models, **ekw)
    tres = _lockstep(jeng, teng, waves)
    assert teng.compile_count() == 1
    if name != "trie_eviction":
        assert teng.stats.prefix_hit_tokens > 0
    if name.startswith("cow"):
        assert teng.stats.cow_copies >= 1
    if name == "pool_pressure_tight":
        assert teng.stats.preempted >= 1
    if name == "trie_eviction":
        # the warm prompts' 4 blocks lost at least 3 to the cold prompt
        assert teng.stats.preempted == 0
        assert (teng.prefix_lookup(SYS[:8] + [0])
                + teng.prefix_lookup([70] * 9)) <= 4
    if ekw.get("disaggregated"):
        assert teng.worker_compile_counts() == {"prefill": 1, "decode": 1}
    rep, jrep = teng.stats.report(), jeng.stats.report()
    for key in ("prefix_hit_rate", "cow_copies"):
        assert rep[key] == jrep[key], key
    prompts = {u: p for wave in waves for u, p, _ in wave}
    for uid, prompt in prompts.items():
        assert teng.prefix_lookup(prompt) == jeng.prefix_lookup(prompt)
    teng.release_prefix_cache()
    jeng.release_prefix_cache()
    assert teng.allocator.num_allocated == 0
    assert _allocator_state(teng.allocator) == _allocator_state(
        jeng.allocator)
    # JAX's own claim: sharing changes no greedy id
    solo = te.ServingEngine(models[2], models[3],
                            _ecfg(te, **dict(ekw, prefix_sharing=False)),
                            device="cpu")
    for wave in waves:
        for uid, prompt, n in wave:
            solo.submit(prompt, n, uid=uid)
        solo.run()
    assert {u: r.tokens for u, r in solo.results.items()} == {
        u: t for u, (_, t) in tres.items()}


def test_cow_runs_before_the_freed_position_wipe(models):
    """A four-block pool whose trie holds SYS's three blocks. ``b`` maps
    them, the third partially, and clones that one (copy-on-write) into
    the last free block; ``c``, admitted in the same pass, finds the pool
    dry, and the trie's eviction frees the clone's source for it. The clone
    must read the source's positions before the freed-block wipe clears
    them, or ``b`` loses tokens 9 and 10 from its attention."""
    jeng, teng = _engines(models, num_blocks=4, max_slots=2, token_budget=8)
    _lockstep(jeng, teng, [[("a", SYS, 1)],
                           [("b", SYS[:8] + [9, 10, 77, 78], 3),
                            ("c", list(range(200, 206)), 2)]])
    assert teng.stats.cow_copies == 1 and teng.stats.preempted >= 1


def test_pending_clones_run_in_one_call_and_the_later_owner_wins(
        models, monkeypatch):
    """All pending clones go to ``cow_copy_blocks`` in one call, however
    many there are; a clone whose dst was handed out again in the same
    pass (its slot preempted) gives way to the later clone into that dst,
    as the reference's chunks in order leave it."""
    _, _, tcfg, sd = models
    eng = te.ServingEngine(tcfg, sd, _ecfg(te, max_slots=2), device="cpu")
    gen = torch.Generator().manual_seed(0)
    eng.cache.k.copy_(torch.randn(eng.cache.k.shape, generator=gen))
    eng.cache.pos.copy_(torch.arange(eng.cache.pos.numel(),
                                     dtype=torch.int32).view_as(
                                         eng.cache.pos))
    before_k, before_pos = eng.cache.k.clone(), eng.cache.pos.clone()
    calls = []

    def recording(cache, src, dst, keep):
        calls.append((list(src), list(dst), list(keep)))
        return tpg.cow_copy_blocks(cache, src, dst, keep)

    monkeypatch.setattr(te, "cow_copy_blocks", recording)
    eng._apply_pending_cow()
    assert calls == []
    eng._pending_cow = [(1, 9, 5), (2, 10, 99), (3, 11, 0), (4, 9, 18)]
    eng._apply_pending_cow()
    assert calls == [([4, 2, 3], [9, 10, 11], [18, 99, 0])]
    assert eng._pending_cow == []
    assert torch.equal(eng.cache.k[:, 9], before_k[:, 4])
    assert eng.cache.pos[9].tolist() == [16, 17, PAD_POSITION, PAD_POSITION]
    assert torch.equal(eng.cache.pos[10], before_pos[2])
    assert (eng.cache.pos[11] == PAD_POSITION).all()


def test_engine_without_sharing_has_no_trie(models):
    _, _, tcfg, sd = models
    eng = te.ServingEngine(tcfg, sd, _ecfg(te, prefix_sharing=False),
                           device="cpu")
    assert eng.prefix_cache is None and eng.prefix_lookup(SYS) == 0
    eng.release_prefix_cache()
    eng.submit(SYS, 2, uid="x")
    eng.submit(SYS, 2, uid="y")
    eng.run()
    rep = eng.stats.report()
    assert rep["prefix_hit_tokens"] == 0 and rep["cow_copies"] == 0
    assert rep["prefix_hit_rate"] == 0.0
