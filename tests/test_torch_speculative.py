"""The PyTorch port's speculation helpers and the paging helpers that
migration and speculation use, against the JAX package on the same
numpy-seeded inputs: the accept rules, the Medusa tree, the branch split's
top-k on tied logits, ``mask_pool_positions``, ``extract_blocks`` /
``inject_blocks`` (fp32, bf16 and int8 pools), ``pool_accounting``, the
trie's ``snapshot`` / ``chain_of`` and ``SessionTicket``'s wire bytes (each
package reading the other's) bit for bit; ``speculative_generate``
and ``medusa_generate`` give JAX's greedy ids and stats, and the Medusa
heads JAX's logits within 1e-5 (fp32, summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import generation as jg
from neuronx_distributed_tpu.inference import paging as jpg
from neuronx_distributed_tpu.inference import speculative as js
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.resilience import integrity as ji
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import generation as tg
from neuronx_distributed_tpu_torch.inference import paging as tpg
from neuronx_distributed_tpu_torch.inference import speculative as ts
from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import (
    medusa_params_from_jax, params_from_jax)
from neuronx_distributed_tpu_torch.resilience import integrity as ti
from neuronx_distributed_tpu_torch.utils.bfloat16 import BF16Words


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# accept rules and the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_draft_greedy_matches_jax(seed):
    rng = np.random.RandomState(seed)
    b, k, v = 6, 4, 7
    logits = rng.randn(b, k + 1, v).astype(np.float32)
    greedy = logits.argmax(-1)
    # drafts agree with the target's choice for a random number of leading
    # positions, then at random
    drafts = rng.randint(0, v, (b, k))
    for i in range(b):
        n = rng.randint(0, k + 1)
        drafts[i, :n] = greedy[i, :n]
    ja, jgd = js.verify_draft_greedy(jnp.asarray(logits), jnp.asarray(drafts))
    ta, tgd = ts.verify_draft_greedy(torch.from_numpy(logits),
                                     torch.from_numpy(drafts))
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    np.testing.assert_array_equal(tgd.numpy(), _np(jgd))


def test_verify_draft_greedy_boundaries():
    """tests/test_speculative_engine.py's k-boundary cases: a fully
    accepted round emits the bonus once, a fully rejected one the
    target's correction."""
    greedy, k = [5, 9, 2, 7], 3
    logits = torch.nn.functional.one_hot(torch.tensor([greedy]), 16).float()
    acc, nxt = ts.verify_draft_greedy(logits, torch.tensor([greedy[:k]]))
    assert int(acc[0]) == k and nxt[0].tolist() == greedy
    acc, nxt = ts.verify_draft_greedy(
        logits, torch.tensor([[(g + 1) % 16 for g in greedy[:k]]]))
    assert int(acc[0]) == 0 and int(nxt[0, 0]) == greedy[0]


TREES = {
    "k1b1": ts.SpeculationConfig(1, 1).tree_choices(),
    "k3b2": ts.SpeculationConfig(3, 2).tree_choices(),
    "k4b3": ts.SpeculationConfig(4, 3).tree_choices(),
    "medusa": ((0,), (1,), (0, 0), (0, 1), (1, 0), (0, 0, 0)),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_build_medusa_tree_matches_jax(tree):
    jb = js.build_medusa_tree(TREES[tree])
    tb = ts.build_medusa_tree(TREES[tree])
    for f in ("tree_mask", "tree_positions", "parent", "head_of_node"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)), f)


@pytest.mark.parametrize("k,nb", [(1, 1), (3, 2), (4, 3), (2, 5)])
def test_speculation_config_and_branches_match_jax(k, nb):
    jc, tc = js.SpeculationConfig(k, nb), ts.SpeculationConfig(k, nb)
    assert tc.tree_choices() == jc.tree_choices()
    assert tc.tree_size == jc.tree_size
    np.testing.assert_array_equal(ts.branch_of_nodes(tc).numpy(),
                                  _np(js.branch_of_nodes(jc)))


def test_speculation_config_refuses_what_jax_refuses():
    for kw in (dict(speculation_length=0), dict(num_branches=0)):
        with pytest.raises(ValueError):
            js.SpeculationConfig(**kw)
        with pytest.raises(ValueError):
            ts.SpeculationConfig(**kw)


@pytest.mark.parametrize("tree,seed", [("k3b2", 0), ("k4b3", 1),
                                       ("medusa", 2), ("k1b1", 3)])
def test_medusa_accept_longest_matches_jax(tree, seed):
    """A small vocabulary and tokens copied from the parent's greedy
    choice with probability 0.7, so that paths of every depth win."""
    rng = np.random.RandomState(seed)
    choices = TREES[tree]
    t, b, v = len(choices) + 1, 16, 5
    jb, tb = js.build_medusa_tree(choices), ts.build_medusa_tree(choices)
    parent = _np(jb.parent)
    logits = rng.randn(b, t, v).astype(np.float32)
    greedy = logits.argmax(-1)
    tokens = rng.randint(0, v, (b, t))
    for j in range(1, t):
        hit = rng.rand(b) < 0.7
        tokens[hit, j] = greedy[hit, parent[j]]
    jbest, jlen = js.medusa_accept_longest(jnp.asarray(logits),
                                           jnp.asarray(tokens), jb)
    tbest, tlen = ts.medusa_accept_longest(torch.from_numpy(logits),
                                           torch.from_numpy(tokens), tb)
    np.testing.assert_array_equal(tbest.numpy(), _np(jbest))
    np.testing.assert_array_equal(tlen.numpy(), _np(jlen))
    assert len(set(tlen.tolist())) > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_branch_topk_on_tied_logits_matches_jax(dtype, seed):
    """The draft worker's branch split: logits from three values, so that
    nearly every row ties; the indices equal ``jax.lax.top_k``'s."""
    rng = np.random.RandomState(seed)
    logits = rng.randint(0, 3, (12, 40)).astype(np.float32)
    jl_ = jnp.asarray(logits, getattr(jnp, dtype))
    tl_ = torch.from_numpy(logits).to(getattr(torch, dtype))
    for k in (1, 2, 3, 5):
        np.testing.assert_array_equal(ts.top_k_indices(tl_, k).numpy(),
                                      _np(jax.lax.top_k(jl_, k)[1]))


# ---------------------------------------------------------------------------
# paging helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_pool_positions_matches_jax(seed):
    rng = np.random.RandomState(seed)
    nb, bs, t = 6, 4, 30
    pos = rng.randint(0, 50, (nb, bs)).astype(np.int32)
    pos[2, 1:] = PAD_POSITION
    flat = rng.randint(0, nb * bs + 1, t).astype(np.int32)  # some == cap
    reject = rng.rand(t) < 0.5
    want = jpg.mask_pool_positions(jnp.asarray(pos), jnp.asarray(flat),
                                   jnp.asarray(reject))
    tpos = torch.from_numpy(pos.copy())
    out = tpg.mask_pool_positions(tpos, torch.from_numpy(flat),
                                  torch.from_numpy(reject))
    assert out is tpos
    np.testing.assert_array_equal(tpos.numpy(), _np(want))


def _pools(kind, rng, nl=2, nb=8, bs=4, kv=2, d=8):
    """The same random pool in both packages."""
    shape = (nl, nb, bs, kv, d)
    pos = rng.randint(0, 40, (nb, bs)).astype(np.int32)
    pos[5, 2:] = PAD_POSITION
    if kind == "int8":
        j = jpg.init_quantized_paged_kv_cache(nl, nb, bs, kv, d, 3, 4)
        t = tpg.init_quantized_paged_kv_cache(nl, nb, bs, kv, d, 3, 4,
                                              device="cpu")
        vals = {"k": rng.randint(-127, 128, shape).astype(np.int8),
                "v": rng.randint(-127, 128, shape).astype(np.int8),
                "k_scale": rng.rand(*shape[:-1]).astype(np.float32),
                "v_scale": rng.rand(*shape[:-1]).astype(np.float32)}
    else:
        jdt, tdt = ((jnp.float32, torch.float32) if kind == "fp32"
                    else (jnp.bfloat16, torch.bfloat16))
        j = jpg.init_paged_kv_cache(nl, nb, bs, kv, d, 3, 4, dtype=jdt)
        t = tpg.init_paged_kv_cache(nl, nb, bs, kv, d, 3, 4, dtype=tdt,
                                    device="cpu")
        vals = {n: rng.randn(*shape).astype(np.float32) for n in "kv"}
    vals["pos"] = pos
    j = j.replace(**{n: jnp.asarray(a, getattr(j, n).dtype)
                     for n, a in vals.items()})
    for n, a in vals.items():
        getattr(t, n).copy_(torch.from_numpy(a).to(getattr(t, n).dtype))
    return j, t


def _words(a):
    """Comparable bits of a payload array (bf16 as its 16-bit words)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_extract_and_inject_blocks_match_jax(kind):
    rng = np.random.RandomState({"fp32": 0, "bf16": 1, "int8": 2}[kind])
    j, t = _pools(kind, rng)
    blocks, keep = [6, 1, 3, 5], 20
    jp = jpg.extract_blocks(j, blocks, keep_upto=keep)
    tp = tpg.extract_blocks(t, blocks, keep_upto=keep)
    assert list(tp) == list(jp)
    for name in jp:
        assert tp[name].shape == jp[name].shape, name
        np.testing.assert_array_equal(_words(tp[name]), _words(jp[name]),
                                      name)
    if kind == "bf16":
        assert isinstance(tp["k"], BF16Words)
    assert (tp["pos"] < keep).sum() + (tp["pos"] == PAD_POSITION).sum() \
        == tp["pos"].size
    # land the port's payload in both packages at other block ids
    j2, t2 = _pools(kind, np.random.RandomState(9))
    dst = [0, 7, 2, 4]
    jout = jpg.inject_blocks(j2, dst, {
        n: (np.asarray(a).view(jnp.bfloat16) if isinstance(a, BF16Words)
            else a) for n, a in tp.items()})
    tout = tpg.inject_blocks(t2, dst, tp)
    assert tout is t2
    for name in list(tp):
        np.testing.assert_array_equal(
            _words(getattr(t2, name).view(torch.int16).numpy()
                   if getattr(t2, name).dtype == torch.bfloat16
                   else getattr(t2, name).numpy()),
            _words(np.asarray(getattr(jout, name)).view(np.int16)
                   if kind == "bf16" and name in "kv"
                   else getattr(jout, name)), name)
    with pytest.raises(ValueError):
        tpg.inject_blocks(t2, dst[:2], tp)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_ticket_bytes_are_jax_bytes(kind):
    """The same payload (the same pool in both packages, three blocks
    extracted by each) in the same ticket gives JAX's bytes, and each
    package reads the other's."""
    j, t = _pools(kind, np.random.RandomState(
        {"fp32": 0, "bf16": 1, "int8": 2}[kind]))
    jkv = jpg.extract_blocks(j, [4, 0, 2], keep_upto=17)
    tkv = tpg.extract_blocks(t, [4, 0, 2], keep_upto=17)
    fields = dict(uid="s1", prompt=[3, 1, 4, 1, 5], generated=[9, 2],
                  max_new_tokens=8, n_cached=6, age_s=0.25, ttft_s=0.125,
                  n_blocks=3, trace={"uid": "s1", "migrations": 1})
    jt = je.SessionTicket(kv=jkv, kv_fp=ji.kv_payload_fingerprints(
        jkv, jpg.PAYLOAD_BLOCK_AXES), **fields)
    tt = te.SessionTicket(kv=tkv, kv_fp=ti.kv_payload_fingerprints(
        tkv, tpg.PAYLOAD_BLOCK_AXES), **fields)
    assert tt.kv_fp == jt.kv_fp
    raw = tt.to_bytes()
    assert raw == jt.to_bytes()
    # each package reads the other's bytes
    back_j = je.SessionTicket.from_bytes(raw)
    back_t = te.SessionTicket.from_bytes(jt.to_bytes())
    for back in (back_j, back_t):
        assert back.kv_fp == tt.kv_fp and back.trace == fields["trace"]
        assert (back.uid, back.n_cached, back.ttft_s) == ("s1", 6, 0.125)
        for name in jkv:
            np.testing.assert_array_equal(_words(back.kv[name]),
                                          _words(jkv[name]), name)
    if kind == "bf16":
        assert isinstance(back_t.kv["k"], BF16Words)
    assert ti.kv_payload_fingerprints(back_t.kv, tpg.PAYLOAD_BLOCK_AXES) \
        == jt.kv_fp
    assert te.SessionTicket.from_bytes(back_t.to_bytes()).to_bytes() == raw


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_bytes=4), dict(quantized=True), dict(tp_size=2),
    dict(cp_size=4, quantized=True)])
def test_pool_accounting_matches_jax(kw):
    args = (32, 2048, 16, 8, 128)
    assert tpg.pool_accounting(*args, **kw) == jpg.pool_accounting(*args,
                                                                   **kw)
    with pytest.raises(ValueError):
        tpg.pool_accounting(*args, cp_size=0)


def test_prefix_snapshot_and_chain_of_match_jax():
    """Both tries take the same inserts and matches (so the same recency
    ticks); snapshots at several sizes and ``chain_of`` agree."""
    sides = []
    for mod in (jpg, tpg):
        alloc = mod.BlockAllocator(32)
        pc = mod.PrefixCache(alloc, 2)
        chains = {}
        for name, parent, toks in [
                ("a", None, (1, 2)), ("b", "a", (3, 4)), ("c", "b", (5, 6)),
                ("d", "a", (7, 8)), ("e", None, (9, 9)), ("f", "e", (1, 1)),
                ("g", "d", (2, 2))]:
            blk = alloc.alloc(1)[0]
            chains[name], _ = pc.insert(chains.get(parent), toks, blk)
            alloc.free([blk])
        pc.match([9, 9, 1, 1, 5], 4)          # the e/f path is hottest
        pc.match([1, 2, 7, 8], 3)
        sides.append((pc, chains))
    (jpc, jch), (tpc, tch) = sides
    for n in (None, 1, 2, 4, 5, 7):
        assert tpc.snapshot(n) == jpc.snapshot(n), n
    for parent, toks in [(None, (1, 2)), ("a", (3, 4)), ("a", (3, 5)),
                         ("e", (1, 1)), (None, (5, 5))]:
        want = jpc.chain_of(jch.get(parent), toks)
        got = tpc.chain_of(tch.get(parent), toks)
        assert (got is None) == (want is None)
        assert got == want


# ---------------------------------------------------------------------------
# contiguous-cache speculative generation
# ---------------------------------------------------------------------------


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
    """The tests/test_inference.py tiny model (2 layers) and a 1-layer
    draft, as JAX params and the port's models."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
        dcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=1)
        dparams = meta.unbox(jl.LlamaForCausalLM(dcfg).init(
            jax.random.key(12), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    ported = [tl.build_model(c, params_from_jax(
        c, jax.tree.map(np.asarray, p)), "cpu") for c, p in (
            (tl.tiny_config(dtype=torch.float32, num_layers=2), params),
            (tl.tiny_config(dtype=torch.float32, num_layers=1), dparams))]
    return (jcfg, params, dcfg, dparams) + tuple(ported)


IDS = np.random.RandomState(11).randint(0, 256, (2, 12))
PLEN = np.asarray([12, 9])


@pytest.mark.parametrize("draft", ["self", "one_layer"])
def test_speculative_generate_matches_jax(models, draft):
    jcfg, params, dcfg, dparams, model, dmodel = models
    ps.initialize_model_parallel()
    try:
        jd = (jcfg, params) if draft == "self" else (dcfg, dparams)
        jt, jst = js.speculative_generate(jcfg, params, *jd, IDS, PLEN, 12,
                                          speculation_length=4,
                                          buckets=(16,))
        ref = jg.generate(jcfg, params, IDS, PLEN, 12, buckets=(16,))
    finally:
        ps.destroy_model_parallel()
    tt, tst = ts.speculative_generate(
        model, model if draft == "self" else dmodel, IDS, PLEN, 12,
        speculation_length=4, buckets=(16,))
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_array_equal(tt.numpy(), _np(ref))
    np.testing.assert_array_equal(
        tt.numpy(), tg.generate(model, IDS, PLEN, 12, buckets=(16,)).numpy())
    assert tst["rounds"] == int(jst["rounds"])
    assert tst["mean_accepted"] == pytest.approx(
        float(jst["mean_accepted"]), abs=0)
    if draft == "self":
        assert tst["mean_accepted"] > 1.0


@pytest.fixture(scope="module")
def medusa():
    heads = js.MedusaHeads(hidden_size=64, vocab_size=256, num_heads=3,
                           dtype=jnp.float32, param_dtype=jnp.float32)
    hp = meta.unbox(heads.init(jax.random.key(80), jnp.zeros((1, 64))))
    th = ts.MedusaHeads(64, 256, num_heads=3, dtype=torch.float32,
                        device="cpu")
    th.load_state_dict(medusa_params_from_jax(jax.tree.map(np.asarray, hp)),
                       strict=True)
    return heads, hp, th.requires_grad_(False)


def test_medusa_heads_match_jax(medusa):
    heads, hp, th = medusa
    h = np.random.RandomState(3).randn(5, 64).astype(np.float32)
    want = _np(heads.apply(hp, jnp.asarray(h)))
    got = th(torch.from_numpy(h)).numpy()
    assert got.shape == want.shape == (5, 3, 256)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_medusa_generate_matches_jax(models, medusa):
    jcfg, params, _, _, model, _ = models
    heads, hp, th = medusa
    ps.initialize_model_parallel()
    try:
        jt, jst = js.medusa_generate(jcfg, params, heads, hp, IDS, PLEN, 10,
                                     buckets=(16,))
    finally:
        ps.destroy_model_parallel()
    tt, tst = ts.medusa_generate(model, th, IDS, PLEN, 10, buckets=(16,))
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_array_equal(
        tt.numpy(), tg.generate(model, IDS, PLEN, 10, buckets=(16,)).numpy())
    assert tst["rounds"] == int(jst["rounds"]) >= 1
    assert tst["mean_accepted"] == float(jst["mean_accepted"])
