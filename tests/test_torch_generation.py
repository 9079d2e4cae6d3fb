"""The PyTorch port's contiguous-cache generation against the JAX package:
``pick_bucket``, greedy ids of ``generate`` identical to JAX's, the
contiguous forward (fp and int8 cache, Llama and Mixtral) within 1e-4 x
max|logit| of JAX's over a prefill and four decode steps, and the stated
divergence on a write past the cache's end."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import generation as jg
from neuronx_distributed_tpu.inference import kv_cache as jkv
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import generation as tg
from neuronx_distributed_tpu_torch.inference import kv_cache as tkv
from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.convert import load_jax_params
from neuronx_distributed_tpu_torch.ops import blockwise_moe as tops


@pytest.fixture(scope="module")
def models():
    """One tiny fp32 Llama in both packages, the same weights."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    model = load_jax_params(tl.LlamaForCausalLM(tcfg, device="cpu"),
                            jax.tree.map(np.asarray, params))
    return jcfg, params, model


@pytest.mark.parametrize("length,buckets,cp", [
    (5, (8, 16), 1), (8, (8, 16), 1), (9, (8, 16), 1), (99, (8, 16), 1),
    (20, (8, 16), 2), (99, (8, 16), 8), (129, (8, 16), 8), (1, (16, 8), 1)])
def test_pick_bucket_matches_jax(length, buckets, cp):
    try:
        want = jg.pick_bucket(length, buckets, cp=cp)
    except ValueError:
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            tg.pick_bucket(length, buckets, cp=cp)
        return
    assert tg.pick_bucket(length, buckets, cp=cp) == want


def _prompts(seed, lens, s, vocab=256):
    """Right-padded prompts ``[B, s]`` (pad id 0) of the given lengths."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, vocab, n)
    return ids, np.asarray(lens, np.int32)


# (prompt lengths, padded width, max_new_tokens, generate keywords)
GENERATE = {
    "ragged_b3": ((11, 4, 7), 11, 6, dict(buckets=(16,))),
    "padded_to_bucket": ((9, 3), 9, 7, dict(buckets=(8, 16, 32))),
    "exact_bucket": ((16, 9), 16, 8, dict(buckets=(16, 32))),
    "max_new_not_a_bucket": ((5, 3), 5, 5, dict(buckets=(8,))),
    "past_the_largest_decode_bucket": (
        (6, 2), 6, 6, dict(buckets=(8,), decode_buckets=(2, 4))),
}


def _both_generate(models, lens, s, max_new, **kw):
    jcfg, params, model = models
    ids, plen = _prompts(len(lens) * 10 + s, lens, s)
    ref = np.asarray(jg.generate(jcfg, params, jnp.asarray(ids),
                                 jnp.asarray(plen), max_new, **kw))
    got = tg.generate(model, ids, plen, max_new, **kw)
    return ref, got


@pytest.mark.parametrize("name", sorted(GENERATE))
def test_generate_greedy_ids_match_jax(models, name):
    lens, s, max_new, kw = GENERATE[name]
    ref, got = _both_generate(models, lens, s, max_new, **kw)
    assert got.shape == (len(lens), max_new)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_pins_rows_past_eos_like_jax(models):
    lens, s, max_new = (11, 4, 7), 11, 8
    _, probe = _both_generate(models, lens, s, max_new, buckets=(16,))
    eos = int(probe[0, 2])
    ref, got = _both_generate(models, lens, s, max_new, buckets=(16,),
                              eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), ref)
    row = got[0].tolist()
    first = row.index(eos)
    assert first <= 2 and row[first:] == [eos] * (max_new - first)
    assert row[:first] == probe[0, :first].tolist()


def test_generate_samples_from_its_generator(models):
    """Sampled ids come from the ``torch.Generator`` (ROADMAP §C: they may
    differ from JAX's); the same seed gives the same ids, in range."""
    from neuronx_distributed_tpu_torch.inference.sampling import (
        SamplingConfig)

    _, _, model = models
    ids, plen = _prompts(3, (6, 4), 6)
    cfg = SamplingConfig(temperature=1.5, top_k=20)
    runs = [tg.generate(model, ids, plen, 6, sampling=cfg, buckets=(8,),
                        generator=torch.Generator().manual_seed(s))
            for s in (5, 5)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert runs[0].shape == (2, 6)
    assert ((runs[0] >= 0) & (runs[0] < model.cfg.vocab_size)).all()
    default = tg.generate(model, ids, plen, 6, sampling=cfg, buckets=(8,))
    seeded = tg.generate(model, ids, plen, 6, sampling=cfg, buckets=(8,),
                         generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(default, seeded, rtol=0, atol=0)


def _steps(lens, s, n_decode=4, vocab=256):
    """A ragged prefill (PAD_POSITION in pad slots), then ``n_decode``
    one-token steps at ``prompt_len + i``."""
    ids, plen = _prompts(17, lens, s, vocab)
    ar = np.arange(s)[None]
    pos = np.where(ar < plen[:, None], ar, PAD_POSITION).astype(np.int32)
    steps = [(ids, pos)]
    rng = np.random.RandomState(18)
    for i in range(n_decode):
        steps.append((rng.randint(0, vocab, (len(lens), 1)).astype(np.int32),
                      (plen + i)[:, None].astype(np.int32)))
    return steps


def _run_both(jfwd, tfwd, jcache, tcache, steps):
    """Both forwards over ``steps``; returns the caches and the worst
    logit error relative to max|logit| per step."""
    for ids, pos in steps:
        ref, jcache = jfwd(jnp.asarray(ids), jnp.asarray(pos), jcache)
        got, tcache = tfwd(torch.from_numpy(ids), torch.from_numpy(pos),
                           tcache)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
        assert tcache.index == int(jcache.index)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    return jcache, tcache


@pytest.mark.parametrize("quantized", [False, True])
def test_contiguous_forward_matches_jax(models, quantized):
    """Logits within 1e-4 x max|logit| over a prefill and 4 decode steps;
    the fp cache within 1e-5, the int8 cache's codes within one step."""
    jcfg, params, model = models
    nl, kv, d, b, s_max = jcfg.num_layers, jcfg.num_kv_heads, \
        jcfg.head_dim_, 3, 16
    if quantized:
        jc = jkv.init_quantized_kv_cache(nl, b, s_max, kv, d)
        tc = tkv.init_quantized_kv_cache(nl, b, s_max, kv, d, device="cpu")
    else:
        jc = jkv.init_kv_cache(nl, b, s_max, kv, d, dtype=jnp.float32)
        tc = tkv.init_kv_cache(nl, b, s_max, kv, d, dtype=torch.float32,
                               device="cpu")
    jc, tc = _run_both(
        lambda i, p, c: jl.llama_forward_with_cache(jcfg, params, i, p, c),
        lambda i, p, c: tl.llama_forward_with_cache(model, i, p, c),
        jc, tc, _steps((9, 4, 7), 9))
    assert tc.index == 13
    if quantized:
        for name in ("k", "v"):
            codes_t = getattr(tc, name).numpy().astype(np.int32)
            codes_j = np.asarray(getattr(jc, name)).astype(np.int32)
            assert np.abs(codes_t - codes_j).max() <= 1
            step = np.asarray(getattr(jc, name + "_scale"))[..., None]
            deq_t = codes_t * getattr(tc, name + "_scale").numpy()[..., None]
            assert (np.abs(deq_t - codes_j * step) <= step * 1.001
                    + 1e-6).all()
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v),
                                   rtol=1e-5, atol=1e-5)


def _mixtral(mode):
    """One tiny fp32 Mixtral (E=4, top-2, block 8) in both packages, the
    same weights: JAX's config and params, the port's config and model."""
    kw = dict(moe_dispatch=mode, moe_block_size=8)
    jcfg = jm.tiny_moe_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              **kw)
    tcfg = tm.tiny_moe_config(dtype=torch.float32,
                              param_dtype=torch.float32, **kw)
    ps.initialize_model_parallel()
    try:
        tree = meta.unbox(jm.MixtralForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    model = load_jax_params(tm.MixtralForCausalLM(tcfg, device="cpu"),
                            jax.tree.map(np.asarray, tree))
    return jcfg, tree, tcfg, model


@pytest.mark.parametrize("mode", ["blockwise", "capacity"])
def test_mixtral_contiguous_forward_matches_jax(monkeypatch, mode):
    """E=4, top-2, B=2: the prefill (2 x 8 tokens) runs K5's plain version,
    each decode step (2 tokens x top-2 <= 4 experts, counted over the whole
    batch) K6's on sentinel metadata; logits within 1e-4 x max|logit|."""
    jcfg, tree, tcfg, model = _mixtral(mode)
    calls = []
    for name in ("grouped_glu_plain", "grouped_glu_decode_plain"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    nl, kv, d = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim_
    steps = _steps((8, 5), 8)
    _run_both(
        lambda i, p, c: jm.mixtral_forward_with_cache(jcfg, tree, i, p, c),
        lambda i, p, c: tm.mixtral_forward_with_cache(model, i, p, c),
        jkv.init_kv_cache(nl, 2, 16, kv, d, dtype=jnp.float32),
        tkv.init_kv_cache(nl, 2, 16, kv, d, dtype=torch.float32,
                          device="cpu"), steps)
    if mode == "blockwise":
        assert calls == (["grouped_glu_plain"] * nl
                         + ["grouped_glu_decode_plain"] * nl * 4)
    else:
        assert not calls
    with pytest.raises(TypeError, match="int8"):
        tm.mixtral_forward_with_cache(
            model, torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros((2, 1), dtype=torch.int32),
            tkv.init_quantized_kv_cache(nl, 2, 16, kv, d, device="cpu"))


def test_prefill_and_decode_step_drive_mixtral_through_its_forward():
    """``prefill`` and ``decode_step`` given Mixtral's cached forward: the
    logits at each prompt's last token, then at two greedy decode steps,
    within 1e-4 x max|logit| of JAX's Mixtral forward at the same
    positions (JAX's ``prefill`` is Llama-only)."""
    jcfg, tree, tcfg, model = _mixtral("blockwise")
    nl, kv, d = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim_
    (ids, pos), *_ = _steps((8, 5), 8, n_decode=0)
    plen = np.asarray([8, 5], np.int32)
    jc = jkv.init_kv_cache(nl, 2, 16, kv, d, dtype=jnp.float32)
    tc = tkv.init_kv_cache(nl, 2, 16, kv, d, dtype=torch.float32,
                           device="cpu")
    ref, jc = jm.mixtral_forward_with_cache(jcfg, tree, jnp.asarray(ids),
                                            jnp.asarray(pos), jc)
    ref = np.asarray(ref)[np.arange(2), plen - 1]
    got, tc = tg.prefill(model, torch.from_numpy(ids),
                         torch.from_numpy(plen), tc,
                         forward=tm.mixtral_forward_with_cache)
    at = plen
    for _ in range(3):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
        tok = np.argmax(ref, -1).astype(np.int32)
        ref, jc = jm.mixtral_forward_with_cache(
            jcfg, tree, jnp.asarray(tok[:, None]), jnp.asarray(at[:, None]),
            jc)
        ref = np.asarray(ref)[:, 0]
        got, tc = tg.decode_step(model, torch.from_numpy(tok),
                                 torch.from_numpy(at), tc,
                                 forward=tm.mixtral_forward_with_cache)
        at = at + 1
    assert tc.index == 11


def test_write_past_the_cache_raises_where_jax_shifts_it(models):
    """ROADMAP §C: JAX's ``dynamic_update_slice`` clamps the write's start
    so that a step that overflows lands earlier; the port raises."""
    jcfg, params, model = models
    nl, kv, d = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    ids = np.arange(1, 7, dtype=np.int32)[None]
    pos = np.arange(6, dtype=np.int32)[None]
    jc = jkv.init_kv_cache(nl, 1, 8, kv, d, dtype=jnp.float32)
    tc = tkv.init_kv_cache(nl, 1, 8, kv, d, dtype=torch.float32,
                           device="cpu")
    _, jc = jl.llama_forward_with_cache(jcfg, params, jnp.asarray(ids),
                                        jnp.asarray(pos), jc)
    _, tc = tl.llama_forward_with_cache(model, torch.from_numpy(ids),
                                        torch.from_numpy(pos), tc)
    more, mpos = ids[:, :3], pos[:, :3] + 6
    _, jc2 = jl.llama_forward_with_cache(jcfg, params, jnp.asarray(more),
                                         jnp.asarray(mpos), jc)
    # JAX wrote positions 6-8 into slots 5-7, over position 5
    np.testing.assert_array_equal(np.asarray(jc2.pos)[0],
                                  [0, 1, 2, 3, 4, 6, 7, 8])
    with pytest.raises(ValueError, match="overflows"):
        tl.llama_forward_with_cache(model, torch.from_numpy(more),
                                    torch.from_numpy(mpos), tc)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_paged_cache_needs_slot_ids_like_jax(models):
    _, _, model = models
    from neuronx_distributed_tpu_torch.inference import paging as tpg

    cfg = model.cfg
    pool = tpg.init_paged_kv_cache(cfg.num_layers, 4, 4, cfg.num_kv_heads,
                                   cfg.head_dim_, 2, 2, dtype=torch.float32,
                                   device="cpu")
    one = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot_ids"):
        tl.llama_forward_with_cache(model, one, one, pool)
    with pytest.raises(ValueError, match="one row batch"):
        tl.llama_forward_with_cache(
            model, torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros((2, 2), dtype=torch.int32), pool,
            torch.zeros((4,), dtype=torch.int32))


def test_contiguous_caches_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.init_kv_cache(1, 1, 4, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.init_quantized_kv_cache(1, 1, 4, 1, 8)
