"""The PyTorch port's Mixtral against the JAX package: the weight bridge,
the forward without a cache, one paged step per dispatch mode
(logits and pool), and the serving engine's greedy ids in packed blockwise,
packed capacity and disaggregated modes, where the decode worker runs the
decode grouped GLU (K6's plain version) and the prefill worker K5's."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import paging as jpg
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import paging as tpg
from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.convert import (load_jax_params,
                                                          params_from_jax)
from neuronx_distributed_tpu_torch.ops import blockwise_moe as tops

STAT_FIELDS = ("steps", "completed", "preempted", "prefill_tokens",
               "tokens_generated")


def _cfgs(mode, block=8):
    kw = dict(moe_dispatch=mode, moe_block_size=block)
    return (jm.tiny_moe_config(dtype=jnp.float32, param_dtype=jnp.float32,
                               **kw),
            tm.tiny_moe_config(dtype=torch.float32, param_dtype=torch.float32,
                               **kw))


@pytest.fixture(scope="module")
def params():
    """One tiny fp32 Mixtral (E=4, top-2) as a JAX tree; the dispatch mode
    does not change the parameters."""
    ps.initialize_model_parallel()
    try:
        jcfg, _ = _cfgs("capacity")
        tree = meta.unbox(jm.MixtralForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    return tree, jax.tree.map(np.asarray, tree)


def test_bridge_round_trips_every_param(params):
    tree, np_tree = params
    _, tcfg = _cfgs("blockwise")
    model = load_jax_params(tm.MixtralForCausalLM(tcfg, device="cpu"),
                            np_tree)
    sd = params_from_jax(tcfg, np_tree)
    assert set(sd) == set(model.state_dict())
    layers = np_tree["params"]["model"]["layers"]["layer"]
    np.testing.assert_array_equal(
        model.layers[1].moe.experts.gate_up.detach().numpy(),
        layers["moe"]["experts"]["gate_up"][1])
    np.testing.assert_array_equal(
        model.layers[0].moe.router.kernel.detach().numpy(),
        layers["moe"]["router"]["kernel"][0])


def test_serving_model_keeps_the_router_in_fp32(params):
    """A bf16 serving model from an fp32 checkpoint holds every weight in
    bf16 but the router's kernel, which routes in fp32 as in JAX."""
    _, np_tree = params
    _, tcfg = _cfgs("blockwise")
    cfg = tm.tiny_moe_config(moe_dispatch="blockwise")          # bf16
    model = tm.build_model(cfg, params_from_jax(tcfg, np_tree), "cpu")
    dtypes = {n: p.dtype for n, p in model.state_dict().items()}
    assert dtypes.pop("layers.0.moe.router.kernel") == torch.float32
    assert dtypes.pop("layers.1.moe.router.kernel") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    sd = tm.init_state_dict(cfg, seed=0, device="cpu")
    assert sd["layers.0.moe.router.kernel"].dtype == torch.float32
    assert sd["layers.0.moe.experts.down"].dtype == torch.float32
    with pytest.raises(ValueError, match="not ported"):
        tm.tiny_moe_config(router_type="sinkhorn")


@pytest.mark.parametrize("mode", ["capacity", "blockwise"])
def test_forward_matches_jax(params, mode):
    """Logits and the router's summed aux losses without a cache."""
    tree, np_tree = params
    jcfg, tcfg = _cfgs(mode)
    ps.initialize_model_parallel()
    ids = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    ref_logits, ref_aux = jm.MixtralForCausalLM(jcfg).apply(
        tree, jnp.asarray(ids))
    model = load_jax_params(tm.MixtralForCausalLM(tcfg, device="cpu"),
                            np_tree)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ids))
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_logits).max())
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), rtol=1e-5)


def _steps():
    """Two packed steps over two slots with scrambled block tables (prefill
    of 5 and 2 tokens, then a decode row each), then a 2-wide step of one
    decode row each: 2 x top-2 <= 4 experts, so the decode grouped GLU on
    sentinel metadata."""
    tables = np.full((3, 4), -1, np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :2] = [7, 0]
    rng = np.random.RandomState(7)
    return tables, [
        dict(tok=rng.randint(0, 256, 10),
             pos=[0, 1, 2, 3, 4, 0, 1] + [PAD_POSITION] * 3,
             slot=[0] * 5 + [1] * 2 + [3] * 3),
        dict(tok=rng.randint(0, 256, 10),
             pos=[5, 2] + [PAD_POSITION] * 8, slot=[0, 1] + [3] * 8),
        dict(tok=rng.randint(0, 256, 2), pos=[6, 3], slot=[0, 1]),
    ]


@pytest.mark.parametrize("mode", ["capacity", "blockwise"])
def test_paged_forward_matches_jax(params, mode):
    tree, np_tree = params
    jcfg, tcfg = _cfgs(mode)
    ps.initialize_model_parallel()
    model = load_jax_params(tm.MixtralForCausalLM(tcfg, device="cpu"),
                            np_tree)
    nl, kv, d = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim_
    jc = jpg.init_paged_kv_cache(nl, 8, 4, kv, d, 3, 4, dtype=jnp.float32)
    tc = tpg.init_paged_kv_cache(nl, 8, 4, kv, d, 3, 4, dtype=torch.float32,
                                 device="cpu")
    tables, steps = _steps()
    jc = jc.replace(block_tables=jnp.asarray(tables))
    tc.block_tables.copy_(torch.from_numpy(tables))
    for st in steps:
        tok = np.asarray(st["tok"], np.int32)[None]
        pos = np.asarray(st["pos"], np.int32)[None]
        slot = np.asarray(st["slot"], np.int32)
        assert tm.decode_sentinel_empty(tcfg, tok.size) == (
            mode == "blockwise" and tok.size == 2)
        ref, jc = jm.mixtral_forward_with_cache(
            jcfg, tree, jnp.asarray(tok), jnp.asarray(pos), jc,
            slot_ids=jnp.asarray(slot))
        got, tc = tm.mixtral_forward_with_cache(
            model, torch.from_numpy(tok), torch.from_numpy(pos), tc,
            torch.from_numpy(slot))
        real = pos[0] < PAD_POSITION
        ref = np.asarray(ref)[0][real]
        np.testing.assert_allclose(got[0].numpy()[real], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-5,
                               atol=1e-5)


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).tolist()


def _drive(eng):
    eng.submit(_prompt(40, 7), 6, uid="a")
    eng.step()
    eng.submit(_prompt(41, 4), 5, uid="b")
    eng.submit(_prompt(42, 11), 4, uid="c")
    eng.step()
    eng.submit(_prompt(43, 3), 6, uid="d")
    res = eng.run()
    return ({u: (r.status, r.tokens) for u, r in res.items()},
            {f: getattr(eng.stats, f) for f in STAT_FIELDS})


@pytest.mark.parametrize("mode,disaggregated", [
    ("blockwise", False), ("capacity", False), ("blockwise", True)])
def test_engine_matches_jax(params, monkeypatch, mode, disaggregated):
    """Greedy ids and step counters identical to the JAX engine (E=4,
    top-2, two slots). Disaggregated, the 2-wide decode worker runs the
    decode grouped GLU and the 8-wide prefill worker the packed one: the
    plain versions are counted per worker."""
    tree, np_tree = params
    jcfg, tcfg = _cfgs(mode)
    ekw = dict(block_size=4, num_blocks=16, max_slots=2, max_blocks_per_seq=8,
               token_budget=8, disaggregated=disaggregated)
    ps.initialize_model_parallel()
    jeng = je.ServingEngine(jcfg, tree, je.EngineConfig(
        kv_dtype=jnp.float32, **ekw), clock=_clock())
    teng = te.ServingEngine(tcfg, params_from_jax(tcfg, np_tree),
                            te.EngineConfig(**ekw), clock=_clock(),
                            device="cpu")
    calls, worker = [], [None]
    run_worker = te.ServingEngine._run_worker

    def tagged(self, name, rows, width):
        worker[0] = name
        return run_worker(self, name, rows, width)

    monkeypatch.setattr(te.ServingEngine, "_run_worker", tagged)
    for name in ("grouped_glu_plain", "grouped_glu_decode_plain"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=fn, _n=name: (
            calls.append((worker[0], _n)), _f(*a))[1])
    jres, tres = _drive(jeng), _drive(teng)
    assert {s for s, _ in tres[0].values()} == {"completed"}
    assert tres == jres
    assert teng.worker_compile_counts() == jeng.worker_compile_counts()
    assert teng.compile_count() == 1
    runs = teng.worker_runs
    nl = tcfg.num_layers
    if mode == "capacity":
        assert not calls
    elif disaggregated:
        assert sorted(set(calls)) == [("decode", "grouped_glu_decode_plain"),
                                      ("prefill", "grouped_glu_plain")]
        assert calls.count(("prefill", "grouped_glu_plain")) == (
            nl * runs["prefill"])
        assert calls.count(("decode", "grouped_glu_decode_plain")) == (
            nl * runs["decode"]) > 0
    else:
        assert set(calls) == {("packed", "grouped_glu_plain")}
        assert len(calls) == nl * runs["packed"]


def test_mixtral_engine_defaults_to_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, np_tree = params
    _, tcfg = _cfgs("blockwise")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.ServingEngine(tcfg, params_from_jax(tcfg, np_tree))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.MixtralForCausalLM(tcfg)
