"""The PyTorch port's Mixtral against the JAX package: the weight bridge,
the forward without a cache, one paged step per dispatch mode
(logits and pool), the serving engine's greedy ids in packed blockwise,
packed capacity and disaggregated modes, where the decode worker runs the
decode grouped GLU (K6's plain version) and the prefill worker K5's, and
training: the loss with the router's aux losses, every gradient against
``jax.grad``, and a 10-step loss curve against the JAX ``make_train_step``
in both dispatch modes (blockwise through the grouped GLU's backward, K7
and K8's plain versions)."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import paging as jpg
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batches(seed, n, b=2, s=16):
    """``n`` batches of next-token ids; the first 3 labels of each row are
    ignored (-100)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 256, (b, s + 1)).astype(np.int32)
        labels = ids[:, 1:].copy()
        labels[:, :3] = -100
        out.append({"input_ids": ids[:, :-1], "labels": labels})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def test_config_has_the_router_coefficients():
    """The port's config carries the JAX loss's router weights."""
    jcfg, tcfg = jm.tiny_moe_config(), tm.tiny_moe_config()
    assert (tcfg.router_aux_coef, tcfg.router_z_coef) == (0.02, 0.001)
    assert (tcfg.router_aux_coef, tcfg.router_z_coef) == (
        jcfg.router_aux_coef, jcfg.router_z_coef)
    assert tm.MIXTRAL_8X7B.router_aux_coef == jm.MIXTRAL_8X7B.router_aux_coef


def test_initialize_parallel_model_builds_mixtral():
    """A ``MixtralConfig`` gives a ``MixtralForCausalLM`` with the MoE
    parameters, the router's kernel in fp32 also from a bf16 state dict."""
    cfg = tm.tiny_moe_config(dtype=torch.float32, moe_dispatch="blockwise",
                             moe_block_size=16)
    pm, params = ttr.initialize_parallel_model(neuronx_distributed_config(),
                                               cfg, device="cpu")
    assert isinstance(pm.module, tm.MixtralForCausalLM)
    for name in ("layers.0.moe.router.kernel", "layers.1.moe.experts.gate_up",
                 "layers.1.moe.experts.down"):
        assert name in params and params[name].requires_grad, name
    assert set(params) == set(tm.init_state_dict(cfg, device="cpu"))
    sd = {k: v.bfloat16() for k, v in tm.init_state_dict(
        cfg, seed=3, device="cpu").items()}
    bcfg = tm.tiny_moe_config(dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    _, bparams = ttr.initialize_parallel_model(
        neuronx_distributed_config(), bcfg, state_dict=sd, device="cpu")
    assert bparams["layers.0.moe.router.kernel"].dtype == torch.float32
    assert bparams["layers.0.moe.experts.down"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["capacity", "blockwise"])
def test_loss_and_gradients_match_jax(params, monkeypatch, mode):
    """``MixtralForCausalLM.loss`` (cross entropy plus 0.02 x load balance
    plus 0.001 x z loss) within 1e-5 of the JAX loss, and every gradient,
    the router's included, within 1e-4 x max|g| of ``jax.grad``; blockwise
    runs block 16, so the experts' gradients come from the plain K7/K8."""
    tree, np_tree = params
    jcfg, tcfg = _cfgs(mode, block=16)
    batch = _batches(2, 1)[0]
    ps.initialize_model_parallel()
    try:
        jloss, jgrads = jax.value_and_grad(
            lambda p: jm.MixtralForCausalLM(jcfg).apply(
                p, jnp.asarray(batch["input_ids"]),
                jnp.asarray(batch["labels"]), method="loss"))(tree)
    finally:
        ps.destroy_model_parallel()
    pm, tparams = ttr.initialize_parallel_model(
        neuronx_distributed_config(), tcfg,
        state_dict=params_from_jax(tcfg, np_tree), device="cpu")
    tb = _torch_batch(batch)
    calls = []
    bwd = tops.grouped_glu_bwd_plain
    monkeypatch.setattr(tops, "grouped_glu_bwd_plain",
                        lambda *a: (calls.append(1), bwd(*a))[1])
    loss = pm.module.loss(tb["input_ids"], tb["labels"])
    loss.backward()
    assert len(calls) == (tcfg.num_layers if mode == "blockwise" else 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tparams)
    for name, p in tparams.items():
        ref = want[name].numpy()
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


class MixtralJaxRun:
    """The JAX ``make_train_step`` over the tiny Mixtral on a one-device
    mesh, its initial params as writable numpy arrays, and the port's
    config with the same fields."""

    def __init__(self, mode, lr=1e-3):
        self.jcfg, self.tcfg = _cfgs(mode, block=16)
        cfg = nxd.neuronx_distributed_config(tensor_parallel_size=1,
                                             devices=jax.devices()[:1])
        try:
            pm, params = jtr.initialize_parallel_model(
                cfg, jm.MixtralForCausalLM(self.jcfg), jax.random.key(0),
                jnp.zeros((2, 16), jnp.int32))
            tx, self.state, sh = jtr.initialize_parallel_optimizer(
                pm, params, learning_rate=lr)
            self.step_fn = jtr.make_train_step(pm, tx, sh, donate=False)
        except Exception:
            ps.destroy_model_parallel()
            raise
        self.params = jax.tree.map(np.array, params)

    def step(self, batch):
        self.state, m = self.step_fn(self.state, {
            k: jnp.asarray(v) for k, v in batch.items()})
        return {k: np.asarray(v) for k, v in m.items()}

    def close(self):
        ps.destroy_model_parallel()


@pytest.mark.parametrize("mode", ["capacity", "blockwise"])
def test_ten_steps_match_jax(mode):
    """10 fp32 AdamW steps (lr 1e-3, clipped at 1.0) on 10 batches: each
    loss within 1e-4 relative of the JAX train step's and each grad norm
    within 1e-3; blockwise trains the experts through K5's plain version
    and the plain K7/K8."""
    run = MixtralJaxRun(mode)
    try:
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), run.tcfg,
            state_dict=params_from_jax(run.tcfg, run.params), device="cpu")
        tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
        step = ttr.make_train_step(pm, tx)
        losses = []
        for batch in _batches(5, 10):
            jmet = run.step(batch)
            _, tmet = step(state, _torch_batch(batch))
            np.testing.assert_allclose(tmet["loss"].item(), jmet["loss"],
                                       rtol=1e-4)
            np.testing.assert_allclose(tmet["grad_norm"].item(),
                                       jmet["grad_norm"], rtol=1e-3)
            losses.append(tmet["loss"].item())
        assert state.step == 10 and int(run.state.step) == 10
        assert losses[-1] < losses[0]
    finally:
        run.close()
