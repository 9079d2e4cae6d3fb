"""The PyTorch port's single-device Llama train step against the JAX
package: logits and every parameter's gradient, the loss, AdamW with
global-norm clipping against optax, the schedules, and whole train steps
(10-step loss curve, gradient accumulation, the non-finite skip, bf16
compute) on the same weights and batches. Weights cross with
``params_from_jax``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import loss_functions as jlf
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import schedules as jsched
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import (OptimizerConfig,
                                                  neuronx_distributed_config)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.parallel import loss_functions as tlf
from neuronx_distributed_tpu_torch.trainer import optimizer as topt
from neuronx_distributed_tpu_torch.trainer import schedules as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 256


def _batches(seed, n, b=2, s=16, ignore=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, VOCAB, (b, s + 1)).astype(np.int32)
        labels = ids[:, 1:].copy()
        if ignore:
            labels[:, :3] = -100
        out.append({"input_ids": ids[:, :-1], "labels": labels})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


class JaxRun:
    """A JAX train step on a one-device mesh (tp=1), its initial params as
    writable numpy arrays, and the port's config with the same fields."""

    def __init__(self, flash=True, dtype=jnp.float32, lr=1e-3,
                 grad_accum_steps=1, skip_nonfinite=False, layers=2,
                 **step_kw):
        self.jcfg = jl.tiny_config(dtype=dtype, param_dtype=jnp.float32,
                                   num_layers=layers,
                                   use_flash_attention=flash)
        self.tcfg = tl.tiny_config(
            dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16,
            num_layers=layers, use_flash_attention=flash)
        cfg = nxd.neuronx_distributed_config(tensor_parallel_size=1,
                                             devices=jax.devices()[:1])
        try:
            pm, params = jtr.initialize_parallel_model(
                cfg, jl.LlamaForCausalLM(self.jcfg), jax.random.key(0),
                jnp.zeros((2, 16), jnp.int32))
            tx, self.state, sh = jtr.initialize_parallel_optimizer(
                pm, params, learning_rate=lr)
            self.step_fn = jtr.make_train_step(
                pm, tx, sh, donate=False, grad_accum_steps=grad_accum_steps,
                skip_nonfinite=skip_nonfinite, **step_kw)
        except Exception:
            ps.destroy_model_parallel()
            raise
        self.params = jax.tree.map(np.array, params)    # writable

    def step(self, batch):
        self.state, m = self.step_fn(self.state, {
            k: jnp.asarray(v) for k, v in batch.items()})
        return {k: np.asarray(v) for k, v in m.items()}

    def close(self):
        ps.destroy_model_parallel()


def _port(run, lr=1e-3, **step_kw):
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), run.tcfg,
        state_dict=params_from_jax(run.tcfg, run.params), device="cpu")
    tx, state = ttr.initialize_parallel_optimizer(pm, params,
                                                  learning_rate=lr)
    return pm, state, ttr.make_train_step(pm, tx, **step_kw)


def _jax_params_by_port_name(run, tree):
    return params_from_jax(run.tcfg, jax.tree.map(np.asarray, tree))


def _assert_params_close(state, run):
    """Updated params against JAX's. Adam's m / (sqrt(v) + eps) magnifies
    the rounding of gradients near zero (rarely seen embedding rows, small
    kernel entries) up to a sizeable share of one lr step, so params are
    held to 1e-3 x max|p| (a tenth of a 1e-3 step at unit scale); the loss
    curve carries the 1e-4 check. Non-finite entries must sit in the same
    places."""
    want = _jax_params_by_port_name(run, run.state.params)
    for name, p in state.params.items():
        ref, got = want[name].numpy(), p.detach().numpy()
        finite = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(got), finite,
                                      err_msg=name)
        np.testing.assert_allclose(got[finite], ref[finite], rtol=0,
                                   atol=1e-3 * np.abs(ref[finite]).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def run_flash():
    run = JaxRun(flash=True)
    yield run
    run.close()


@pytest.mark.parametrize("flash", [True, False])
def test_logits_match_jax(run_flash, flash):
    run = run_flash
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=2,
                         use_flash_attention=flash)
    pm, _ = ttr.initialize_parallel_model(
        neuronx_distributed_config(), cfg,
        state_dict=params_from_jax(cfg, run.params), device="cpu")
    ids = _batches(1, 1)[0]["input_ids"]
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          num_layers=2, use_flash_attention=flash)
    ref = np.asarray(jl.LlamaForCausalLM(jcfg).apply(run.params,
                                                     jnp.asarray(ids)))
    with torch.no_grad():
        got = pm.module(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_causal_lm_loss_matches_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 7, 50) * 4).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7))
    labels[0, :4] = -100
    labels[2, 6] = -100
    ref = jlf.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tlf.causal_lm_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    ref = jlf.parallel_cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels), ignore_index=-100)
    got = tlf.parallel_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     ignore_index=-100)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    # every label ignored: the denominator stays 1
    assert tlf.causal_lm_loss(torch.from_numpy(logits),
                              torch.full((3, 7), -100)).item() == 0.0


@pytest.mark.parametrize("flash", [True, False])
def test_gradients_match_jax_grad(run_flash, flash):
    run = run_flash
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=2,
                         use_flash_attention=flash)
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          num_layers=2, use_flash_attention=flash)
    batch = _batches(2, 1, ignore=True)[0]
    ids, labels = jnp.asarray(batch["input_ids"]), jnp.asarray(
        batch["labels"])
    jmod = jl.LlamaForCausalLM(jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmod.apply(p, ids, labels, method="loss"))(run.params)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), cfg,
        state_dict=params_from_jax(cfg, run.params), device="cpu")
    tb = _torch_batch(batch)
    loss = pm.module.loss(tb["input_ids"], tb["labels"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = _jax_params_by_port_name(run, jgrads)
    assert set(want) == set(params)
    for name, p in params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def _tree(rng, shapes):
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("clip,max_norm", [(True, 1.0), (True, 100.0),
                                           (False, 1.0)])
def test_make_optimizer_matches_optax(clip, max_norm):
    """One AdamW update after clipping, from moments already warmed up by
    three updates, against optax's chain."""
    rng = np.random.RandomState(4)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = _tree(rng, shapes)
    grads_seq = [[g * 3 for g in _tree(rng, shapes)] for _ in range(4)]
    ocfg = OptimizerConfig(grad_clipping=clip, max_grad_norm=max_norm)
    chain = ([optax.clip_by_global_norm(max_norm)] if clip else []) + [
        optax.adamw(learning_rate=3e-3, b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=0.01)]
    tx_j = optax.chain(*chain)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx_j.init(jp)
    tx_t = topt.make_optimizer(neuronx_distributed_config(
        optimizer_config=ocfg), learning_rate=3e-3)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = tx_t.init(tp)
    for grads in grads_seq:
        updates, jstate = tx_j.update([jnp.asarray(g) for g in grads],
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tx_t.update(tp, [torch.from_numpy(g.copy()) for g in grads], tstate)
    assert tstate.count == 4
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_global_norm_matches_optax_and_float64():
    rng = np.random.RandomState(5)
    small = _tree(rng, [(5, 3), (7,), (2, 2, 4)])
    np.testing.assert_allclose(
        topt.global_norm([torch.from_numpy(x) for x in small]).item(),
        float(optax.global_norm([jnp.asarray(x) for x in small])),
        rtol=1e-6)
    # one large, biased gradient: a flat fp32 sum over 33 M squares drifts
    big = torch.from_numpy(
        (rng.rand(2048, 16384) * 1e-3 + 1e-4).astype(np.float32))
    ref = torch.linalg.vector_norm(big.double()).item()
    np.testing.assert_allclose(topt.global_norm([big]).item(), ref,
                               rtol=1e-6)


@pytest.mark.parametrize("kind,args", [
    ("linear_warmup_linear_decay", (1e-3, 10, 50)),
    ("linear_warmup_linear_decay", (2e-4, 0, 20, 1e-5)),
    ("linear_warmup_cosine_decay", (1e-3, 10, 50)),
    ("linear_warmup_cosine_decay", (3e-4, 0, 30, 0.2)),
])
def test_schedules_match_optax(kind, args):
    want = getattr(jsched, kind)(*args)
    got = getattr(tsched, kind)(*args)
    for count in list(range(0, 60)) + [100]:
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


def test_schedule_drives_the_optimizer_by_update_count():
    sched = tsched.linear_warmup_linear_decay(1.0, 2, 4)
    tx = topt.AdamW(learning_rate=sched, max_grad_norm=None,
                    weight_decay=0.0)
    p = [torch.zeros(3)]
    state = tx.init(p)
    lrs = []
    for _ in range(3):
        lrs.append(tx.lr(state.count))
        tx.update(p, [torch.ones(3)], state)
    assert lrs == [sched(0), sched(1), sched(2)] == [0.0, 0.5, 1.0]


def test_ten_steps_match_jax():
    """The loss curve of 10 fp32 steps on 10 batches, within 1e-4 relative
    at every step, and the grad norms and final params."""
    run = JaxRun(flash=True)
    try:
        _, state, step = _port(run)
        for batch in _batches(5, 10, ignore=True):
            jm = run.step(batch)
            _, tm = step(state, _torch_batch(batch))
            np.testing.assert_allclose(tm["loss"].item(), jm["loss"],
                                       rtol=1e-4)
            np.testing.assert_allclose(tm["grad_norm"].item(),
                                       jm["grad_norm"], rtol=1e-3)
        assert state.step == 10 and int(run.state.step) == 10
        _assert_params_close(state, run)
    finally:
        run.close()


def test_grad_accum_matches_jax():
    run = JaxRun(flash=True, grad_accum_steps=2)
    try:
        _, state, step = _port(run, grad_accum_steps=2)
        for batch in _batches(6, 2, b=4):
            jm = run.step(batch)
            _, tm = step(state, _torch_batch(batch))
            np.testing.assert_allclose(tm["loss"].item(), jm["loss"],
                                       rtol=1e-4)
        _assert_params_close(state, run)
        with pytest.raises(ValueError, match="not divisible"):
            step(state, _torch_batch(_batches(6, 1, b=3)[0]))
    finally:
        run.close()


def test_skip_nonfinite_matches_jax():
    """A batch that reaches a token whose embedding row is inf gives a
    non-finite loss: both steps keep params and moments, count the step and
    report the skip; the next batch (without that token) updates both
    alike."""
    run = JaxRun(flash=True, skip_nonfinite=True)
    try:
        poison = 7
        embed = run.state.params["params"]["model"]["embed"]
        embed["embedding"] = jax.device_put(
            embed["embedding"].at[poison].set(jnp.inf),
            embed["embedding"].sharding)
        run.params["params"]["model"]["embed"]["embedding"][poison] = np.inf
        _, state, step = _port(run, skip_nonfinite=True)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        bad, good = _batches(7, 2)
        bad["input_ids"][0, 3] = poison
        good["input_ids"][good["input_ids"] == poison] = poison + 1
        jm = run.step(bad)
        _, tm = step(state, _torch_batch(bad))
        assert int(jm["nonfinite_skipped"]) == tm["nonfinite_skipped"] == 1
        assert not np.isfinite(tm["loss"].item())
        assert state.step == 1 and int(run.state.step) == 1
        assert state.opt_state.count == 0
        for name, p in state.params.items():
            assert torch.equal(p, before[name]), name
        jm = run.step(good)
        _, tm = step(state, _torch_batch(good))
        assert int(jm["nonfinite_skipped"]) == tm["nonfinite_skipped"] == 0
        np.testing.assert_allclose(tm["loss"].item(), jm["loss"], rtol=1e-4)
        _assert_params_close(state, run)
    finally:
        run.close()


def test_bf16_compute_tracks_jax():
    """fp32 params, bf16 compute: 3 steps. bf16 rounds at other places in
    the two frameworks (matmul accumulation, the residual stream), so the
    losses are held to 2e-2 relative instead of the fp32 1e-4."""
    run = JaxRun(flash=True, dtype=jnp.bfloat16)
    try:
        _, state, step = _port(run)
        for p in state.params.values():
            assert p.dtype == torch.float32
        for batch in _batches(8, 3):
            jm = run.step(batch)
            _, tm = step(state, _torch_batch(batch))
            np.testing.assert_allclose(tm["loss"].item(), jm["loss"],
                                       rtol=2e-2)
            assert tm["loss"].dtype == torch.float32
    finally:
        run.close()


def test_params_from_jax_arrive_fp32_and_trainable(run_flash):
    run = run_flash
    sd = params_from_jax(run.tcfg, run.params)
    assert {t.dtype for t in sd.values()} == {torch.float32}
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), run.tcfg, state_dict=sd, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in params.values())
    # the model is built from copies: training leaves the state dict alone
    name = "layers.0.attn.qkv.q_kernel"
    assert params[name].data_ptr() != sd[name].data_ptr()
    # a bf16-compute config still holds fp32 params
    bcfg = tl.tiny_config(dtype=torch.bfloat16, num_layers=2)
    _, bparams = ttr.initialize_parallel_model(
        neuronx_distributed_config(), bcfg, state_dict=sd, device="cpu")
    assert {p.dtype for p in bparams.values()} == {torch.float32}
    # serving keeps its frozen, cfg.dtype weights
    served = tl.build_model(bcfg, sd, device="cpu")
    assert all(not p.requires_grad and p.dtype == torch.bfloat16
               for p in served.parameters())


def test_attention_dropout_in_the_train_step():
    """With a dropout generator, the flash and dense paths of the port draw
    the same seeds and masks (same losses); without one, dropout is off."""
    losses = {}
    batch = _torch_batch(_batches(9, 1)[0])
    for flash in (True, False):
        cfg = tl.tiny_config(dtype=torch.float32, num_layers=2,
                             use_flash_attention=flash,
                             attention_dropout=0.2)
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), cfg, seed=1, device="cpu")
        tx, state = ttr.initialize_parallel_optimizer(pm, params)
        step = ttr.make_train_step(
            pm, tx, dropout_generator=torch.Generator().manual_seed(5))
        losses[flash] = [step(state, batch)[1]["loss"].item()
                         for _ in range(2)]
        with torch.no_grad():
            off = pm.module.loss(batch["input_ids"], batch["labels"]).item()
            on = pm.module.loss(batch["input_ids"], batch["labels"],
                                dropout_generator=torch.Generator()).item()
        assert off != on
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)


def _jax_loss_fn(module, params, batch):
    """A custom loss: the model's loss scaled by the batch's ``scale``
    leaf, plus an L2 term on the embedding table."""
    loss = module.apply(params, batch["input_ids"], batch["labels"],
                        method="loss")
    table = params["params"]["model"]["embed"]["embedding"]
    return batch["scale"].mean() * loss + 1e-3 * jnp.mean(table ** 2)


def _port_loss_fn(module, params, batch):
    loss = module.loss(batch["input_ids"], batch["labels"])
    table = params["embed.embedding"]
    return batch["scale"].mean() * loss + 1e-3 * (table ** 2).mean()


def _scaled(batches, seed=3):
    rng = np.random.RandomState(seed)
    return [dict(b, scale=(0.5 + rng.rand(b["input_ids"].shape[0]))
                 .astype(np.float32)) for b in batches]


def test_loss_fn_with_accumulation_and_skip_follows_jax():
    """``loss_fn(module, params, batch)`` with an extra batch leaf, a
    parameter term, ``grad_accum_steps=2`` and ``skip_nonfinite``: 10
    steps within 1e-4 relative of JAX's loss curve, grad norms within
    1e-3."""
    kw = dict(grad_accum_steps=2, skip_nonfinite=True)
    run = JaxRun(flash=True, loss_fn=_jax_loss_fn, **kw)
    try:
        _, state, step = _port(run, loss_fn=_port_loss_fn, **kw)
        for batch in _scaled(_batches(11, 10, b=4, ignore=True)):
            jm = run.step(batch)
            _, tm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
            np.testing.assert_allclose(tm["loss"].item(), jm["loss"],
                                       rtol=1e-4)
            np.testing.assert_allclose(tm["grad_norm"].item(),
                                       jm["grad_norm"], rtol=1e-3)
            assert tm["nonfinite_skipped"] == int(jm["nonfinite_skipped"])
        assert state.step == 10
        _assert_params_close(state, run)
    finally:
        run.close()


def test_scan_steps_follow_jax_and_equal_single_steps():
    """``scan_steps=2``: batches stacked [2, B, S], 5 calls for 10 updates;
    each call's metrics (the last update's) within 1e-4 relative of JAX's
    ``scan_steps=2`` step, with a custom ``loss_fn``; and the port's state
    after the calls equal, bit for bit, to 10 single steps'."""
    batches = _scaled(_batches(12, 10, ignore=True))
    stacked = [{k: np.stack([a[k], b[k]]) for k in a}
               for a, b in zip(batches[::2], batches[1::2])]
    run = JaxRun(flash=True, loss_fn=_jax_loss_fn, scan_steps=2)
    try:
        _, state, step = _port(run, loss_fn=_port_loss_fn, scan_steps=2)
        for batch in stacked:
            jm = run.step(batch)
            _, tm = step(state, batch)
            np.testing.assert_allclose(tm["loss"].item(), jm["loss"],
                                       rtol=1e-4)
            np.testing.assert_allclose(tm["grad_norm"].item(),
                                       jm["grad_norm"], rtol=1e-3)
        assert state.step == 10 and int(run.state.step) == 10
        _assert_params_close(state, run)
        _, single, one = _port(run, loss_fn=_port_loss_fn)
        for batch in batches:
            _, m = one(single, batch)
        assert m["loss"].item() == tm["loss"].item()
        for name, p in state.params.items():
            assert torch.equal(p, single.params[name]), name
        for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                        single.opt_state.mu + single.opt_state.nu):
            assert torch.equal(a, b)
        assert step.cache_size() == 1
        with pytest.raises(ValueError, match="scan_steps"):
            step(state, _scaled(_batches(12, 1, b=3))[0])
    finally:
        run.close()


def test_loss_fn_and_scan_steps_refuse_what_jax_refuses():
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), cfg, device="cpu")
    tx, _ = ttr.initialize_parallel_optimizer(pm, params)
    with pytest.raises(ValueError, match="dropout_generator"):
        ttr.make_train_step(pm, tx, loss_fn=_port_loss_fn,
                            dropout_generator=torch.Generator())
    with pytest.raises(ValueError, match="scan_steps"):
        ttr.make_train_step(pm, tx, scan_steps=0)


def test_later_slice_options_and_configs_raise():
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), cfg, device="cpu")
    tx, _ = ttr.initialize_parallel_optimizer(pm, params)
    with pytest.raises(ValueError, match="later"):
        ttr.make_train_step(pm, tx, compression=object())
    # grad_fn runs (tests/test_torch_trainer_loop_pp.py); with loss_fn or
    # dropout_generator it raises, as the reference's
    with pytest.raises(ValueError, match="not both"):
        ttr.make_train_step(pm, tx, grad_fn=lambda *a: 0,
                            loss_fn=_port_loss_fn)
    with pytest.raises(ValueError, match="dropout_generator"):
        ttr.make_train_step(pm, tx, grad_fn=lambda *a: 0,
                            dropout_generator=torch.Generator())
    with pytest.raises(ValueError, match="grad_accum_steps"):
        ttr.make_train_step(pm, tx, grad_accum_steps=0)
    # tensor, pipeline, expert and data parallelism and ZeRO-1 run
    # (tests/test_torch_train_tp.py, tests/test_torch_pipeline.py,
    # tests/test_torch_mixtral_ep.py); context parallelism, pipeline x
    # expert parallelism, overlap and activation compression are later
    # tiers
    pp, ep = 2, 2
    assert neuronx_distributed_config(
        init_mesh=False, pipeline_parallel_size=pp
    ).parallel.pipeline_parallel_size == pp
    assert neuronx_distributed_config(
        init_mesh=False, expert_parallel_size=ep,
        moe_ep_wire_dtype="int8", moe_overlap_dispatch=True
    ).parallel.moe_ep_wire_dtype == "int8"
    for kw in (dict(context_parallel_size=2),
               dict(expert_parallel_size=ep, pipeline_parallel_size=pp),
               dict(tp_overlap_comm=True),
               dict(tp_activation_comm_dtype="int8")):
        with pytest.raises(ValueError, match="later slice"):
            neuronx_distributed_config(init_mesh=False, **kw)
    # the reference's checks of the EP dispatch options
    with pytest.raises(ValueError, match="expert_parallel_size > 1"):
        neuronx_distributed_config(init_mesh=False,
                                   moe_overlap_dispatch=True)
    with pytest.raises(ValueError, match="moe_ep_wire_dtype"):
        neuronx_distributed_config(init_mesh=False, moe_ep_wire_dtype="int4")
    # a tp degree needs that many ranks
    tp = 2
    with pytest.raises(ValueError, match="process group"):
        neuronx_distributed_config(tensor_parallel_size=tp)
    with pytest.raises(ValueError, match="max_grad_norm"):
        OptimizerConfig(max_grad_norm=0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttr.initialize_parallel_model(neuronx_distributed_config(), cfg)


_TRAIN_ISOLATED = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "neuronx_distributed_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.models import llama as tl
cfg = tl.tiny_config(dtype=torch.float32, num_layers=1,
                     use_flash_attention=True)
pm, params = ttr.initialize_parallel_model(neuronx_distributed_config(), cfg,
                                           device="cpu")
tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
step = ttr.make_train_step(pm, tx)
ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 9)))
batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
losses = [step(state, batch)[1]["loss"].item() for _ in range(3)]
assert losses[-1] < losses[0], losses
print("trained", state.step)
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm
cfg = tm.tiny_moe_config(dtype=torch.float32, num_layers=1,
                         use_flash_attention=True, moe_dispatch="blockwise",
                         moe_block_size=8)
pm, params = ttr.initialize_parallel_model(neuronx_distributed_config(), cfg,
                                           device="cpu")
tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
step = ttr.make_train_step(pm, tx)
calls = []
bwd = tbm.grouped_glu_bwd_plain
tbm.grouped_glu_bwd_plain = lambda *a: (calls.append(1), bwd(*a))[1]
losses = [step(state, batch)[1]["loss"].item() for _ in range(3)]
assert losses[-1] < losses[0] and len(calls) == 3, (losses, calls)
print("trained mixtral", state.step)
from neuronx_distributed_tpu_torch import obs
from neuronx_distributed_tpu_torch.resilience import chaos, integrity
obs.enable()
step = ttr.make_train_step(pm, tx, integrity_every=1)
_, m = step(state, batch)
assert torch.equal(m["integrity_fp"], integrity.fingerprint_tree(
    state.params))
assert obs.get_registry().to_prometheus() == ""
assert chaos.FaultPlan.parse("seed=1; save_text : transient").rules
print("integrity", state.step)
from neuronx_distributed_tpu_torch import lora
cfg = tl.tiny_config(dtype=torch.float32, num_layers=1,
                     use_flash_attention=True,
                     lora=lora.LoraConfig(r=4, target_modules=("qkv",
                                                               "gate_up")))
pm, params = ttr.initialize_parallel_model(neuronx_distributed_config(), cfg,
                                           device="cpu")
base = {n: p.detach().clone() for n, p in params.items()
        if not lora.is_lora_path(n)}
tx = lora.make_lora_optimizer(ttr.make_optimizer(
    neuronx_distributed_config(), learning_rate=1e-2), params)
state = ttr.TrainState(0, params, tx.init(ttr.trainable(params)))
step = ttr.make_train_step(pm, tx)
losses = [step(state, batch)[1]["loss"].item() for _ in range(3)]
assert losses[-1] < losses[0], losses
assert all(torch.equal(params[n], t) for n, t in base.items())
merged = lora.merge_lora_params(dict(params), cfg.lora)
assert not lora.extract_lora_state(merged)
print("lora", state.step)
"""


def test_train_step_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _TRAIN_ISOLATED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == ["trained 3", "trained mixtral 3",
                                       "integrity 4", "lora 3"]
