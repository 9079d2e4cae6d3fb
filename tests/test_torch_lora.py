"""LoRA in the PyTorch port against the JAX package: the adapters in the
parallel layers (linear, embedding, fused QKV, the fused gate_up, the conv
pair), a LoRA Llama's logits, loss and adapter gradients on every target,
``make_lora_optimizer``'s two AdamW steps against ``optax.multi_transform``
with the base unchanged bit for bit, the stated ``grad_norm`` divergence,
adapter checkpoints, ``merge_lora_params`` on every triple, the
reference's refusals, LoRA dropout's law and remat, and serving (``generate``
unmerged, ``ServingEngine`` merged, a bundle). Weights cross with
``params_from_jax``; JAX's zero factors are made nonzero from numpy so
that every adapter carries signal."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import meta

from neuronx_distributed_tpu import lora as jlora
from neuronx_distributed_tpu.inference import generation as jg
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import layers as jlayers
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import optimizer as jopt
import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu_torch import lora as tlora
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.inference import generation as tg
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.parallel import layers as tlayers

ALL = ("qkv", "o_proj", "gate_up", "down", "embed", "lm_head")
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(lora, layers=2, **kw):
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          num_layers=layers, use_flash_attention=True,
                          lora=None if lora is None else jlora.LoraConfig(
                              **lora), **kw)
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=layers,
                          use_flash_attention=True,
                          lora=None if lora is None else tlora.LoraConfig(
                              **lora), **kw)
    return jcfg, tcfg


def _jax_params(jcfg, seed=1, nonzero=True):
    """JAX's init of ``jcfg`` as writable numpy arrays; with ``nonzero``
    every adapter factor is redrawn normal(0, 0.05) from numpy, so the
    zero-initialised ones carry signal too."""
    ps.initialize_model_parallel()
    try:
        params = jax.tree.map(np.array, meta.unbox(jl.LlamaForCausalLM(
            jcfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))))
    finally:
        ps.destroy_model_parallel()
    if nonzero:
        rng = np.random.RandomState(seed)
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: (rng.randn(*x.shape) * 0.05).astype(x.dtype)
            if jlora.is_lora_path(path) else x, params)
    return params


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (B, S + 1)).astype(np.int32)
    labels = ids[:, 1:].copy()
    labels[0, :3] = -100
    return ids[:, :-1], labels


def _port_model(tcfg, params):
    pm, tparams = ttr.initialize_parallel_model(
        neuronx_distributed_config(), tcfg,
        state_dict=params_from_jax(tcfg, params), device="cpu")
    return pm.module, tparams


TARGET_SETS = [(t,) for t in ALL] + [ALL, ("qkv", "o_proj", "gate_up",
                                           "down")]


@pytest.mark.parametrize("targets", TARGET_SETS,
                         ids=["+".join(t) for t in TARGET_SETS])
def test_logits_loss_and_adapter_grads_match_jax(targets):
    """Logits, the loss and every adapter's gradient within 1e-4 (fp32) of
    JAX on the same weights; the frozen base gets no gradient."""
    jcfg, tcfg = _configs(dict(r=4, alpha=8.0, target_modules=targets))
    params = _jax_params(jcfg)
    ids, labels = _batch()
    jmodel = jl.LlamaForCausalLM(jcfg)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.apply(
        p, jnp.asarray(ids), jnp.asarray(labels), method="loss"))(params)
    model, tparams = _port_model(tcfg, params)
    tlora.make_lora_optimizer(None, tparams)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    adapters = tlora.extract_lora_state(tparams)
    assert adapters and set(adapters) == {n for n in want
                                          if tlora.is_lora_path(n)}
    for name, p in tparams.items():
        if name not in adapters:
            assert p.grad is None and not p.requires_grad, name
            continue
        ref_g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref_g, rtol=0,
                                   atol=1e-4 * np.abs(ref_g).max(),
                                   err_msg=name)


@pytest.mark.parametrize("targets", [ALL, ("qkv", "o_proj")])
def test_lora_init_is_identity(targets):
    """A fresh adapter (B zero; A zero for the embedding) leaves the
    forward as it was, in JAX's init crossed over and in the port's own
    ``init_state_dict``, whose base equals the base config's."""
    jcfg, tcfg = _configs(dict(r=4, target_modules=targets), layers=1)
    bj, bt = _configs(None, layers=1)
    params = _jax_params(jcfg, nonzero=False)
    ids = np.random.RandomState(0).randint(0, 256, (2, 8))
    model, _ = _port_model(tcfg, params)
    base, _ = _port_model(bt, jlora.merge_lora_params(params, jcfg.lora))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(ids)).numpy(),
                                   base(torch.from_numpy(ids)).numpy(),
                                   rtol=1e-5, atol=1e-6)
    sd = tl.init_state_dict(tcfg, seed=3, device="cpu")
    sd0 = tl.init_state_dict(bt, seed=3, device="cpu")
    assert set(sd) - set(sd0) == set(tlora.extract_lora_state(sd))
    assert all(torch.equal(sd0[k], sd[k]) for k in sd0)
    fresh = tl.init_lora_state(tcfg, seed=4, device="cpu")
    assert set(fresh) == set(tlora.extract_lora_state(sd))
    assert all(torch.count_nonzero(t) == 0
               for n, t in fresh.items() if n.endswith(
                   "lora_a" if n.startswith("embed.") else "lora_b"))
    sd = tlora.merge_lora_state(sd, fresh)
    m1, m0 = tl.build_model(tcfg, sd, "cpu"), tl.build_model(bt, sd0, "cpu")
    with torch.no_grad():
        assert torch.equal(m1(torch.from_numpy(ids)),
                           m0(torch.from_numpy(ids)))


def _optax_lora_steps(jcfg, params, batches, lr):
    """JAX: ``make_lora_optimizer`` over the reference's clip + AdamW,
    stepped by hand; (losses, full grad norms, adapter grad norms, the
    final params)."""
    ncfg = nxd.neuronx_distributed_config(tensor_parallel_size=1,
                                          init_mesh=False)
    tx = jlora.make_lora_optimizer(jopt.make_optimizer(
        ncfg, learning_rate=lr, weight_decay=0.01), params)
    state = tx.init(params)
    model = jl.LlamaForCausalLM(jcfg)
    losses, full, adapter = [], [], []
    for ids, labels in batches:
        loss, g = jax.value_and_grad(lambda p: model.apply(
            p, jnp.asarray(ids), jnp.asarray(labels), method="loss"))(params)
        losses.append(float(loss))
        full.append(float(optax.global_norm(g)))
        adapter.append(float(optax.global_norm(
            jlora.extract_lora_state(g))))
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return losses, full, adapter, params


def test_two_adamw_steps_match_optax_multi_transform():
    """Two steps of ``make_train_step`` over ``make_lora_optimizer``
    against JAX's ``optax.multi_transform``: the losses within 1e-5, each
    adapter's update within 1e-3 of its norm, the base bit for bit, moments
    for the adapters only. ``grad_norm`` is the stated divergence: the
    port's is the norm of the adapters' gradients (held to
    ``optax.global_norm`` of JAX's adapter gradients), where the
    reference's covers the frozen base's gradient too."""
    jcfg, tcfg = _configs(dict(r=4, alpha=8.0, target_modules=ALL))
    params = _jax_params(jcfg)
    batches = [_batch(1), _batch(2)]
    losses, full, adapter, jparams = _optax_lora_steps(jcfg, params,
                                                       batches, 1e-3)
    ncfg = neuronx_distributed_config()
    pm, tparams = ttr.initialize_parallel_model(
        ncfg, tcfg, state_dict=params_from_jax(tcfg, params), device="cpu")
    before = {n: p.detach().clone() for n, p in tparams.items()}
    tx = tlora.make_lora_optimizer(
        ttr.make_optimizer(ncfg, learning_rate=1e-3, weight_decay=0.01),
        tparams)
    trainable = ttr.trainable(tparams)
    state = ttr.TrainState(step=0, params=tparams,
                           opt_state=tx.init(trainable))
    n_adapters = len(tlora.extract_lora_state(tparams))
    assert len(trainable) == len(state.opt_state.mu) == n_adapters
    step = ttr.make_train_step(pm, tx)
    for i, (ids, labels) in enumerate(batches):
        _, m = step(state, {"input_ids": ids, "labels": labels})
        np.testing.assert_allclose(m["loss"].item(), losses[i], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), adapter[i],
                                   rtol=1e-5)
        assert m["grad_norm"].item() < full[i]
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    for name, p in tparams.items():
        if tlora.is_lora_path(name):
            upd, ref = p.detach() - before[name], want[name] - before[name]
            assert ref.norm() > 0, name
            assert (upd - ref).norm() <= 1e-3 * ref.norm(), name
        else:
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(want[name].numpy(),
                                          before[name].numpy())


def test_lora_only_training_updates_adapters():
    """tests/test_lora.py's adapter-only training in the port: eight steps
    at lr 1e-2 lower the loss, every adapter moves, no base tensor does."""
    _, tcfg = _configs(dict(r=4, target_modules=("qkv", "o_proj")), layers=1)
    ncfg = neuronx_distributed_config()
    pm, params = ttr.initialize_parallel_model(ncfg, tcfg, seed=1,
                                               device="cpu")
    before = {n: p.detach().clone() for n, p in params.items()}
    tx = tlora.make_lora_optimizer(ttr.make_optimizer(
        ncfg, learning_rate=1e-2), params)
    state = ttr.TrainState(0, params, tx.init(ttr.trainable(params)))
    step = ttr.make_train_step(pm, tx)
    ids = np.random.RandomState(0).randint(0, 256, (4, 17))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    losses = [step(state, batch)[1]["loss"].item() for _ in range(8)]
    assert losses[-1] < losses[0], losses
    for name, p in params.items():
        same = torch.equal(p.detach(), before[name])
        assert same != tlora.is_lora_path(name), name


def test_moments_of_other_parameters_are_refused():
    """Moments made before ``make_lora_optimizer`` froze the base cover
    every parameter; the step then gives only the adapters, and the
    update refuses the mismatch instead of pairing them wrongly."""
    _, tcfg = _configs(dict(r=4, target_modules=("qkv",)), layers=1)
    ncfg = neuronx_distributed_config()
    pm, params = ttr.initialize_parallel_model(ncfg, tcfg, seed=1,
                                               device="cpu")
    tx = ttr.make_optimizer(ncfg, learning_rate=1e-2)
    state = ttr.TrainState(0, params, tx.init(ttr.trainable(params)))
    tx = tlora.make_lora_optimizer(tx, params)
    before = {n: p.detach().clone() for n, p in params.items()}
    ids = np.random.RandomState(0).randint(0, 256, (2, 9))
    with pytest.raises(ValueError, match="make_lora_optimizer before init"):
        ttr.make_train_step(pm, tx)(
            state, {"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    assert all(torch.equal(p.detach(), before[n]) for n, p in params.items())


def test_adapter_checkpoint_roundtrip():
    """``extract_lora_state`` names JAX's adapter leaves; through
    ``torch.save``/``torch.load(weights_only=True)`` and
    ``merge_lora_state`` into wiped params they come back bit for bit."""
    jcfg, tcfg = _configs(dict(r=2, target_modules=("qkv", "gate_up",
                                                    "embed")), layers=1)
    params = _jax_params(jcfg)
    sd = params_from_jax(tcfg, params)
    adapters = tlora.extract_lora_state(sd)
    jadapters = params_from_jax(
        tcfg, jlora.merge_lora_state(
            jax.tree.map(np.zeros_like, params),
            jlora.extract_lora_state(params)))
    assert set(adapters) == {n for n in jadapters
                             if tlora.is_lora_path(n)}
    buf = io.BytesIO()
    torch.save(adapters, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=True)
    wiped = {n: torch.full_like(t, 9.0) if tlora.is_lora_path(n) else t
             for n, t in sd.items()}
    restored = tlora.merge_lora_state(wiped, loaded)
    assert set(restored) == set(sd)
    assert all(torch.equal(restored[n], sd[n]) for n in sd)
    assert tlora.lora_mask(sd) == {n: n in adapters for n in sd}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_merge_lora_params_matches_jax_on_every_triple(dtype):
    """Every triple folds as JAX folds it (2-D kernels, the embedding, the
    three GQA kernels, the fused gate_up), in the dtype the two promote
    to, and the adapters are dropped; a merged model serves the adapted
    logits under the base config."""
    lora = dict(r=4, alpha=8.0, target_modules=ALL)
    jcfg, tcfg = _configs(lora)
    params = jax.tree.map(lambda x: x.astype(dtype), _jax_params(jcfg))
    merged = jlora.merge_lora_params(params, jcfg.lora)
    bj, bt = _configs(None)
    want = params_from_jax(bt, jax.tree.map(np.asarray, merged))
    got = tlora.merge_lora_params(params_from_jax(tcfg, params), tcfg.lora)
    assert set(got) == set(want)
    for name, ref in want.items():
        assert got[name].dtype == ref.dtype, name
        tol = 1e-6 if dtype == jnp.float32 else 1e-2
        np.testing.assert_allclose(got[name].float().numpy(),
                                   ref.float().numpy(), rtol=0,
                                   atol=tol * ref.float().abs().max().item(),
                                   err_msg=name)
    if dtype == jnp.float32:
        ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256,
                                                                (2, 8)))
        with torch.no_grad():
            a = tl.build_model(tcfg, params_from_jax(tcfg, params),
                               "cpu")(ids)
            b = tl.build_model(bt, got, "cpu")(ids)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * a.abs().max().item())


def _conv_pair(lora_rank, strides=(1, 1), padding="SAME"):
    kw = dict(kernel_size=(3, 3), strides=strides, padding=padding,
              dtype=jnp.float32, param_dtype=jnp.float32)
    return (jlayers.OutputChannelParallelConv2d(features=8,
                                                lora_rank=lora_rank, **kw),
            jlayers.InputChannelParallelConv2d(features=6,
                                               lora_rank=lora_rank, **kw))


def _tconv_pair(lora_rank, strides=(1, 1), padding="SAME"):
    kw = dict(kernel_size=(3, 3), strides=strides, padding=padding,
              dtype=torch.float32, device="cpu", lora_rank=lora_rank)
    return (tlayers.OutputChannelParallelConv2d(6, 8, **kw),
            tlayers.InputChannelParallelConv2d(8, 6, **kw))


def _load(layer, p):
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p.items()}, strict=True)
    return layer


@pytest.mark.parametrize("strides,padding", [
    ((1, 1), "SAME"), ((2, 2), "SAME"), ((1, 1), "VALID"), ((2, 1), "VALID"),
    ((1, 1), ((1, 2), (0, 1)))])
def test_conv_pair_matches_jax(strides, padding):
    """The conv pair at tp=1 against JAX's: NHWC, HWIO, bias, strides and
    padding, with and without adapters (nonzero B)."""
    ps.initialize_model_parallel()
    try:
        x = np.random.RandomState(50).randn(2, 9, 8, 6).astype(np.float32)
        for rank in (0, 4):
            jc, jr = _conv_pair(rank, strides, padding)
            p1 = meta.unbox(jc.init(jax.random.key(51),
                                    jnp.asarray(x)))["params"]
            mid = jc.apply({"params": p1}, jnp.asarray(x))
            p2 = meta.unbox(jr.init(jax.random.key(52), mid))["params"]
            rng = np.random.RandomState(rank)
            p1, p2 = ({k: rng.randn(*v.shape).astype(np.float32) * 0.1
                       if k in ("lora_b", "bias") else np.asarray(v)
                       for k, v in p.items()} for p in (p1, p2))
            ref = np.asarray(jr.apply({"params": p2},
                                      jc.apply({"params": p1},
                                               jnp.asarray(x))))
            tc, tr = _tconv_pair(rank, strides, padding)
            _load(tc, p1), _load(tr, p2)
            with torch.no_grad():
                got = tr(tc(torch.from_numpy(x))).numpy()
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    finally:
        ps.destroy_model_parallel()


def test_lora_conv2d_pair():
    """tests/test_lora.py's conv pair in the port: zero B keeps the base
    output, and trained adapters merged into the base kernels reproduce
    the adapted forward (B is 1x1, so the composition is exact)."""
    x = torch.from_numpy(np.random.RandomState(50).randn(2, 8, 8, 6)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    col, row = _tconv_pair(4)
    col0, row0 = _tconv_pair(0)
    for layer in (col, row):
        for name, p in layer.named_parameters():
            p.data = (torch.zeros_like(p) if name == "lora_b" else
                      torch.randn(p.shape, generator=gen) * 0.1)
    for l0, l1 in ((col0, col), (row0, row)):
        l0.load_state_dict({k: v for k, v in l1.state_dict().items()
                            if not tlora.is_lora_path(k)})
    with torch.no_grad():
        ref = row0(col0(x))
        np.testing.assert_allclose(row(col(x)).numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
        for layer in (col, row):
            layer.lora_b.data = torch.randn(layer.lora_b.shape,
                                            generator=gen) * 0.1
        adapted = row(col(x))
        cfg = tlora.LoraConfig(r=4, alpha=16.0)
        for l0, l1 in ((col0, col), (row0, row)):
            m = tlora.merge_lora_params(l1.state_dict(), cfg)
            assert "lora_a" not in m and "lora_b" not in m
            l0.load_state_dict(m)
        np.testing.assert_allclose(row0(col0(x)).numpy(), adapted.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_lora_dropout_live():
    """tests/test_dropout.py's live LoRA dropout on a linear: without a
    generator the output is deterministic and JAX's; two generators give
    two outputs; the dropped adapter input keeps flax's law (kept with
    probability 1 - p, scaled by 1 / (1 - p))."""
    ps.initialize_model_parallel()
    try:
        x = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
        layer = jlayers.ColumnParallelLinear(features=32, dtype=jnp.float32,
                                             lora_rank=4, lora_dropout=0.5)
        params = meta.unbox(layer.init(jax.random.key(1), jnp.asarray(x)))
        params["params"]["lora_b"] = jnp.ones_like(
            params["params"]["lora_b"])
        ref = np.asarray(layer.apply(params, jnp.asarray(x)))
    finally:
        ps.destroy_model_parallel()
    t = _load(tlayers.Linear(16, 32, dtype=torch.float32, device="cpu",
                             use_bias=True, lora_rank=4, lora_dropout=0.5),
              params["params"])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        base = t(xt)
        np.testing.assert_allclose(base.numpy(), ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(base, t(xt))
        d1 = t(xt, lora_generator=torch.Generator().manual_seed(2))
        d2 = t(xt, lora_generator=torch.Generator().manual_seed(3))
        assert not torch.equal(d1, base) and not torch.equal(d1, d2)
    ones = torch.ones(200_000)
    kept = tlayers.dropout(ones, 0.3, torch.Generator().manual_seed(4))
    assert set(kept.unique().tolist()) <= {0.0, torch.tensor(1.0 / 0.7).item()}
    assert abs((kept > 0).float().mean().item() - 0.7) < 5e-3


def test_gqa_lora_dropout_matches_weight_space_at_p0():
    """tests/test_dropout.py's check in the port: with dropout set but no
    generator the fused QKV keeps the weight-space fold, equal to JAX's
    layer with and without the dropout field; with a generator the
    activation-space path engages and differs."""
    ps.initialize_model_parallel()
    try:
        x = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
        kw = dict(num_heads=4, num_kv_heads=2, head_dim=4, dtype=jnp.float32)
        l0 = jlayers.GQAQKVColumnParallelLinear(**kw, lora_rank=2)
        params = meta.unbox(l0.init(jax.random.key(1), jnp.asarray(x)))
        for n in ("q_lora_b", "k_lora_b", "v_lora_b"):
            params["params"][n] = jnp.ones_like(params["params"][n]) * 0.1
        ref = [np.asarray(o) for o in l0.apply(params, jnp.asarray(x))]
    finally:
        ps.destroy_model_parallel()
    tkw = dict(dtype=torch.float32, device="cpu", lora_rank=2)
    t0 = _load(tlayers.GQAQKVColumnParallelLinear(16, 4, 2, 4, **tkw),
               params["params"])
    t1 = _load(tlayers.GQAQKVColumnParallelLinear(16, 4, 2, 4,
                                                  lora_dropout=0.4, **tkw),
               params["params"])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for a, b, r in zip(t0(xt), t1(xt), ref):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-5, atol=1e-6)
        outd = t1(xt, lora_generator=torch.Generator().manual_seed(2))
        assert not torch.equal(outd[0], t0(xt)[0])


@pytest.mark.parametrize("policy", ["nothing", "save_attention"])
def test_lora_dropout_under_remat_is_bit_for_bit(policy):
    """Each layer draws its adapters' dropout seed before it runs, so a
    rematerialised step gives the gradients of the same step without
    remat, bit for bit, and dropout moves the loss."""
    lora = tlora.LoraConfig(r=4, dropout=0.3, target_modules=ALL)
    grads = {}
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    for remat in (False, True):
        cfg = tl.tiny_config(dtype=torch.float32, num_layers=2, lora=lora,
                             use_flash_attention=True, remat=remat,
                             remat_policy=policy)
        sd = tl.init_state_dict(cfg, seed=5, device="cpu")
        sd = {n: t + 0.05 if tlora.is_lora_path(n) else t
              for n, t in sd.items()}
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), cfg, state_dict=sd, device="cpu")
        tlora.make_lora_optimizer(None, params)
        loss = pm.module.loss(ids, labels,
                              dropout_generator=torch.Generator()
                              .manual_seed(7))
        loss.backward()
        with torch.no_grad():
            plain = pm.module.loss(ids, labels)
        assert loss.item() != plain.item()
        grads[remat] = (loss.detach(), {n: p.grad for n, p in params.items()
                                        if p.grad is not None})
    assert torch.equal(grads[False][0], grads[True][0])
    assert grads[False][1].keys() == grads[True][1].keys()
    for n, g in grads[False][1].items():
        assert torch.equal(g, grads[True][1][n]), n


def test_refusals_match_jax():
    """The reference's ``ValueError``s, raised where it raises them:
    ``weight_quant`` with LoRA, ``loss_chunk`` with an ``lm_head``
    adapter, ``tie_embeddings`` with an ``lm_head`` adapter (at call
    time). The port's own: Mixtral refuses ``lora`` (the reference's
    Mixtral has no LoRA of its own), and ``make_lora_optimizer`` refuses
    parameters without an adapter."""
    cases = [
        (dict(weight_quant="int8", lora=("qkv",)), "incompatible with LoRA"),
        (dict(loss_chunk=8, lora=("lm_head",)),
         "loss_chunk is incompatible with LoRA targeting 'lm_head'"),
    ]
    for kw, match in cases:
        targets = kw.pop("lora")
        with pytest.raises(ValueError, match=match):
            jl.tiny_config(lora=jlora.LoraConfig(target_modules=targets),
                           **kw)
        with pytest.raises(ValueError, match=match):
            tl.tiny_config(lora=tlora.LoraConfig(target_modules=targets),
                           **kw)
    jcfg, tcfg = _configs(dict(target_modules=("lm_head",)),
                          tie_embeddings=True)
    ps.initialize_model_parallel()
    try:
        with pytest.raises(ValueError, match="incompatible with "
                                             "tie_embeddings"):
            jl.LlamaForCausalLM(jcfg).init(jax.random.key(0),
                                           jnp.zeros((1, 4), jnp.int32))
    finally:
        ps.destroy_model_parallel()
    model = tl.LlamaForCausalLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="incompatible with tie_embeddings"):
        model.logits(torch.zeros(1, 4, tcfg.hidden_size))
    with pytest.raises(ValueError, match="lora"):
        tm.tiny_moe_config(lora=tlora.LoraConfig())
    _, base = _configs(None, layers=1)
    _, params = _port_model(base, _jax_params(_configs(None, layers=1)[0]))
    with pytest.raises(ValueError, match="no LoRA adapter"):
        tlora.make_lora_optimizer(None, params)


def test_generate_unmerged_and_served_merged_match_jax():
    """``examples/inference/lora_serve.py`` in the port: ``generate`` on the
    LoRA config unmerged gives JAX's greedy ids, and the merged weights
    under the base config, served by ``ServingEngine``, give JAX's
    ``generate`` ids on its merged params."""
    from neuronx_distributed_tpu_torch.inference import engine as te

    lora = dict(r=4, alpha=8.0, target_modules=("qkv", "o_proj", "down"))
    jcfg, tcfg = _configs(lora)
    bj, bt = _configs(None)
    params = _jax_params(jcfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (2, 8)).astype(np.int32)
    plen = np.full((2,), 8, np.int32)
    ref = np.asarray(jg.generate(jcfg, params, jnp.asarray(ids),
                                 jnp.asarray(plen), 6, buckets=(8,)))
    model = tl.build_model(tcfg, params_from_jax(tcfg, params), "cpu")
    got = tg.generate(model, ids, plen, 6, buckets=(8,))
    np.testing.assert_array_equal(got.numpy(), ref)
    merged = jlora.merge_lora_params(params, jcfg.lora)
    ref_m = np.asarray(jg.generate(bj, merged, jnp.asarray(ids),
                                   jnp.asarray(plen), 6, buckets=(8,)))
    sd = tlora.merge_lora_params(params_from_jax(tcfg, params), tcfg.lora)
    eng = te.ServingEngine(bt, sd, te.EngineConfig(
        block_size=4, num_blocks=32, max_slots=2, max_blocks_per_seq=8,
        token_budget=16), device="cpu")
    for i in range(2):
        eng.submit(ids[i].tolist(), 6, uid=f"r{i}")
    res = eng.run()
    np.testing.assert_array_equal(
        np.asarray([res[f"r{i}"].tokens for i in range(2)]), ref_m)


def test_lora_config_bundle_saves_and_serves(tmp_path):
    """The reference exports any traced function, a LoRA config's
    included, so a bundle of a LoRA model's workers saves, loads (the
    config crosses as JSON, ``LoraConfig`` among the dataclasses a bundle
    may build) and gives the saved model's prefill logits bit for bit."""
    from neuronx_distributed_tpu_torch.inference import engine as te
    from neuronx_distributed_tpu_torch.inference import model_builder as mb

    _, tcfg = _configs(dict(r=2, target_modules=("qkv", "down")), layers=1)
    sd = tl.init_state_dict(tcfg, seed=2, device="cpu")
    sd = {n: t + 0.1 if tlora.is_lora_path(n) else t for n, t in sd.items()}
    ecfg = te.EngineConfig(block_size=4, num_blocks=16, max_slots=2,
                           max_blocks_per_seq=8, token_budget=8,
                           disaggregated=True)
    path = str(tmp_path / "lora.nxd")
    spec = mb.serving_state_spec(tcfg, ecfg)
    model = mb.register_serving_workers(mb.ModelBuilder(), tcfg, ecfg, sd,
                                        device="cpu").trace().compile()
    model.save(path, params=sd, state_spec=spec)
    loaded = mb.NxDModel.load(path, device="cpu")
    assert loaded.keys() == model.keys()
    model.state_spec, model.device = spec, torch.device("cpu")
    tables = np.full((2, 8), -1, np.int32)
    tables[0, :2] = [4, 9]
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (1, 8)))
    pos = torch.arange(8, dtype=torch.int32)[None]
    slots = torch.zeros(8, dtype=torch.int32)
    out = []
    for m in (model, loaded):
        state = m.init_state()
        state.block_tables.copy_(torch.from_numpy(tables))
        out.append(m.forward("chunked_prefill", loaded.params, state,
                             prompt, pos, slots)[0].clone())
    assert torch.equal(out[0], out[1])
    with torch.no_grad():
        want = tl.build_model(tcfg, sd, "cpu")(prompt)
    np.testing.assert_allclose(out[1].numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_chunked_loss_and_remat_with_a_frozen_head_match_jax():
    """LoRA with ``loss_chunk`` (no adapter on the head) and remat
    (``save_attention``): the loss and every adapter gradient within 1e-4
    of JAX's fused chunked loss; the frozen LM head gets no dW."""
    lora = dict(r=4, alpha=8.0, target_modules=("qkv", "gate_up", "down"))
    jcfg, tcfg = _configs(lora, loss_chunk=8, remat=True,
                          remat_policy="save_attention")
    params = _jax_params(jcfg)
    ids, labels = _batch(3)
    jloss, jgrads = jax.value_and_grad(lambda p: jl.LlamaForCausalLM(
        jcfg).apply(p, jnp.asarray(ids), jnp.asarray(labels),
                    method="loss"))(params)
    model, tparams = _port_model(tcfg, params)
    tlora.make_lora_optimizer(None, tparams)
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert tparams["lm_head.kernel"].grad is None
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    for name, p in tparams.items():
        if tlora.is_lora_path(name):
            ref = want[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
