"""The port's chunked LM loss, remat policies, tied embeddings,
``configure_model`` and fp32 master weights against the JAX package.

* ``fused_linear_cross_entropy`` against JAX's, at chunks that divide S and
  that do not, with ``ignore_index`` rows: the loss, dx and dW (in bf16,
  dW summed in bf16 over the chunks as JAX's scan transpose sums it).
* remat: every policy gives the gradients of no remat bit for bit, and
  JAX's with the same policy within 1e-4 x max|g|; the flash forward runs
  once a layer under ``save_attention`` and twice under ``"nothing"``.
* tied embeddings: loss and gradients against JAX, the table's gradient
  summing over both its uses.
* ``configure_model`` gives JAX's fields for every mode;
  ``with_fp32_master_weights`` follows optax over 5 updates.

Weights cross with ``params_from_jax``.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu import config as jconfig
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import loss_functions as jlf
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import mixed_precision as jmp
from neuronx_distributed_tpu_torch import config as tconfig
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.ops import flash_attention as tfa
from neuronx_distributed_tpu_torch.parallel import loss_functions as tlf
from neuronx_distributed_tpu_torch.trainer import mixed_precision as tmp
from neuronx_distributed_tpu_torch.trainer.optimizer import AdamW
from neuronx_distributed_tpu_torch.utils import remat as tremat

_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def mesh():
    ps.initialize_model_parallel(tensor_model_parallel_size=1)
    yield
    ps.destroy_model_parallel()


def _loss_inputs(seed, b=2, s=40, h=32, v=96):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h).astype(np.float32)
    kernel = (0.1 * rng.randn(h, v)).astype(np.float32)
    labels = rng.randint(0, v, (b, s)).astype(np.int32)
    labels[0, :7] = -100
    labels[1, -3:] = -100
    return x, kernel, labels


def _rel_max(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name,chunk,grad_tol", [
    ("fp32", 8, 1e-4), ("fp32", 12, 1e-4), ("fp32", 40, 1e-4),
    ("fp32", 64, 1e-4), ("bf16", 8, 5e-4), ("bf16", 12, 5e-4)])
def test_fused_loss_matches_jax(mesh, name, chunk, grad_tol):
    """S=40: chunks 8 and 40 divide it, 12 and 64 pad it with
    ``ignore_index``. In bf16 the gradients are held to 5e-4 of max|g|,
    not 1e-4: dx and dW are bf16 products and sums on both sides, and the
    two round differently (dW up to 2.3e-4 apart here). dW sums in bf16 over the
    chunks, last chunk first, as JAX's scan transpose does: summed in fp32
    it departs from JAX by 3e-3 to 5e-3 of max|dW|, past this limit."""
    jdt, tdt = _DTYPES[name]
    x, kernel, labels = _loss_inputs(0)

    def jloss(x, k):
        return jlf.fused_linear_cross_entropy(
            x.astype(jdt), k, jnp.asarray(labels), chunk=chunk, dtype=jdt)

    ref, (gx, gk) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(kernel))
    xt = torch.tensor(x, requires_grad=True)
    kt = torch.tensor(kernel, requires_grad=True)
    got = tlf.fused_linear_cross_entropy(xt.to(tdt), kt,
                                         torch.from_numpy(labels),
                                         chunk=chunk, dtype=tdt)
    got.backward()
    assert abs(got.item() - float(ref)) <= 1e-5 * abs(float(ref))
    assert kt.grad.dtype == torch.float32
    assert _rel_max(xt.grad.numpy(), np.asarray(gx)) <= grad_tol
    assert _rel_max(kt.grad.numpy(), np.asarray(gk)) <= grad_tol


def test_fused_loss_equals_the_full_logits_loss():
    x, kernel, labels = _loss_inputs(1)
    grads = []
    for chunk in (None, 12):
        xt = torch.tensor(x, requires_grad=True)
        kt = torch.tensor(kernel, requires_grad=True)
        lab = torch.from_numpy(labels)
        loss = (tlf.causal_lm_loss(xt @ kt, lab) if chunk is None else
                tlf.fused_linear_cross_entropy(xt, kt, lab, chunk=chunk,
                                               dtype=torch.float32))
        loss.backward()
        grads.append((loss.item(), xt.grad, kt.grad))
    (l0, x0, k0), (l1, x1, k1) = grads
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    torch.testing.assert_close(x1, x0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k1, k0, rtol=1e-5, atol=1e-6)


def test_invalid_configs_raise_where_jax_raises():
    bad = [dict(loss_chunk=0), dict(loss_chunk=-4),
           dict(loss_chunk=16, tie_embeddings=True),
           dict(remat_policy="no_such_policy")]
    for kw in bad:
        with pytest.raises(ValueError):
            jl.tiny_config(**kw)
        with pytest.raises(ValueError):
            tl.tiny_config(**kw)
    # the port has only its five names; JAX also takes its own policies
    jl.tiny_config(remat_policy="everything_saveable")
    with pytest.raises(ValueError, match="JAX's"):
        tl.tiny_config(remat_policy="everything_saveable")
    for name in tremat.POLICIES:
        jl.tiny_config(remat_policy=name)
        tl.tiny_config(remat_policy=name)
    # Mixtral's tied embeddings and chunked loss come later (its remat is
    # ported: tests/test_torch_mixtral.py)
    from neuronx_distributed_tpu_torch.models import mixtral as tm

    for kw in (dict(tie_embeddings=True), dict(loss_chunk=16)):
        with pytest.raises(ValueError, match="later"):
            tm.tiny_moe_config(**kw)
    with pytest.raises(ValueError, match="positive"):
        tlf.fused_linear_cross_entropy(torch.zeros(1, 4, 8),
                                       torch.zeros(8, 16),
                                       torch.zeros(1, 4, dtype=torch.long),
                                       chunk=0)


def _jax_grads(jcfg, params, ids, labels):
    model = jl.LlamaForCausalLM(jcfg)
    loss, grads = jax.value_and_grad(
        lambda p: model.apply(p, ids, labels=labels))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _models(seed=1, s=32, **kw):
    """The same tiny fp32 Llama (flash attention) in both packages."""
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          use_flash_attention=True, **kw)
    tcfg = tl.tiny_config(dtype=torch.float32, use_flash_attention=True,
                          **kw)
    ids = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, (2, s + 1)).astype(np.int32)
    params = meta.unbox(jl.LlamaForCausalLM(
        dataclasses.replace(jcfg, remat=False)).init(
            jax.random.key(seed), jnp.asarray(ids[:, :-1])))
    return jcfg, tcfg, params, ids[:, :-1], ids[:, 1:]


def _port_grads(tcfg, params, ids, labels):
    model = tl.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_close(tcfg, got, jgrads, tol=1e-4):
    ref = params_from_jax(tcfg, jgrads)
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name].numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (name, err, np.abs(r).max())


@pytest.mark.parametrize("policy", tremat.POLICIES)
def test_remat_gradients_are_bitwise_and_match_jax(mesh, policy,
                                                   monkeypatch):
    jcfg, tcfg, params, ids, labels = _models(remat=True,
                                              remat_policy=policy)
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a: (calls.append(1), plain(*a))[1])
    loss_ref, ref = _port_grads(dataclasses.replace(tcfg, remat=False),
                                params, ids, labels)
    assert len(calls) == tcfg.num_layers
    calls.clear()
    loss, got = _port_grads(tcfg, params, ids, labels)
    saves_attention = policy in ("save_attention", "dots_and_attention")
    assert len(calls) == tcfg.num_layers * (1 if saves_attention else 2)
    assert loss == loss_ref
    for name, g in got.items():
        assert torch.equal(g, ref[name]), name
    jloss, jgrads = _jax_grads(jcfg, params, ids, labels)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(tcfg, got, jgrads)


def test_remat_keeps_dropout_masks(mesh):
    """Each layer's dropout seed is drawn before the layer runs, so the
    recompute sees the same mask: gradients with remat equal those without
    under attention dropout, and the generator advances alike."""
    _, tcfg, params, ids, labels = _models(attention_dropout=0.2)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat,
                                  remat_policy="nothing")
        model = tl.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(params_from_jax(
            cfg, jax.tree.map(np.asarray, params)))
        gen = torch.Generator().manual_seed(3)
        loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                          dropout_generator=gen)
        loss.backward()
        out.append((loss.item(), [p.grad for p in model.parameters()],
                    gen.get_state()))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert torch.equal(out[0][2], out[1][2])


def test_model_loss_chunk_matches_jax(mesh):
    jcfg, tcfg, params, ids, labels = _models(loss_chunk=12)
    labels = labels.copy()
    labels[0, :5] = -100
    loss, got = _port_grads(tcfg, params, ids, labels)
    jloss, jgrads = _jax_grads(jcfg, params, ids, labels)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(tcfg, got, jgrads)
    full, _ = _port_grads(dataclasses.replace(tcfg, loss_chunk=None),
                          params, ids, labels)
    assert abs(loss - full) <= 1e-6 * abs(full)


def test_tied_embeddings_match_jax(mesh):
    jcfg, tcfg, params, ids, labels = _models(tie_embeddings=True)
    assert "lm_head" not in params["params"]
    loss, got = _port_grads(tcfg, params, ids, labels)
    assert "lm_head.kernel" not in got
    jloss, jgrads = _jax_grads(jcfg, params, ids, labels)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(tcfg, got, jgrads)
    # the untied bridge refuses a tied tree, and the tied one an untied tree
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(dataclasses.replace(tcfg, tie_embeddings=False),
                        jax.tree.map(np.asarray, params))


def test_tied_embeddings_serve_through_the_table(mesh):
    """The cached forward's logits use the table as the training forward
    does."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import (
        init_kv_cache)

    _, tcfg, params, ids, _ = _models(tie_embeddings=True)
    model = tl.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    ids_t = torch.from_numpy(ids)
    with torch.no_grad():
        full = model(ids_t)
        cache = init_kv_cache(tcfg.num_layers, 2, ids.shape[1],
                              tcfg.num_kv_heads, tcfg.head_dim_,
                              dtype=torch.float32, device="cpu")
        pos = torch.arange(ids.shape[1]).expand(2, -1)
        cached, _ = tl.llama_forward_with_cache(model, ids_t, pos, cache)
    torch.testing.assert_close(cached, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["none", "full", "attention", "custom"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_configure_model_matches_jax(mode, compute):
    jcfg = jconfig.neuronx_distributed_config(
        activation_checkpoint_config=jconfig.ActivationCheckpointConfig(
            mode=mode, policy="dots"),
        mixed_precision_config=jconfig.MixedPrecisionConfig(
            compute_dtype=compute), init_mesh=False)
    tcfg = tconfig.neuronx_distributed_config(
        activation_checkpoint_config=tconfig.ActivationCheckpointConfig(
            mode=mode, policy="dots"),
        mixed_precision_config=tconfig.MixedPrecisionConfig(
            compute_dtype=compute))
    jm = jconfig.configure_model(jcfg, jl.tiny_config(
        remat_policy="save_attention"))
    tm = tconfig.configure_model(tcfg, tl.tiny_config(
        remat_policy="save_attention"))
    assert tm.remat == jm.remat == (mode != "none")
    assert str(tm.dtype).split(".")[-1] == jnp.dtype(jm.dtype).name
    # neither carries the policy
    assert tm.remat_policy == jm.remat_policy == "save_attention"
    # tp_size and sequence_parallel are carried as JAX carries them
    tp = 2
    jm = jconfig.configure_model(jconfig.neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=True, init_mesh=False),
        jl.tiny_config())
    tm = tconfig.configure_model(tconfig.neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=True, init_mesh=False),
        tl.tiny_config())
    assert (tm.tp_size, tm.sequence_parallel) == (
        jm.tp_size, jm.sequence_parallel) == (tp, True)
    with pytest.raises(ValueError, match="process group"):
        tconfig.neuronx_distributed_config(
            tensor_parallel_size=tp,
            activation_checkpoint_config=tconfig.ActivationCheckpointConfig(
                mode=mode))


@pytest.mark.parametrize("make", [
    lambda: tconfig.MixedPrecisionConfig(use_master_weights=False),
    lambda: tconfig.MixedPrecisionConfig(use_fp32_grad_acc=False),
    lambda: tconfig.MixedPrecisionConfig(use_master_weights_in_ckpt=True),
    lambda: tconfig.CheckpointConfig(output_dir="ck"),
    lambda: tconfig.CheckpointConfig(save_interval=100),
    lambda: tconfig.CheckpointConfig(keep_last=2),
    lambda: tconfig.CheckpointConfig(async_save=False),
    lambda: tconfig.CheckpointConfig(use_master_weights_in_ckpt=True),
], ids=["master_weights", "fp32_grad_acc", "mp_master_in_ckpt",
        "output_dir", "save_interval", "keep_last", "async_save",
        "ckpt_master_in_ckpt"])
def test_config_fields_the_port_does_not_read_raise(make):
    """Nothing in the port reads these fields, so a value other than the
    default raises instead of being ignored; the defaults still build."""
    with pytest.raises(ValueError, match="only the default"):
        make()
    cfg = tconfig.neuronx_distributed_config(
        mixed_precision_config=tconfig.MixedPrecisionConfig(
            compute_dtype="float32"),
        checkpoint_config=tconfig.CheckpointConfig())
    assert cfg.mixed_precision.compute_dtype == "float32"


def test_master_weights_follow_optax():
    """bf16 parameters with fp32 masters, 5 AdamW updates: the masters
    within 1e-6 relative of JAX's ``with_fp32_master_weights(optax.adamw)``
    and the live parameters equal to the masters cast to bf16."""
    rng = np.random.RandomState(4)
    shapes = [(16, 8), (8,), (4, 4, 3)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    jtx = jmp.with_fp32_master_weights(optax.adamw(1e-2, **kw))
    jparams = [jnp.asarray(p, jnp.bfloat16) for p in init]
    jstate = jtx.init(jparams)
    ttx = tmp.with_fp32_master_weights(AdamW(learning_rate=1e-2,
                                             max_grad_norm=None, **kw))
    tparams = [torch.tensor(p).to(torch.bfloat16) for p in init]
    tstate = ttx.init(tparams)
    for g in grads:
        jg = [jnp.asarray(x, jnp.bfloat16) for x in g]
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        ttx.update(tparams, [torch.tensor(x).to(torch.bfloat16) for x in g],
                   tstate)
    assert tstate.inner.count == 5
    for m, jm_, p in zip(tstate.master, jstate.master, tparams):
        ref = np.asarray(jm_)
        assert m.dtype == torch.float32
        assert np.abs(m.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, m.to(torch.bfloat16))
