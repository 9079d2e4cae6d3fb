"""GPT-NeoX, BERT and ViT in the PyTorch port against the JAX package:
logits, loss and every gradient of tiny fp32 models on JAX's weights
(crossed by ``params_from_jax``), with flash attention on and off and the
variants (sequential residual, rotary_pct 0 and 1, the tied MLM transform
head, token types), three ``make_train_step`` steps, attention dropout's
mask, the layers (LayerNorm, partial rotary, ``patchify``), remat, the
stated divergence of hidden dropout, refusals, a run that imports nothing
of JAX, and the ViT classifier served through ``ModelBuilder`` as
``examples/inference/vit_serve.py`` serves it.

On the JAX side BERT and GPT-NeoX reach the Pallas flash kernel in
interpret mode (``flash_attention(force_pallas=True)``, their heads padded
to 128); ViT's odd length (4 patches + CLS) reaches JAX's XLA scan, as
tests/test_model_families.py runs it."""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.inference import model_builder as jmb
from neuronx_distributed_tpu.models import bert as jb
from neuronx_distributed_tpu.models import gpt_neox as jn
from neuronx_distributed_tpu.models import vit as jv
from neuronx_distributed_tpu.modules import attention as jattn
from neuronx_distributed_tpu.modules import norms as jnorms
from neuronx_distributed_tpu.ops import flash_attention as jfa
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.inference import model_builder as mb
from neuronx_distributed_tpu_torch.models import bert as tb
from neuronx_distributed_tpu_torch.models import common
from neuronx_distributed_tpu_torch.models import gpt_neox as tn
from neuronx_distributed_tpu_torch.models import vit as tv
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.modules import attention as tattn
from neuronx_distributed_tpu_torch.modules import norms as tnorms
from neuronx_distributed_tpu_torch.parallel import layers as tlayers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
FAMILIES = {  # name: (JAX module, port module, JAX class, config function)
    "neox": (jn, tn, "GPTNeoXForCausalLM", "tiny_neox_config"),
    "bert": (jb, tb, "BertForPreTraining", "tiny_bert_config"),
    "vit": (jv, tv, "ViTForImageClassification", "tiny_vit_config"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(family, **kw):
    jmod, tmod, _, fn = FAMILIES[family]
    return (getattr(jmod, fn)(dtype=jnp.float32, param_dtype=jnp.float32,
                              **kw),
            getattr(tmod, fn)(dtype=torch.float32, **kw))


def _inputs(family, seed=0, types=False):
    """The model's positional inputs (numpy) and the loss's labels."""
    rng = np.random.RandomState(seed)
    if family == "vit":
        px = rng.randn(B, 3, 16, 16).astype(np.float32)
        return (px,), rng.randint(0, 8, (B,)).astype(np.int32)
    ids = rng.randint(0, 256, (B, S + 1)).astype(np.int32)
    if family == "neox":
        return (ids[:, :-1],), ids[:, 1:]
    labels = np.full((B, S), -100, np.int32)
    mask = rng.rand(B, S) < 0.3
    labels[mask] = ids[:, :-1][mask]
    args = (ids[:, :-1],)
    if types:
        args += (rng.randint(0, 2, (B, S)).astype(np.int32),)
    return args, labels


def _jax_params(family, jcfg, args, seed=1):
    jmod, _, cls, _ = FAMILIES[family]
    ps.initialize_model_parallel()
    try:
        return jax.tree.map(np.array, meta.unbox(getattr(jmod, cls)(
            jcfg).init(jax.random.key(seed), *map(jnp.asarray, args))))
    finally:
        ps.destroy_model_parallel()


@pytest.fixture
def pallas_flash(monkeypatch):
    """JAX's flash dispatcher forced onto the Pallas kernel (interpret mode
    on the CPU; D padded to 128) wherever the length tiles by 8."""
    orig = jfa.flash_attention

    def forced(q, k, v, **kw):
        return orig(q, k, v, force_pallas=q.shape[1] % 8 == 0, **kw)

    monkeypatch.setattr(jfa, "flash_attention", forced)


def _jax_loss(family, model, params, args, labels):
    if family == "vit":
        return model.apply(params, jnp.asarray(args[0]), jnp.asarray(labels),
                           method="loss")
    if len(args) == 2:        # token types: the forward, then the loss
        from neuronx_distributed_tpu.parallel import loss_functions as jlf

        return jlf.causal_lm_loss(model.apply(params,
                                              *map(jnp.asarray, args)),
                                  jnp.asarray(labels))
    return model.apply(params, jnp.asarray(args[0]), jnp.asarray(labels),
                       method="loss")


def _port_loss(family, model, args, labels):
    t = [torch.from_numpy(a) for a in args]
    lab = torch.from_numpy(labels)
    if family == "vit":
        return model.loss(t[0], lab)
    if len(t) == 2:
        from neuronx_distributed_tpu_torch.parallel.loss_functions import (
            causal_lm_loss)

        return causal_lm_loss(model(t[0], t[1]), lab.long())
    return model.loss(t[0], lab.long())


VARIANTS = [
    ("neox", {}), ("neox", dict(use_parallel_residual=False)),
    ("neox", dict(rotary_pct=0.0)), ("neox", dict(rotary_pct=1.0)),
    ("bert", {}), ("bert", dict(mlm_transform=True)),
    ("bert", dict(types=True)), ("vit", {}),
]


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("family,kw", VARIANTS)
def test_logits_loss_and_grads_match_jax(pallas_flash, family, kw, flash):
    kw = dict(kw)
    types = kw.pop("types", False)
    jcfg, tcfg = _configs(family, use_flash_attention=flash, **kw)
    args, labels = _inputs(family, types=types)
    params = _jax_params(family, jcfg, args)
    jmod, tmod, cls, _ = FAMILIES[family]
    jmodel = getattr(jmod, cls)(jcfg)
    ref = np.asarray(jmodel.apply(params, *map(jnp.asarray, args)))
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(family, jmodel, p, args, labels))(params)
    model = getattr(tmod, cls)(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tcfg, params), strict=True)
    with torch.no_grad():
        got = model(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    loss = _port_loss(family, model, args, labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    if family == "bert" and not types:
        want.pop("type_embedding")      # zeros the bridge adds: no grad
        assert model.type_embedding.grad is None
    for name, ref_g in want.items():
        ref_g = ref_g.numpy()
        g = dict(model.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(g, ref_g, rtol=0,
                                   atol=1e-4 * _grad_scale(want, name),
                                   err_msg=name)


def _grad_scale(grads, name):
    """max|g| of the tensor, but for a key bias the scale of the terms
    its gradient sums: where nothing position-dependent acts on the keys
    (no rotary) a key bias adds one constant to a query's scores, which
    the softmax ignores, so its exact gradient is zero and both packages
    return rounding noise of the key kernel's gradient terms."""
    if name.endswith("k_bias"):
        name = name[:-len("k_bias")] + "k_kernel"
    return np.abs(grads[name].numpy()).max()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_names_and_shapes_match_the_jax_tree(family):
    """``init_state_dict`` makes exactly the tensors ``params_from_jax``
    carries across: zeros for biases and the CLS token, ones for LayerNorm
    scales, normal(0, std) for the rest."""
    kw = dict(mlm_transform=True) if family == "bert" else {}
    jcfg, tcfg = _configs(family, **kw)
    args, _ = _inputs(family, types=family == "bert")
    want = params_from_jax(tcfg, _jax_params(family, jcfg, args))
    _, tmod, _, _ = FAMILIES[family]
    sd = tmod.init_state_dict(tcfg, seed=3, std=0.5, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for name, t in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            assert torch.equal(t, torch.ones_like(t)), name
        elif leaf.endswith("bias") or leaf == "cls_token":
            assert torch.equal(t, torch.zeros_like(t)), name
        else:
            assert 0.3 < t.std().item() < 0.7, name
    assert all(t.dtype == torch.float32 for t in sd.values())


def _jax_train(family, jcfg, args, labels, lr, steps):
    jmod, _, cls, _ = FAMILIES[family]
    cfg = nxd.neuronx_distributed_config(tensor_parallel_size=1,
                                         devices=jax.devices()[:1])
    try:
        pm, params = jtr.initialize_parallel_model(
            cfg, getattr(jmod, cls)(jcfg), jax.random.key(0),
            jnp.asarray(args[0]))
        tx, state, sh = jtr.initialize_parallel_optimizer(
            pm, params, learning_rate=lr)
        kw = {}
        if family == "vit":
            kw["loss_fn"] = lambda module, p, b: module.apply(
                p, b["pixel_values"], b["labels"], method="loss")
        step = jtr.make_train_step(pm, tx, sh, donate=False, **kw)
        start = jax.tree.map(np.array, params)
        batch = _batch(family, args, labels)
        losses = []
        for _ in range(steps):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            losses.append(float(m["loss"]))
        return start, losses
    finally:
        ps.destroy_model_parallel()


def _batch(family, args, labels):
    if family == "vit":
        return {"pixel_values": args[0], "labels": labels}
    return {"input_ids": args[0], "labels": labels}


def _vit_loss_fn(module, params, batch):
    return module.loss(batch["pixel_values"], batch["labels"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_train_steps_match_jax(family):
    """``initialize_parallel_model`` picks the family from the config;
    three steps of ``make_train_step`` (AdamW, clipped at 1.0) from JAX's
    initial weights give JAX's losses within 1e-4. ViT trains through a
    ``loss_fn`` over pixel_values and labels, as in the reference."""
    jcfg, tcfg = _configs(family, use_flash_attention=True)
    args, labels = _inputs(family)
    lr = 3e-3
    start, want = _jax_train(family, jcfg, args, labels, lr, 3)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), tcfg,
        state_dict=params_from_jax(tcfg, start), device="cpu")
    _, tmod, cls, _ = FAMILIES[family]
    assert type(pm.module) is getattr(tmod, cls)
    tx, state = ttr.initialize_parallel_optimizer(pm, params,
                                                  learning_rate=lr)
    step = ttr.make_train_step(
        pm, tx, loss_fn=_vit_loss_fn if family == "vit" else None)
    batch = _batch(family, args, labels)
    got = [step(state, batch)[1]["loss"].item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    if family == "bert":      # the loss never reads token types
        assert not state.params["type_embedding"].any()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradients_equal_no_remat_bitwise(family):
    """``remat=True`` recomputes each layer whole and gives the gradients
    of ``remat=False`` bit for bit, also with attention and hidden dropout
    on: each layer's seeds are drawn before it runs, so the recompute draws
    the same masks."""
    kw = {} if family == "neox" else dict(hidden_dropout=0.1)
    args, labels = _inputs(family)
    grads = []
    for remat in (False, True):
        _, tcfg = _configs(family, use_flash_attention=True, remat=remat,
                           attention_dropout=0.1, **kw)
        _, tmod, cls, _ = FAMILIES[family]
        model = getattr(tmod, cls)(tcfg, device="cpu")
        model.load_state_dict(tmod.init_state_dict(tcfg, seed=4,
                                                   device="cpu"))
        gen = torch.Generator().manual_seed(9)
        t = [torch.from_numpy(a) for a in args]
        loss = model.loss(t[0], torch.from_numpy(labels).long(),
                          dropout_generator=gen)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


@pytest.mark.parametrize("family", ["bert", "neox"])
def test_attention_dropout_mask_matches_jax(monkeypatch, family):
    """Attention dropout draws the flash kernels' counter-hash mask: given
    the same seed, the port's logits equal JAX's (flash and dense)."""
    monkeypatch.setattr(jattn, "attention_dropout_seed",
                        lambda module, rate: (rate, jnp.uint32(1234))
                        if rate > 0 else (0.0, None))
    monkeypatch.setattr(common, "attention_dropout_seed",
                        lambda rate, gen: (rate, 1234) if rate > 0
                        else (0.0, None))
    for flash in (True, False):
        jcfg, tcfg = _configs(family, attention_dropout=0.3,
                              use_flash_attention=flash)
        args, _ = _inputs(family)
        params = _jax_params(family, jcfg, args)
        jmod, tmod, cls, _ = FAMILIES[family]
        ref = np.asarray(getattr(jmod, cls)(jcfg).apply(
            params, jnp.asarray(args[0])))
        model = getattr(tmod, cls)(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(tcfg, params))
        with torch.no_grad():
            got = model(torch.from_numpy(args[0])).numpy()
            model.cfg = dataclasses.replace(tcfg, attention_dropout=0.0)
            undropped = model(torch.from_numpy(args[0])).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        assert np.abs(got - undropped).max() > 1e-3


def test_hidden_dropout_keep_rate_and_scale():
    """The stated divergence: hidden dropout draws its masks from a
    ``torch.Generator`` (JAX from flax's rng), so the masks differ from
    JAX's; what is held is flax ``nn.Dropout``'s law: each element kept
    with probability 1 - p, kept ones scaled by 1/(1 - p), the rest zero;
    and nothing changes without a generator or at p = 0."""
    x = torch.rand(256, 512) + 0.5
    for p in (0.1, 0.5):
        gen = torch.Generator().manual_seed(0)
        y = tlayers.dropout(x, p, gen)
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - p)) < 0.01
        assert torch.equal(y[kept], x[kept] / (1 - p))
    assert tlayers.dropout(x, 0.1, None) is x
    assert tlayers.dropout(x, 0.0, torch.Generator()) is x
    # without a generator a model with dropout configured is JAX's without
    # a "dropout" rng
    for family in ("bert", "vit"):
        jcfg, tcfg = _configs(family, hidden_dropout=0.1,
                              attention_dropout=0.1)
        args, _ = _inputs(family)
        params = _jax_params(family, jcfg, args)
        jmod, tmod, cls, _ = FAMILIES[family]
        ref = np.asarray(getattr(jmod, cls)(jcfg).apply(
            params, jnp.asarray(args[0])))
        model = getattr(tmod, cls)(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(tcfg, params))
        with torch.no_grad():
            got = model(torch.from_numpy(args[0])).numpy()
            gen = torch.Generator().manual_seed(1)
            dropped = model(torch.from_numpy(args[0]),
                            dropout_generator=gen).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        assert np.abs(dropped - got).max() > 1e-3


@pytest.mark.parametrize("use_bias", [True, False])
def test_layer_norm_matches_jax(use_bias):
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 5, 48) * 3 + 1).astype(np.float32)
    scale = rng.randn(48).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    p = {"scale": scale, "bias": bias} if use_bias else {"scale": scale}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = jnorms.LayerNorm(eps=1e-5, use_bias=use_bias, dtype=jdt).apply(
            {"params": p}, jnp.asarray(x).astype(jdt))
        ln = tnorms.LayerNorm(48, 1e-5, use_bias=use_bias, dtype=tdt,
                              device="cpu", param_dtype=torch.float32)
        ln.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
        with torch.no_grad():
            got = ln(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=1e-5 if tdt == torch.float32 else 0,
                                   atol=1e-5 if tdt == torch.float32
                                   else 2 ** -7 * np.abs(np.asarray(
                                       ref.astype(jnp.float32))).max())


@pytest.mark.parametrize("rot", [0, 2, 8, 16])
def test_partial_rotary_matches_jax(rot):
    """The first ``rot`` of each head rotate (tables of ``max(2, rot)``),
    the rest pass through; 0 disables rotary."""
    x = np.random.RandomState(rot).randn(2, 7, 3, 16).astype(np.float32)
    jc, js = jattn.precompute_rope(max(2, rot), 32)
    tc, ts = tattn.precompute_rope(max(2, rot), 32)
    want = (np.asarray(jnp.concatenate([
        jattn.apply_rotary(jnp.asarray(x)[..., :rot], jc, js),
        jnp.asarray(x)[..., rot:]], axis=-1)) if rot else x)
    got = tattn.apply_partial_rotary(torch.from_numpy(x), tc, ts, rot)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_patchify_matches_jax():
    x = np.random.RandomState(5).randn(2, 3, 28, 28).astype(np.float32)
    np.testing.assert_array_equal(
        tv.patchify(torch.from_numpy(x), 14).numpy(),
        np.asarray(jv.patchify(jnp.asarray(x), 14)))


@pytest.mark.parametrize("field", ["sequence_parallel", "scan_layers",
                                   "tp_size"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_configs_refuse_what_the_port_does_not_run(family, field):
    """The JAX configs' ``sequence_parallel``, ``scan_layers`` and
    ``tp_size`` are no fields of the port's (one device, unrolled
    layers): passing one is a ``TypeError``, as with ``LlamaConfig``."""
    _, tmod, _, fn = FAMILIES[family]
    with pytest.raises(TypeError, match=field):
        getattr(tmod, fn)(**{field: 1})


def test_vit_config_and_presets_match_jax():
    with pytest.raises(ValueError, match="divisible"):
        tv.ViTConfig(image_size=225)
    for name in ("VIT_BASE", "VIT_LARGE", "VIT_HUGE"):
        j, t = getattr(jv, name), getattr(tv, name)
        for f in ("image_size", "patch_size", "hidden_size",
                  "intermediate_size", "num_layers", "num_heads",
                  "num_labels", "num_patches"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    assert (tv.VIT_HUGE.head_dim, tv.VIT_HUGE.num_patches + 1) == (80, 257)
    assert (tn.GPT_NEOX_20B.head_dim, tn.GPT_NEOX_20B.rotary_dim) == (96, 24)
    assert tn.GPT_NEOX_20B.rotary_dim == jn.GPT_NEOX_20B.rotary_dim
    assert tb.BERT_LARGE.head_dim == 64


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_entry_points_default_to_the_card():
    for family in FAMILIES:
        _, tmod, cls, fn = FAMILIES[family]
        cfg = getattr(tmod, fn)()
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tmod, cls)(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmod.init_state_dict(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            ttr.initialize_parallel_model(neuronx_distributed_config(), cfg)


def _vit_served(tcfg, sd, buckets):
    return mb.register_image_encoder(mb.ModelBuilder(), tcfg, sd, buckets,
                                     device="cpu").trace().compile()


def test_vit_served_from_buckets_like_vit_serve():
    """``examples/inference/vit_serve.py``: the classifier under buckets
    1, 4 and 8; a batch of 5 routes to bucket 8 in both packages, whose
    logits (at the bucket's batch) agree."""
    jcfg, tcfg = _configs("vit", use_flash_attention=True)
    (px,), _ = _inputs("vit")
    px = np.concatenate([px, px * 0.5, px[:1] - 1])            # 5 images
    params = _jax_params("vit", jcfg, (px[:1],))
    jmodel = jv.ViTForImageClassification(jcfg)
    shape = (3, 16, 16)
    jserved = (jmb.ModelBuilder()
               .add("image_encoder", lambda x: jmodel.apply(params, x),
                    [(jax.ShapeDtypeStruct((b,) + shape, jnp.float32),)
                     for b in (1, 4, 8)], priority_model=True)
               .trace().compile())
    ref = np.asarray(jserved.forward("image_encoder", jnp.asarray(px),
                                     pad_inputs=True))
    sd = params_from_jax(tcfg, params)
    served = _vit_served(tcfg, sd, [1, 4, 8])
    assert served.keys() == ["image_encoder"]
    art = served.router("image_encoder", (sd, torch.from_numpy(px)))
    assert art.leaves[-1].shape == (8,) + shape
    got = served.forward("image_encoder", sd, torch.from_numpy(px),
                         pad_inputs=True).numpy()
    assert got.shape == ref.shape == (8, 8)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="pad_inputs"):
        served.forward("image_encoder", sd, torch.from_numpy(px))


_ISOLATED = textwrap.dedent("""
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "ml_dtypes",
                                      "neuronx_distributed_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    import torch
    from neuronx_distributed_tpu_torch import trainer as ttr
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    from neuronx_distributed_tpu_torch.models import bert, gpt_neox, vit

    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 17)))
    px = torch.from_numpy(rng.randn(2, 3, 16, 16).astype(np.float32))
    batches = {
        gpt_neox: {"input_ids": ids[:, :-1], "labels": ids[:, 1:]},
        bert: {"input_ids": ids[:, :-1],
               "labels": torch.where(ids[:, 1:] % 3 == 0, ids[:, 1:],
                                     -100)},
        vit: {"pixel_values": px, "labels": torch.tensor([1, 5])}}
    for mod, fn in ((gpt_neox, "tiny_neox_config"),
                    (bert, "tiny_bert_config"), (vit, "tiny_vit_config")):
        cfg = getattr(mod, fn)(dtype=torch.float32, num_layers=1,
                               use_flash_attention=True)
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), cfg, device="cpu", std=0.2)
        tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-2)
        kw = {}
        if mod is vit:
            kw["loss_fn"] = lambda m, p, b: m.loss(b["pixel_values"],
                                                   b["labels"])
        step = ttr.make_train_step(pm, tx, **kw)
        losses = [step(state, batches[mod])[1]["loss"].item()
                  for _ in range(3)]
        assert losses[-1] < losses[0], (fn, losses)
        print("trained", type(pm.module).__name__, state.step)
    sd = {k: v.detach() for k, v in state.params.items()}
    served = mb.register_image_encoder(mb.ModelBuilder(), cfg, sd, [2],
                                       device="cpu").trace().compile()
    out = served.forward("image_encoder", sd, px)
    assert torch.equal(out, pm.module(px).detach())
    print("served", tuple(out.shape))
""")


def _run_isolated(code, *argv):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_families_train_and_serve_importing_nothing_of_jax():
    assert _run_isolated(_ISOLATED) == [
        "trained GPTNeoXForCausalLM 3", "trained BertForPreTraining 3",
        "trained ViTForImageClassification 3", "served (2, 8)"]


_FRESH = textwrap.dedent("""
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "ml_dtypes",
                                      "neuronx_distributed_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    m = mb.NxDModel.load(sys.argv[1], device="cpu")
    px = torch.load(sys.argv[2])
    torch.save(m.forward("image_encoder", m.params, px, pad_inputs=True),
               sys.argv[3])
    print("ok")
""")


def test_vit_bundle_serves_from_a_fresh_process(tmp_path):
    """A ViT bundle saved here and loaded in a process that refuses JAX
    gives this process's logits bit for bit; its manifest builds a
    ``ViTConfig`` and names ``image_encoder``."""
    _, tcfg = _configs("vit", use_flash_attention=True)
    sd = tv.init_state_dict(tcfg, seed=6, device="cpu")
    served = _vit_served(tcfg, sd, [1, 4])
    px = torch.from_numpy(_inputs("vit", seed=3)[0][0][:1].repeat(3, 0))
    here = served.forward("image_encoder", sd, px, pad_inputs=True)
    path, pxp, out = (str(tmp_path / n) for n in ("vit.nxd", "px.pt",
                                                   "out.pt"))
    served.save(path, params=sd)
    torch.save(px, pxp)
    assert _run_isolated(_FRESH, path, pxp, out) == ["ok"]
    assert torch.equal(torch.load(out), here)
    loaded = mb.NxDModel.load(path, device="cpu")
    art = loaded.router("image_encoder", (loaded.params, px))
    assert art.ref["function"].endswith(":image_encoder")
    assert art.ref["kwargs"]["model_cfg"]["__dataclass__"].endswith(
        ":ViTConfig")
    assert torch.equal(loaded.forward("image_encoder", loaded.params, px,
                                      pad_inputs=True), here)


@pytest.mark.parametrize("family", ["neox", "bert"])
def test_other_family_configs_cross_a_bundle_as_json(family):
    """The bundle's JSON arguments build the three new configs (and only
    the model configs: ``test_torch_model_builder.py`` holds the rest)."""
    _, tcfg = _configs(family, use_flash_attention=True)
    got = mb._from_json(mb._to_json(tcfg))
    assert got == tcfg and type(got) is type(tcfg)
    fn = functools.partial(mb.image_encoder, model_cfg=tcfg)
    assert mb.function_ref(fn)["kwargs"]["model_cfg"]["fields"][
        "dtype"] == {"__dtype__": "float32"}
