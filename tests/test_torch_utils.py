"""The port's ``utils/batch_utils.py``, ``tensor_capture.py`` and
``timeline.py`` against the JAX package's: shifted labels and the
context-parallel slices bit for bit, captured intermediates, replacements
and ``max_diff`` on a tiny Llama crossed by ``params_from_jax``, and the
events ``Timeline.save`` writes."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.utils import batch_utils as jbu
from neuronx_distributed_tpu.utils import tensor_capture as jtc
from neuronx_distributed_tpu.utils import timeline as jtl
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.utils import batch_utils as tbu
from neuronx_distributed_tpu_torch.utils import tensor_capture as ttc
from neuronx_distributed_tpu_torch.utils import timeline as ttl


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ignore", [-100, 0])
def test_shift_labels_matches_jax(dtype, ignore):
    labels = np.random.RandomState(0).randint(0, 500, (3, 11)).astype(dtype)
    want = jbu.shift_labels(labels, ignore_index=ignore)
    got = tbu.shift_labels(torch.from_numpy(labels), ignore_index=ignore)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(tbu.shift_labels(labels, ignore).numpy(),
                                  want)


@pytest.mark.parametrize("cp_size", [1, 2, 4])
def test_context_parallel_slices_match_jax(cp_size):
    rng = np.random.RandomState(1)
    batch = {"input_ids": rng.randint(0, 99, (2, 16)),
             "labels": rng.randint(0, 99, (2, 16)),
             "mask": rng.rand(2, 16, 3).astype(np.float32),
             "lengths": np.array([16, 9])}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for rank in range(cp_size):
        want = jbu.get_batch_on_this_context_parallel_rank(batch, rank,
                                                           cp_size)
        got = tbu.get_batch_on_this_context_parallel_rank(tbatch, rank,
                                                          cp_size)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(torch.as_tensor(got[k]).numpy(),
                                          np.asarray(want[k]))
    with pytest.raises(ValueError, match="not divisible by cp_size 3"):
        jbu.get_batch_on_this_context_parallel_rank(batch, 0, 3)
    with pytest.raises(ValueError, match="not divisible by cp_size 3"):
        tbu.get_batch_on_this_context_parallel_rank(tbatch, 0, 3)


@pytest.fixture(scope="module")
def llama():
    """A tiny fp32 Llama in both packages on JAX's weights."""
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          num_layers=2)
    ps.initialize_model_parallel()
    try:
        params = jax.tree.map(np.array, meta.unbox(jl.LlamaForCausalLM(
            jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    model = tl.build_model(tcfg, params_from_jax(tcfg, params), "cpu")
    ids = np.random.RandomState(2).randint(0, 256, (2, 8)).astype(np.int32)
    return jcfg, params, model, ids


# the submodules whose outputs both packages capture: JAX path, port path
MATCHING = {("model", "embed"): "embed", ("model", "norm"): "norm",
            ("lm_head",): "lm_head", (): ""}


def _jax_capture(jcfg, params, ids, **kw):
    ps.initialize_model_parallel()
    try:
        return jtc.capture_intermediates(jl.LlamaForCausalLM(jcfg), params,
                                         jnp.asarray(ids), **kw)
    finally:
        ps.destroy_model_parallel()


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree["__call__"]


def test_capture_intermediates_matches_jax(llama):
    jcfg, params, model, ids = llama
    jout, jcap = _jax_capture(jcfg, params, ids)
    with torch.no_grad():
        out, cap = ttc.capture_intermediates(model, torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    for jpath, tpath in MATCHING.items():
        want = _at(jcap, jpath)
        assert len(cap[tpath]) == len(want) == 1
        np.testing.assert_allclose(cap[tpath][0].numpy(),
                                   np.asarray(want[0]), rtol=0, atol=1e-5,
                                   err_msg=tpath)
    assert {"layers.0.attn.qkv", "layers.1.mlp.down"} <= set(cap)
    # a filter keeps only what it accepts, in both
    _, jf = _jax_capture(jcfg, params, ids,
                         filter_fn=lambda mdl, name: mdl.name == "norm")
    with torch.no_grad():
        _, tf = ttc.capture_intermediates(
            model, torch.from_numpy(ids),
            filter_fn=lambda mod, path: path == "norm")
    assert list(tf) == ["norm"] and list(jf) == ["model"]
    assert list(jf["model"]) == ["norm"]
    # the hooks are gone afterwards
    assert all(not m._forward_hooks for m in model.modules())


def test_apply_with_replacements_and_max_diff_match_jax(llama):
    jcfg, params, model, ids = llama
    scale = np.linspace(0.5, 2.0, jcfg.hidden_size).astype(np.float32)
    ps.initialize_model_parallel()
    try:
        jmodel = jl.LlamaForCausalLM(jcfg)
        jref = jmodel.apply(params, jnp.asarray(ids))
        jrep = jtc.apply_with_replacements(
            jmodel, params, {"params/model/norm/scale": jnp.asarray(scale)},
            jnp.asarray(ids))
        with pytest.raises(KeyError, match="not found"):
            jtc.apply_with_replacements(jmodel, params, {"params/nope": 1},
                                        jnp.asarray(ids))
        jdiff = jtc.max_diff({"logits": jrep, "same": jref},
                             {"logits": jref, "same": jref})
    finally:
        ps.destroy_model_parallel()
    x = torch.from_numpy(ids)
    with torch.no_grad():
        ref = model(x)
        rep = ttc.apply_with_replacements(
            model, {"norm.scale": torch.from_numpy(scale)}, x)
        assert torch.equal(model(x), ref)        # the model is unchanged
    np.testing.assert_allclose(rep.numpy(), np.asarray(jrep), rtol=0,
                               atol=1e-5)
    with pytest.raises(KeyError, match="not found"):
        ttc.apply_with_replacements(model, {"nope": torch.ones(1)}, x)
    diff = ttc.max_diff({"logits": rep, "same": ref},
                        {"logits": ref, "same": ref})
    assert diff["['logits']"] == pytest.approx(jdiff["['logits']"],
                                               rel=1e-4)
    assert diff["['same']"] == jdiff["['same']"] == 0.0
    missing = ttc.max_diff({"a": ref, "b": ref}, {"a": ref})
    assert missing["['a']"] == 0.0 and np.isnan(missing["['b']"])


def _drive(timeline_mod, path):
    tl_ = timeline_mod.Timeline(str(path))
    tl_.mark_event_start("load")
    tl_.mark_event_end("load")
    with tl_.event("step"):
        pass
    tl_.mark_event_end("never_started")
    tl_.mark_event_start("open")
    off = timeline_mod.Timeline(str(path) + ".off", enabled=False)
    off.mark_event_start("x")
    off.mark_event_end("x")
    assert not off.enabled
    off.save()
    tl_.save()
    events = json.load(open(path))["traceEvents"]
    return ([(e["name"], e["ph"], e.get("args", {}).get("incomplete", False))
             for e in events],
            json.load(open(str(path) + ".off"))["traceEvents"])


def test_timeline_events_match_jax(tmp_path):
    want = _drive(jtl, tmp_path / "jax.json")
    got = _drive(ttl, tmp_path / "port.json")
    assert got == want
    assert got[0] == [("load", "X", False), ("step", "X", False),
                      ("open", "X", True)]


def test_profile_step_writes_a_trace(tmp_path):
    from neuronx_distributed_tpu_torch import obs

    obs.enable()
    try:
        with ttl.profile_step(str(tmp_path)) as d:
            torch.ones(4).add_(1)
        assert d == str(tmp_path)
        stats = obs.get_tracer().stats()
    finally:
        obs.disable()
    assert stats["profile_step"]["count"] >= 1
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
