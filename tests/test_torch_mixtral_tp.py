"""Mixtral across ranks: the port's Mixtral train step on four gloo ranks
on the CPU at tp=2 x dp=2 (sequence parallelism, ZeRO-1), its experts
sharded over the intermediate width (``gate_up [E, H, 2, I/tp]``, ``down
[E, I/tp, H]``), against the JAX package's GSPMD step at the same
``tensor_parallel_size`` on a 4-device mesh, from the same weights and
global batches: blockwise dispatch (the grouped GLU, K5/K7/K8 on the
card), capacity dispatch, and DBRX's routing (top-4 of 8 fine-grained
experts). Also every synchronised gradient, the router's included,
against ``jax.grad`` of the dense loss over the global batch (JAX
``tests/test_moe.py:374``, ``:583``: a router gradient left partial over
tp fails here), the router's aux losses against the dense model's over
the global batch (the load-balance loss averages ``f`` and ``p`` over the
data ranks before their product), and the partition-spec and ZeRO-1
tables against JAX's.

Tolerances are ``tests/test_torch_train_tp.py``'s: the loss before any
update within 1e-6 relative, later losses 1e-4, grad norms 1e-3,
gradients 1e-4 x max|g|, updated parameters 1e-3 x max|p|; aux losses
within 1e-6. Capacity dispatch gets a capacity factor at which no token
drops: each data rank sizes its capacity by its own tokens, GSPMD by the
global ones, which can drop other tokens."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax.core import meta

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.trainer import optimizer as jopt
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch.config import mesh_factorization
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.trainer import optimizer as topt
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ranks

LR = 1e-3
CASES = {
    "blockwise": dict(moe_dispatch="blockwise", moe_block_size=16),
    "capacity": dict(moe_dispatch="capacity", capacity_factor=4.0),
    "dbrx_routing": dict(moe_dispatch="blockwise", moe_block_size=16,
                         num_experts=8, top_k=4),
}


def _batches(seed, n, b=4, s=16, vocab=256):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
        labels = ids[:, 1:].copy()
        labels[:b // 2, :5] = -100
        out.append({"input_ids": ids[:, :-1], "labels": labels})
    return out


def _jcfg(**kw):
    return jm.tiny_moe_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              use_flash_attention=True, **kw)


def _tcfg(**kw):
    return tm.tiny_moe_config(dtype=torch.float32, use_flash_attention=True,
                              **kw)


def _gspmd(kw, batches, tp=2):
    """JAX's GSPMD step at ``tp`` on 4 devices (sequence parallel,
    ZeRO-1): per-step loss and grad norm, the initial and final params."""
    cfg = nxd.neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=True,
        optimizer_config=nxd.OptimizerConfig(zero_one_enabled=True),
        devices=jax.devices()[:4],
        mixed_precision_config=nxd.MixedPrecisionConfig(
            compute_dtype="float32"))
    try:
        jcfg = nxd.configure_model(cfg, _jcfg(**kw))
        pm, params = jtr.initialize_parallel_model(
            cfg, jm.MixtralForCausalLM(jcfg), jax.random.key(0),
            jnp.zeros((4, 16), jnp.int32))
        init = jax.tree.map(np.array, params)
        tx, state, sh = jtr.initialize_parallel_optimizer(
            pm, params, learning_rate=LR)
        step = jtr.make_train_step(pm, tx, sh, donate=False)
        metrics = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, init, jax.tree.map(np.asarray, state.params)
    finally:
        jmesh.destroy_model_parallel()


def _dense(kw, init, batch):
    """``jax.grad`` of the dense Mixtral loss over the global batch, and
    the dense model's aux losses there."""
    model = jm.MixtralForCausalLM(_jcfg(**kw))
    params = meta.unbox(init)
    ids, labels = jnp.asarray(batch["input_ids"]), jnp.asarray(
        batch["labels"])
    g = jax.grad(lambda p: model.apply(p, ids, labels, method="loss"))(
        params)
    return jax.tree.map(np.asarray, g), np.asarray(model.apply(params,
                                                               ids)[1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    batches = _batches(4, 2)
    ref, cases = {}, []
    for name, kw in CASES.items():
        metrics, init, final = _gspmd(kw, batches)
        tcfg = _tcfg(**kw)
        grads, aux = _dense(kw, init, batches[0])
        sd = convert.params_from_jax(tcfg, init)
        ref[name] = dict(metrics=metrics, sd=sd, cfg=tcfg, aux=aux,
                         final=convert.params_from_jax(tcfg, final),
                         grads=convert.params_from_jax(tcfg, grads))
        cases.append((name, tcfg, sd))
    outs = run_ranks(torch_ranks.mixtral_world, 4, backend="gloo",
                     device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("mixtral_world")),
                     args=(cases, [{k: torch.from_numpy(v.astype(np.int64))
                                    for k, v in b.items()}
                                   for b in batches], LR), timeout=400)
    return ref, outs


def _gather(ref, outs, case, key):
    first = sorted((o[case] for o in outs if o[case]["coords"]["dp"] == 0),
                   key=lambda o: o["coords"]["tp"])
    return convert.gather_state_dict(
        dataclasses.replace(ref[case]["cfg"], tp_size=2),
        [o[key] for o in first])


@pytest.mark.parametrize("case", list(CASES))
def test_step_at_tp2_dp2_matches_jax_gspmd(world, case):
    """Every rank reports JAX's loss and grad norm at both steps; the tp
    shards gathered equal JAX's updated params, each of which moved; the
    data-parallel twins end equal; ZeRO-1 shards the moments."""
    ref, outs = world
    want = ref[case]["metrics"]
    for r, o in enumerate(outs):
        assert o["jax_modules"] == [], o["jax_modules"]
        for i, ((loss, norm), (jl_, jn)) in enumerate(zip(
                o[case]["metrics"], want)):
            np.testing.assert_allclose(loss, jl_, rtol=1e-6 if i == 0
                                       else 1e-4, err_msg=f"rank {r} {i}")
            np.testing.assert_allclose(norm, jn, rtol=1e-3,
                                       err_msg=f"rank {r} {i}")
    got = _gather(ref, outs, case, "params")
    assert set(got) == set(ref[case]["final"])
    for name, p in got.items():
        w = ref[case]["final"][name].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
        assert not torch.equal(p, ref[case]["sd"][name]), f"{name} still"
    for o in outs:
        twin = next(t for t in outs
                    if t[case]["coords"]["tp"] == o[case]["coords"]["tp"]
                    and t[case]["coords"]["dp"] == 0)
        for name, p in o[case]["params"].items():
            assert torch.equal(p, twin[case]["params"][name]), name
    shapes = [tuple(p.shape) for p in outs[0][case]["params"].values()]
    assert any(m != s for m, s in zip(outs[0][case]["moments"], shapes))


@pytest.mark.parametrize("case", list(CASES))
def test_every_synchronised_gradient_matches_jax_grad(world, case):
    """Each parameter's synchronised gradient (tp shards gathered), the
    router's and the experts' included, equals ``jax.grad`` of the dense
    loss over the global batch within 1e-4 x max|g|."""
    ref, outs = world
    got = _gather(ref, outs, case, "grads")
    want = ref[case]["grads"]
    assert set(got) == set(want)
    assert any("router" in n for n in got)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert not any("router" in n for n in outs[0][case]["sp_names"])


@pytest.mark.parametrize("case", list(CASES))
def test_aux_losses_across_data_ranks_match_jax(world, case):
    """The load-balance loss every rank computes from its rows equals the
    dense model's over the global batch within 1e-6 (the load-balance
    loss of a rank's own rows would not); the z-loss, a plain mean over
    tokens, is each rank's local mean, and their mean over the data ranks
    (what the step's loss averages) equals the dense model's."""
    ref, outs = world
    want = ref[case]["aux"]
    for o in outs:
        np.testing.assert_allclose(float(o[case]["aux"][0]), want[0],
                                   rtol=1e-6)
    z = {o[case]["coords"]["dp"]: float(o[case]["aux"][1]) for o in outs}
    assert len(set(z.values())) == 2
    np.testing.assert_allclose(np.mean(list(z.values())), want[1],
                               rtol=1e-6)


def _jax_specs_by_port_name(tp, **kw):
    """JAX's ``nn.get_partition_spec`` of an unscanned tiny Mixtral,
    keyed by the port's names."""
    cfg = jm.tiny_moe_config(scan_layers=False, tp_size=tp, **kw)
    boxed = jax.eval_shape(lambda: jm.MixtralForCausalLM(cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    specs = nn.get_partition_spec(boxed)["params"]
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = ".".join(path + (k,))
                out[name.replace("model.", "").replace(
                    "layer_", "layers.")] = v
    walk(specs, ())
    return out, boxed


@pytest.mark.parametrize("tp,kw", [
    (2, {}), (4, {}), (2, dict(shared_expert_intermediate=64)),
    (4, dict(num_experts=8, top_k=4))])
def test_partition_spec_table_matches_jax(tp, kw):
    """``param_specs`` of a Mixtral equals JAX's partition specs of the
    same model (the expert bank's ep dim whole at ep=1)."""
    jspecs, _ = _jax_specs_by_port_name(tp, **kw)
    got = convert.param_specs(tm.tiny_moe_config(tp_size=tp, **kw))
    assert set(got) == set(jspecs)
    for name, spec in got.items():
        want = tuple(a if a != "ep" else None for a in jspecs[name])
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (name, spec, want)


def test_zero1_dims_match_jax_zero1_state_specs():
    """The dims ZeRO-1 shards Mixtral's moments along at tp=2 x dp=2
    equal JAX's ``zero1_state_specs`` on the 4-device mesh. JAX names the
    expert bank's data axis ``dp_exp`` (the expert view's); at ep=1 it
    spans the same ranks as the merged ``("dp", "cp")``."""
    tp = 2
    _, boxed = _jax_specs_by_port_name(tp)
    nxd.neuronx_distributed_config(tensor_parallel_size=tp,
                                   devices=jax.devices()[:4])
    try:
        shapes = jax.tree.map(lambda a: tuple(a.shape), meta.unbox(boxed))
        pspecs = nn.get_partition_spec(boxed)
        ext = jopt.zero1_state_specs({"mu": pspecs}, pspecs, shapes)["mu"]
    finally:
        jmesh.destroy_model_parallel()
    flat = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = ".".join(path + (k,))
                flat[name.replace("params.", "", 1).replace(
                    "model.", "").replace("layer_", "layers.")] = v
    walk(ext, ())
    full = {n: tuple(t.shape) for n, t in tm.MixtralForCausalLM(
        tm.tiny_moe_config(), device="meta").state_dict().items()}
    got = topt.zero1_state_specs(
        convert.param_specs(tm.tiny_moe_config(tp_size=tp)), full,
        mesh_factorization(4, tp))
    assert set(got) == set(flat)
    for name, spec in got.items():
        want = tuple(None if a == "ep" else ("dp", "cp") if a == "dp_exp"
                     else a for a in flat[name])
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (name, spec, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_round_trip_and_params_from_jax_by_coords(tp):
    """Each rank's Mixtral shards have the local model's shapes (experts
    at I/tp); gathering them gives the whole dict back bit for bit;
    ``params_from_jax`` with a rank's coords gives the same shards."""
    jcfg = jm.tiny_moe_config(param_dtype=jnp.float32,
                              shared_expert_intermediate=64)
    params = jax.tree.map(np.asarray, meta.unbox(jm.MixtralForCausalLM(
        jcfg).init(jax.random.key(2), jnp.zeros((1, 8), jnp.int32))))
    tcfg = tm.tiny_moe_config(tp_size=tp, shared_expert_intermediate=64)
    whole = convert.params_from_jax(
        tm.tiny_moe_config(shared_expert_intermediate=64), params)
    shards = [convert.shard_state_dict(tcfg, whole, {"tp": r})
              for r in range(tp)]
    local = tm.MixtralForCausalLM(tcfg, device="meta").state_dict()
    assert local["layers.0.moe.experts.gate_up"].shape[-1] == 128 // tp
    for r, shard in enumerate(shards):
        assert {k: v.shape for k, v in shard.items()} == {
            k: v.shape for k, v in local.items()}
        by_coords = convert.params_from_jax(tcfg, params, {"tp": r})
        assert all(torch.equal(by_coords[k], v) for k, v in shard.items())
    back = convert.gather_state_dict(tcfg, shards)
    assert all(torch.equal(back[k], v) for k, v in whole.items())
