"""JAX references of the port's Mixtral train-step tests at tp x ep, and
the world they are held against: four gloo ranks on the CPU run the port's
step at each layout (``tests/torch_ep_ranks.py``) while the JAX package's
GSPMD step runs at the same sizes on 4 devices of the conftest's virtual
CPU mesh, from the same numpy-seeded weights and batches. Imported by the
test processes only (the ranks import ``tests/torch_ep_ranks.py``).

The checks use ``tests/test_torch_mixtral_tp.py``'s tolerances: the loss
before any update within 1e-6 relative, later losses 1e-4, grad norms
1e-3, updated parameters 1e-3 x max|p|; every synchronised gradient
against ``jax.grad`` of the dense loss within 1e-4 x max|g| (an expert
gradient averaged over ``dp_exp`` alone would be ep times too large).
Capacity dispatch gets a capacity factor at which no token drops: each
data rank sizes its capacity by its own tokens, GSPMD by the global
ones."""

import concurrent.futures
import dataclasses
import threading

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ep_ranks

LR = 1e-3
DISPATCH = {
    "blockwise": dict(moe_dispatch="blockwise", moe_block_size=16),
    "capacity": dict(moe_dispatch="capacity", capacity_factor=4.0),
}


def steps(layouts):
    """``(name, dispatch, layout)`` for each layout and dispatch mode."""
    return [(f"{d}_{lay}", d, lay) for lay in layouts for d in DISPATCH]


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


def _gspmd_case(cfg, kw, init, batches):
    jcfg = nxd.configure_model(cfg, _jcfg(**kw))
    pm, params = jtr.initialize_parallel_model(
        cfg, jm.MixtralForCausalLM(jcfg), jax.random.key(0),
        jnp.zeros((4, 16), jnp.int32))
    params = jax.tree.map(lambda p, v: jax.device_put(v, p.sharding),
                          params, init)
    tx, state, sh = jtr.initialize_parallel_optimizer(pm, params,
                                                      learning_rate=LR)
    step = jtr.make_train_step(pm, tx, sh, donate=False)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree.map(np.asarray, state.params)


def _gspmd(tp, ep, init, batches):
    """JAX's GSPMD step at tp x ep on 4 devices (sequence parallel at tp >
    1, ZeRO-1) from the weights ``init``, for each dispatch mode (the two
    compile on threads of their own): per-step loss and grad norm, the
    final params."""
    cfg = nxd.neuronx_distributed_config(
        tensor_parallel_size=tp, expert_parallel_size=ep,
        sequence_parallel=tp > 1,
        optimizer_config=nxd.OptimizerConfig(zero_one_enabled=True),
        devices=jax.devices()[:4],
        mixed_precision_config=nxd.MixedPrecisionConfig(
            compute_dtype="float32"))
    try:
        with concurrent.futures.ThreadPoolExecutor(len(DISPATCH)) as pool:
            futures = {d: pool.submit(_gspmd_case, cfg, kw, init, batches)
                       for d, kw in DISPATCH.items()}
            return {d: f.result() for d, f in futures.items()}
    finally:
        jmesh.destroy_model_parallel()


def _dense_grads(kw, init, batch):
    model = jm.MixtralForCausalLM(_jcfg(**kw))
    params = meta.unbox(init)
    ids, labels = (jnp.asarray(batch[k]) for k in ("input_ids", "labels"))
    g = jax.jit(jax.grad(lambda p: model.apply(p, ids, labels,
                                               method="loss")))(params)
    return jax.tree.map(np.asarray, g)


def step_world(layouts, store_dir):
    """Each layout's port step on four gloo ranks (on a thread) beside its
    JAX references: ``{"ref": {"steps": {name: {"metrics", "final"}},
    "grads": {dispatch: ...}}, "outs": per-rank results, "sd": the whole
    initial weights, "layouts": layouts}``."""
    batches = _batches(4, 2)
    init = jax.tree.map(np.asarray, meta.unbox(jax.jit(
        jm.MixtralForCausalLM(_jcfg()).init)(
            jax.random.key(0), jnp.zeros((4, 16), jnp.int32))))
    sd = convert.params_from_jax(_tcfg(), init)
    tbatches = [{k: torch.from_numpy(v.astype(np.int64))
                 for k, v in b.items()} for b in batches]
    args = ([(name, _tcfg(**DISPATCH[d]), sd, tbatches, *layouts[lay])
             for name, d, lay in steps(layouts)], LR)
    box = {}

    def ranks():
        try:
            box["outs"] = run_ranks(
                torch_ep_ranks.mixtral_ep_steps_world, 4, backend="gloo",
                device="cpu", store_dir=store_dir, args=args, timeout=400)
        except BaseException as e:   # re-raised in the test process
            box["error"] = e
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ref = {"steps": {}, "grads": {}}
        for d, kw in DISPATCH.items():
            ref["grads"][d] = convert.params_from_jax(
                _tcfg(**kw), _dense_grads(kw, init, batches[0]))
        for lay, (tp, ep) in layouts.items():
            for d, (metrics, final) in _gspmd(tp, ep, init,
                                              batches).items():
                ref["steps"][f"{d}_{lay}"] = dict(
                    metrics=metrics,
                    final=convert.params_from_jax(_tcfg(), final))
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return dict(ref=ref, outs=box["outs"], sd=sd, layouts=layouts)


def _whole(outs, name, key):
    """The whole tensors of ``key`` from the ranks at dp_exp 0, ep major,
    tp minor."""
    first = sorted((o[name] for o in outs if o[name]["coords"]["dp_exp"]
                    == 0), key=lambda o: (o["coords"]["ep"],
                                          o["coords"]["tp"]))
    cfg = dataclasses.replace(first[0]["local_cfg"], sequence_parallel=False)
    return convert.gather_state_dict(cfg, [o[key] for o in first])


def assert_ranks_import_no_jax(world):
    for o in world["outs"]:
        assert o["jax_modules"] == [], o["jax_modules"]


def assert_step_matches(world, name, layout):
    """Every rank reports JAX's loss and grad norm at both steps; the
    ranks' shards gathered equal JAX's updated params, each of which
    moved; the expert banks are ``[E/ep, H, 2, I/tp]``; ranks that hold
    the same shards end equal."""
    tp, ep = world["layouts"][layout]
    ref = world["ref"]["steps"][name]
    outs = world["outs"]
    for r, o in enumerate(outs):
        for i, ((loss, norm), (jl, jn)) in enumerate(zip(
                o[name]["metrics"], ref["metrics"])):
            np.testing.assert_allclose(loss, jl, rtol=1e-6 if i == 0
                                       else 1e-4, err_msg=f"rank {r} {i}")
            np.testing.assert_allclose(norm, jn, rtol=1e-3,
                                       err_msg=f"rank {r} {i}")
        gu = o[name]["params"]["layers.0.moe.experts.gate_up"]
        assert tuple(gu.shape) == (4 // ep, 64, 2, 128 // tp)
        assert o[name]["local_cfg"].ep_size == ep
    got = _whole(outs, name, "params")
    assert set(got) == set(ref["final"])
    for pname, p in got.items():
        w = ref["final"][pname].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(),
                                   err_msg=pname)
        assert not torch.equal(p, world["sd"][pname]), f"{pname} still"
    for o in outs:
        c = o[name]["coords"]
        twin = next(t for t in outs if t[name]["coords"]["tp"] == c["tp"]
                    and t[name]["coords"]["ep"] == c["ep"]
                    and t[name]["coords"]["dp_exp"] == 0)
        for pname, p in o[name]["params"].items():
            if "experts" in pname or ep == 1:
                assert torch.equal(p, twin[name]["params"][pname]), pname


def assert_grads_match(world, name, dispatch):
    """Each synchronised gradient (shards gathered), the experts' and the
    router's included, equals ``jax.grad`` of the dense loss over the
    global batch within 1e-4 x max|g|."""
    got = _whole(world["outs"], name, "grads")
    want = world["ref"]["grads"][dispatch]
    assert set(got) == set(want)
    for pname, g in got.items():
        w = want[pname].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=pname)
