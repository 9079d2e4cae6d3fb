"""Expert parallelism in the port: the expert bank, the Sinkhorn router and
token shuffling across ranks, on four gloo ranks on the CPU (one world,
each part at its own layout), against the JAX package on a 4-device mesh
from the same numpy-seeded inputs and weights (the Mixtral train step at
tp x ep is ``tests/test_torch_mixtral_ep_step.py``):

* ``ExpertMLPs`` capacity dispatch at ep=4 against JAX's bank under a
  bound-ep ``shard_map`` (JAX ``tests/test_moe.py:99``: 2e-4), and
  blockwise dispatch at (tp, ep) = (1, 4) and (2, 2), forward and the
  parameters', tokens' and gates' gradients (JAX ``test_moe.py:736``:
  5e-4); the local banks are ``[E/ep, H, 2, I/tp]`` / ``[E/ep, I/tp, H]``;
* the partition-spec table (``("ep", None, None, "tp")``) and the ZeRO-1
  table (the expert moments over ``dp_exp``) against JAX's;
* the Sinkhorn router across four data ranks: each rank's choices equal
  JAX's GSPMD router over the global tokens;
* ``token_shuffle`` / ``token_unshuffle`` over dp_exp=2: the exchange is
  the tiled all-to-all of each shard's permuted tokens, the round trip is
  bit for bit, a step replays, and the shards' permutations differ;
* what stays out at ep > 1 raises.

The world runs on a thread beside the JAX references."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax.core import meta
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.modules.moe import routing as jrouting
from neuronx_distributed_tpu.modules.moe.expert_mlps import \
    ExpertMLPs as JExpertMLPs
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.trainer import optimizer as jopt
from neuronx_distributed_tpu_torch.config import mesh_factorization
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.modules.moe import MoE
from neuronx_distributed_tpu_torch.trainer import optimizer as topt
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ep_ranks

BANKS = [("bank_capacity_tp1_ep4", "capacity", 1, 4),
         ("bank_blockwise_tp1_ep4", "blockwise", 1, 4),
         ("bank_blockwise_tp2_ep2", "blockwise", 2, 2)]



def _bank_inputs(kind):
    """JAX's ``test_moe.py`` problems, from numpy: 32 tokens of width 16,
    4 experts of width 32, top-2."""
    rng = np.random.RandomState(11 if kind == "capacity" else 12)
    x = rng.randn(32, 16).astype(np.float32)
    gates = (np.full((32, 2), 0.5, np.float32) if kind == "capacity"
             else rng.rand(32, 2).astype(np.float32))
    idx = rng.randint(0, 4, (32, 2)).astype(np.int32)
    gate_up = (rng.randn(4, 16, 2, 32) * 0.3).astype(np.float32)
    down = (rng.randn(4, 32, 16) * 0.3).astype(np.float32)
    kw = (dict(capacity_factor=4.0) if kind == "capacity" else
          dict(dispatch_mode="blockwise", block_size=16, block_i=16))
    return kw, gate_up, down, x, gates, idx


def _jax_bank(kind, tp, ep, gate_up, down, x, gates, idx):
    """The JAX bank under ``shard_map`` on the expert mesh at tp x ep:
    output and the gradients of each rank's ``sum(y**2)``."""
    nxd.neuronx_distributed_config(tensor_parallel_size=tp,
                                   expert_parallel_size=ep,
                                   devices=jax.devices()[:4])
    try:
        em = jmesh.get_expert_mesh()
        kw = (dict(capacity_factor=4.0) if kind == "capacity" else
              dict(dispatch_mode="blockwise", block_size=16, block_i=16))
        m = JExpertMLPs(num_experts=4, hidden_size=16, intermediate_size=32,
                        top_k=2, dtype=jnp.float32, **kw)
        params = {"params": {"gate_up": jnp.asarray(gate_up),
                             "down": jnp.asarray(down)}}
        pspec = {"params": {"gate_up": P("ep", None, None, "tp"),
                            "down": P("ep", "tp", None)}}
        specs = (pspec, P("ep", None), P("ep", None), P("ep", None))

        def grads(p, a, g, i):
            return jax.grad(lambda p, a, g: jnp.sum(
                m.apply(p, a, g, i)[0] ** 2), argnums=(0, 1, 2))(p, a, g)
        args = (params, jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx))
        y = jax.jit(jmesh.shard_map(
            lambda p, a, g, i: m.apply(p, a, g, i)[0], em, in_specs=specs,
            out_specs=P("ep", None)))(*args)
        g = jax.jit(jmesh.shard_map(
            grads, em, in_specs=specs,
            out_specs=(pspec, P("ep", None), P("ep", None))))(*args)
        return dict(y=np.asarray(y),
                    gate_up=np.asarray(g[0]["params"]["gate_up"]),
                    down=np.asarray(g[0]["params"]["down"]),
                    x=np.asarray(g[1]), gates=np.asarray(g[2]))
    finally:
        jmesh.destroy_model_parallel()


def _jax_sinkhorn(kernel, x):
    """JAX's Sinkhorn router over the global tokens, its input sharded
    over the data axis of the 4-device mesh (the GSPMD step's view)."""
    nxd.neuronx_distributed_config(devices=jax.devices()[:4])
    try:
        xs = jax.device_put(jnp.asarray(x),
                            NamedSharding(jmesh.get_mesh(), P("dp", None)))
        router = jrouting.RouterSinkhorn(num_experts=kernel.shape[1],
                                         dtype=jnp.float32)
        gates, idx, _ = jax.jit(router.apply)(
            {"params": {"kernel": jnp.asarray(kernel)}}, xs)
        return np.asarray(gates), np.asarray(idx)
    finally:
        jmesh.destroy_model_parallel()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    banks = {}
    for name, kind, tp, ep in BANKS:
        kw, *arrays = _bank_inputs(kind)
        kw = dict(kw, num_experts=4, hidden=16, intermediate=32)
        banks[name] = (kind, tp, ep, kw, arrays)
    rng = np.random.RandomState(5)
    sinkhorn = (rng.randn(16, 8).astype(np.float32),
                rng.randn(64, 16).astype(np.float32))
    shuffle = rng.randn(32, 8).astype(np.float32)
    args = ([(name, kw, tp, ep, *arrays, "sq")
             for name, (kind, tp, ep, kw, arrays) in banks.items()],
            sinkhorn, shuffle)
    box = {}

    def ranks():
        try:
            box["outs"] = run_ranks(
                torch_ep_ranks.mixtral_ep_world, 4, backend="gloo",
                device="cpu",
                store_dir=str(tmp_path_factory.mktemp("mixtral_ep")),
                args=args, timeout=400)
        except BaseException as e:   # re-raised in the test process
            box["error"] = e
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ref = {"banks": {}}
        for name, (kind, tp, ep, kw, arrays) in banks.items():
            ref["banks"][name] = _jax_bank(kind, tp, ep, *arrays)
        ref["sinkhorn"] = _jax_sinkhorn(*sinkhorn)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return dict(ref=ref, outs=box["outs"], banks=banks, sinkhorn=sinkhorn,
                shuffle=shuffle)


def test_ranks_import_no_jax(world):
    for o in world["outs"]:
        assert o["jax_modules"] == [], o["jax_modules"]


@pytest.mark.parametrize("name,kind,tp,ep", BANKS)
def test_expert_bank_matches_jax_bound_ep(world, name, kind, tp, ep):
    """Output and every gradient of each rank's bank (its experts at its
    width, its ep rank's tokens) against JAX's ``shard_map``: 2e-4 for
    capacity, 5e-4 for blockwise; capacity 4 drops nothing."""
    ref = world["ref"]["banks"][name]
    tol = 2e-4 if kind == "capacity" else 5e-4
    sizes = {"tp": tp, "ep": ep}
    for o in world["outs"]:
        got, c = o[name], o[name]["coords"]
        coords = {"tp": c["tp"], "ep": c["ep"]}
        rows = slice(c["ep"] * (32 // ep), (c["ep"] + 1) * (32 // ep))
        assert got["gate_up"].shape == (4 // ep, 16, 2, 32 // tp)
        assert got["down"].shape == (4 // ep, 32 // tp, 16)
        assert got["dropped"] == 0.0
        for key in ("y", "x", "gates"):
            np.testing.assert_allclose(got[key].numpy(), ref[key][rows],
                                       rtol=tol, atol=tol, err_msg=key)
        for key, spec in (("gate_up", ("ep", None, None, "tp")),
                          ("down", ("ep", "tp", None))):
            want = convert.shard_tensor(key, torch.from_numpy(ref[key]),
                                        spec, sizes, coords)
            np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                       rtol=tol, atol=tol, err_msg=key)


def _jax_specs(tp, **kw):
    cfg = jm.tiny_moe_config(scan_layers=False, tp_size=tp, **kw)
    boxed = jax.eval_shape(lambda: jm.MixtralForCausalLM(cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    return nn.get_partition_spec(boxed), boxed


def _by_port_name(tree, drop=""):
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = ".".join(path + (k,))
                if drop:
                    name = name.replace(drop, "", 1)
                out[name.replace("model.", "").replace(
                    "layer_", "layers.")] = v
    walk(tree, ())
    return out


@pytest.mark.parametrize("tp,ep", [(2, 2), (1, 4), (1, 2)])
def test_partition_spec_and_zero1_tables_match_jax(tp, ep):
    """``param_specs`` at ep > 1 is JAX's spec table itself (the expert
    banks ``("ep", None, None, "tp")`` / ``("ep", "tp", None)``); the
    ZeRO-1 table on 4 ranks equals JAX's ``zero1_state_specs``, the expert
    moments over ``dp_exp`` where it holds more than one rank."""
    pspecs, boxed = _jax_specs(tp)
    jspecs = _by_port_name(pspecs["params"])
    tcfg = tm.tiny_moe_config(tp_size=tp, ep_size=ep)
    got = convert.param_specs(tcfg)
    assert set(got) == set(jspecs)
    for name, spec in got.items():
        want = tuple(jspecs[name]) + (None,) * (len(spec)
                                                 - len(jspecs[name]))
        assert spec == want, (name, spec, want)
    nxd.neuronx_distributed_config(tensor_parallel_size=tp,
                                   expert_parallel_size=ep,
                                   devices=jax.devices()[:4])
    try:
        shapes = jax.tree.map(lambda a: tuple(a.shape), meta.unbox(boxed))
        ext = jopt.zero1_state_specs({"mu": pspecs}, pspecs, shapes)["mu"]
    finally:
        jmesh.destroy_model_parallel()
    flat = _by_port_name(ext, drop="params.")
    full = {n: tuple(t.shape) for n, t in tm.MixtralForCausalLM(
        tm.tiny_moe_config(), device="meta").state_dict().items()}
    zero = topt.zero1_state_specs(
        got, full, mesh_factorization(4, tp, expert_parallel_size=ep))
    assert set(zero) == set(flat)
    for name, spec in zero.items():
        want = tuple(("dp", "cp") if a == ("dp", "cp") else a
                     for a in flat[name])
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (name, spec, want)
    experts = [s for n, s in zero.items() if "experts" in n]
    assert all(("dp_exp" in s) == (4 // tp // ep > 1) for s in experts)


def test_sinkhorn_across_data_ranks_matches_jax_gspmd(world):
    """Each data rank's choices over its rows equal JAX's over the global
    tokens (the normalising sums cross the ranks), gates within 1e-6."""
    gates, idx = world["ref"]["sinkhorn"]
    per = idx.shape[0] // 4
    for o in world["outs"]:
        s = o["sinkhorn"]
        d = s["coords"]["dp"]
        np.testing.assert_array_equal(s["idx"].numpy(),
                                      idx[d * per:(d + 1) * per])
        np.testing.assert_allclose(s["gates"].numpy(),
                                   gates[d * per:(d + 1) * per], atol=1e-6)
    # a rank's own rows normalised alone would choose otherwise
    kernel, x = world["sinkhorn"]
    local = jrouting.RouterSinkhorn(num_experts=8, dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x[:per]))[1]
    assert not np.array_equal(np.asarray(local), idx[:per])


def test_token_shuffle_over_dp_exp(world):
    """At tp=1 x dp=4 x ep=2 (dp_exp=2): each rank's shuffled rows are the
    tiled all-to-all over its dp_exp group of the shards' permuted rows
    (JAX ``comm.all_to_all(split_dim=0, concat_dim=0)``); unshuffle gives
    the rows back bit for bit; the step replays; the two shards of a group
    permute differently."""
    outs = [o["shuffle"] for o in world["outs"]]
    for o in outs:
        group = sorted((p for p in outs
                        if p["coords"]["ep"] == o["coords"]["ep"]),
                       key=lambda p: p["coords"]["dp_exp"])
        me = o["coords"]["dp_exp"]
        n = o["x"].shape[0] // 2
        want = torch.cat([p["x"][p["perm"]][me * n:(me + 1) * n]
                          for p in group])
        assert torch.equal(o["shuffled"], want)
        assert torch.equal(o["back"], o["x"])
        assert o["replay"]
        assert not torch.equal(group[0]["perm"], group[1]["perm"])


def test_what_stays_out_at_ep_raises():
    """A quantized expert bank at ep > 1 (not sharded by the port, as at
    tp > 1), serving at ep > 1, a bank whose ep_size the layout does not
    have, and a config's ep_size that does not divide its experts."""
    with pytest.raises(ValueError, match="not sharded by the port"):
        MoE(4, 16, 32, expert_impl="int8", ep_size=2, device="meta")
    with pytest.raises(ValueError, match="later slice"):
        tm.build_model(tm.tiny_moe_config(ep_size=2), {}, "cpu")
    with pytest.raises(ValueError, match="not divisible by ep_size"):
        tm.tiny_moe_config(ep_size=3)
    bank = MoE(4, 16, 32, dispatch_mode="blockwise", block_size=8,
               ep_size=2, dtype=torch.float32, device="cpu").experts
    with pytest.raises(ValueError, match="expert-parallel size 1"):
        bank(torch.zeros(4, 16), torch.ones(4, 2), torch.zeros(
            4, 2, dtype=torch.int32))
