"""The port's parallel substrate against the JAX package: the rank
layout's replica groups and ``mesh_factorization`` (exactly), and on gloo
ranks on the CPU the layout's getters, every collective of
``parallel/comm.py``, the per-rank generators, head padding, distributed
argmax / top-k and the dp fingerprint matrix. The ranks run
``tests/torch_ranks.py`` (no JAX) through ``utils.cpu_mesh.run_ranks``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuronx_distributed_tpu import config as jconfig
from neuronx_distributed_tpu.ops import operators as jops
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.parallel import pad as jpad
from neuronx_distributed_tpu_torch import config as tconfig
from neuronx_distributed_tpu_torch.parallel import mesh as tmesh
from neuronx_distributed_tpu_torch.parallel import pad as tpad
from neuronx_distributed_tpu_torch.resilience import integrity as tint
from neuronx_distributed_tpu_torch.utils.cpu_mesh import RankError, run_ranks

import torch_ranks

LAYOUTS = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 4), (4, 1),
           (4, 2), (8, 1)]


@pytest.mark.parametrize("tp,ep", LAYOUTS)
def test_replica_groups_equal_jax_on_eight_devices(tp, ep):
    """Every axis's rank lists (tp, dp, pp, cp, the expert view's ep and
    dp_exp, ZeRO-1's merged dp x cp) equal the JAX mesh's device-id lists
    on the 8-device CPU mesh, exactly."""
    jmesh.initialize_model_parallel(tensor_model_parallel_size=tp,
                                    expert_model_parallel_size=ep,
                                    devices=jax.devices()[:8])
    try:
        want = {"tp": jmesh.get_tensor_model_parallel_replica_groups(),
                "dp": jmesh.get_data_parallel_replica_groups(),
                "pp": jmesh.get_pipeline_model_parallel_replica_groups(),
                "cp": jmesh.get_context_parallel_replica_groups(),
                "ep": jmesh.get_expert_model_parallel_replica_groups(),
                "dp_exp": jmesh.get_expert_data_parallel_replica_groups(),
                "zero1": jmesh.get_zero1_sharding_replica_groups()}
    finally:
        jmesh.destroy_model_parallel()
    got = tmesh.replica_groups(tconfig.mesh_factorization(
        8, tensor_parallel_size=tp, expert_parallel_size=ep))
    assert got == want


FACTORIZATIONS = [
    (8, dict(tensor_parallel_size=2)),
    (8, dict(tensor_parallel_size=2, pipeline_parallel_size=2,
             context_parallel_size=2)),
    (8, dict(tensor_parallel_size=4, expert_parallel_size=2)),
    (16, dict(tensor_parallel_size=2, dcn_data_parallel_size=2)),
    (8, dict(tensor_parallel_size=3)),
    (8, dict(tensor_parallel_size=2, data_parallel_size=2)),
    (8, dict(tensor_parallel_size=2, expert_parallel_size=3)),
    (8, dict(tensor_parallel_size=4, dcn_data_parallel_size=4)),
]


@pytest.mark.parametrize("world,kw", FACTORIZATIONS)
def test_mesh_factorization_matches_jax(world, kw):
    """The same sizes, or the same message."""
    def outcome(fn):
        try:
            return fn(world, **kw)
        except ValueError as e:
            return str(e)

    assert outcome(tconfig.mesh_factorization) == outcome(
        jconfig.mesh_factorization)


def test_one_process_layout_and_refusals():
    """Without a process group the world is this process: every size is
    1, every collective the identity, and a tp degree above 1 raises."""
    tmesh.destroy_model_parallel()
    tconfig.neuronx_distributed_config()
    assert tmesh.get_world_size() == 1
    assert tmesh.get_tensor_model_parallel_size() == 1
    assert tmesh.coords() == dict(pp=0, dp=0, cp=0, tp=0, ep=0, dp_exp=0)
    x = torch.arange(6.0)
    from neuronx_distributed_tpu_torch.parallel import comm

    assert comm.all_gather(x) is x and comm.all_reduce(x) is x
    assert tint.dp_consensus_fingerprints({"w": x}).shape == (1, 1)
    tp = 2
    with pytest.raises(ValueError, match="process group"):
        tconfig.neuronx_distributed_config(tensor_parallel_size=tp)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.initialize_model_parallel(tensor_model_parallel_size=tp)


def _jax_shard_map(fn, tp, in_specs, out_specs):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:tp]), ("tp",))
    return jax.jit(jmesh.shard_map(fn, mesh, in_specs=in_specs,
                                   out_specs=out_specs))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Each rank's results in a 4-rank world at tp=2 x dp=2 (ep=2 in the
    expert view) and in one at tp=4."""
    xs = np.random.RandomState(0).randn(4, 4, 6).astype(np.float32)
    out = {}
    for tp, ep in ((2, 2), (4, 1)):
        d = tmp_path_factory.mktemp(f"mesh{tp}")
        out[tp] = run_ranks(torch_ranks.mesh_and_comm, 4, backend="gloo",
                            device="cpu", store_dir=str(d),
                            args=(tp, ep, xs), timeout=120)
    return xs, out


def test_ranks_layout_getters(world4):
    """Sizes, coords and group members on each rank follow the layout:
    rank = ((pp * dp + d) * cp + c) * tp + t."""
    _, out = world4
    for r, res in enumerate(out[2]):
        assert res["sizes"] == dict(pp=1, dp=2, cp=1, tp=2, ep=2, dp_exp=1)
        assert res["world"] == 4
        assert res["coords"]["tp"] == r % 2 and res["coords"]["dp"] == r // 2
        assert res["members"]["tp"] == [r - r % 2, r - r % 2 + 1]
        assert res["members"]["dp"] == [r % 2, r % 2 + 2]
        assert res["zero1"] == res["members"]["dp"]
        assert res["members"]["ep"] == res["members"]["dp"]
        assert res["replica_groups"]["tp"] == [[0, 1], [2, 3]]
        assert res["replica_groups"]["zero1"] == [[0, 2], [1, 3]]
    for r, res in enumerate(out[4]):
        assert res["coords"]["tp"] == r and res["members"]["tp"] == [0, 1,
                                                                     2, 3]


def test_collectives_on_gloo_ranks(world4):
    """Each collective of ``comm`` against numpy on the ranks' inputs:
    all-reduce (sum, max, over tp and over dp), tiled all-gather on two
    dims, reduce-scatter, all-to-all, the send/recv ring and the split;
    CPU tensors are never host-staged."""
    xs, out = world4
    for tp in (2, 4):
        for r, res in enumerate(out[tp]):
            grp = [g for g in range(4) if g // tp == r // tp]
            mine = xs[grp]
            np.testing.assert_allclose(res["all_reduce"], mine.sum(0),
                                       rtol=1e-6)
            np.testing.assert_array_equal(res["all_reduce_max"], mine.max(0))
            np.testing.assert_array_equal(res["all_gather"],
                                          np.concatenate(mine, -1))
            np.testing.assert_array_equal(res["all_gather0"],
                                          np.concatenate(mine, 0))
            t = r % tp
            np.testing.assert_allclose(
                res["reduce_scatter"],
                np.concatenate([mine.sum(0)] * tp, 1)[:, 6 * t:6 * t + 6],
                rtol=1e-6)
            np.testing.assert_array_equal(
                res["all_to_all"], np.concatenate(list(mine), 1))
            np.testing.assert_array_equal(res["ppermute"], mine[(t - 1) % tp])
            np.testing.assert_array_equal(res["split"], xs[r])
            assert res["staged"] == {}
    for r, res in enumerate(out[2]):
        dp_grp = xs[[r % 2, r % 2 + 2]]
        np.testing.assert_allclose(res["all_reduce_dp"], dp_grp.sum(0),
                                   rtol=1e-6)


def test_ranks_import_nothing_of_jax(world4):
    """A spawned rank runs the port alone: neither JAX nor the JAX package
    is in its ``sys.modules`` (the test process imports both)."""
    for res in world4[1][2] + world4[1][4]:
        assert res["jax_modules"] == []


def test_per_rank_generators(world4):
    """``model_parallel_rng`` differs per tp rank and agrees across dp;
    ``data_parallel_rng`` differs per dp rank and agrees across tp; the
    replicated stream (all ranks of one tp group) is not the tp one (the
    2718 offset)."""
    _, out = world4
    res = out[2]
    mp = [r["mp_rng"] for r in res]
    dpg = [r["dp_rng"] for r in res]
    assert not torch.equal(mp[0], mp[1]) and torch.equal(mp[0], mp[2])
    assert torch.equal(dpg[0], dpg[1]) and not torch.equal(dpg[0], dpg[2])
    assert not torch.equal(mp[0], dpg[0])


def test_dp_consensus_fingerprints_gather_every_replica(world4):
    """Each rank holds ``[dp, n_leaves]``: row d is dp replica d's
    fingerprint vector, on every rank of a tp group alike."""
    _, out = world4
    res = out[2]
    for r, rr in enumerate(res):
        m = rr["consensus"]
        assert m.shape == (2, 1)
        assert torch.equal(m[rr["coords"]["dp"]], rr["fingerprint"])
        assert torch.equal(m[1 - rr["coords"]["dp"]],
                           res[r ^ 2]["fingerprint"])


def test_a_failing_rank_raises_with_its_traceback(tmp_path):
    with pytest.raises(RankError, match="not divisible"):
        run_ranks(torch_ranks.mesh_and_comm, 2, backend="gloo",
                  device="cpu", store_dir=str(tmp_path),
                  args=(3, 1, np.zeros((2, 4, 6), np.float32)), timeout=60)


@pytest.mark.parametrize("heads,tp", [(32, 8), (30, 8), (5, 4), (7, 2)])
def test_head_padding_matches_jax(heads, tp):
    rng = np.random.RandomState(heads)
    hd, h = 4, 8
    q = rng.randn(h, heads * hd).astype(np.float32)
    o = rng.randn(heads * hd, h).astype(np.float32)
    jq, jo, jn = jpad.pad_attention_params(q, o, heads, hd, tp)
    tq, to, tn = tpad.pad_attention_params(torch.from_numpy(q),
                                           torch.from_numpy(o), heads, hd, tp)
    assert tn == jn == heads + jpad.get_number_of_extra_heads(heads, tp)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(
        tpad.generate_padding_mask(heads, tn, hd).numpy(),
        np.asarray(jpad.generate_padding_mask(heads, jn, hd)))


@pytest.mark.parametrize("tp", [2, 4])
def test_distributed_argmax_and_topk_match_jax(tp, tmp_path):
    """Global argmax and top-k of a vocab-sharded ``[3, 5, 32]`` with ties
    (values rounded to a coarse grid) equal JAX's under ``shard_map``."""
    from jax.sharding import PartitionSpec as P

    rng = np.random.RandomState(tp)
    x = np.round(rng.randn(3, 5, 32) * 2).astype(np.float32)
    k = 3

    def f(xl):
        v, i = jops.distributed_topk(xl, k)
        return jops.distributed_argmax(xl)[None], v[None], i[None]

    jam, jv, ji = _jax_shard_map(f, tp, (P(None, None, "tp"),),
                                 (P("tp"), P("tp"), P("tp")))(jnp.asarray(x))
    outs = run_ranks(torch_ranks.operators_all, tp, backend="gloo",
                     device="cpu", store_dir=str(tmp_path), args=(tp, x, k),
                     timeout=120)
    for r, res in enumerate(outs):
        np.testing.assert_array_equal(res["argmax"], np.asarray(jam[r]))
        np.testing.assert_array_equal(res["topk"][0], np.asarray(jv[r]))
        np.testing.assert_array_equal(res["topk"][1], np.asarray(ji[r]))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_grad_norm_and_clip_match_jax_on_one_rank(max_norm):
    """``global_grad_norm`` and ``clip_grad_norm`` over a gradient dict on
    one rank equal JAX's (``parallel/grads.py``) over the same tree, within
    1e-6 relative: the norm, and each clipped leaf."""
    from neuronx_distributed_tpu.parallel import grads as jgrads
    from neuronx_distributed_tpu_torch.parallel import grads as tgrads

    rng = np.random.RandomState(int(max_norm))
    tree = {"a": rng.randn(4, 6).astype(np.float32),
            "b": rng.randn(5).astype(np.float32) * 3}
    jclip, jnorm = jgrads.clip_grad_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    tmesh.destroy_model_parallel()
    tgr = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    np.testing.assert_allclose(float(tgrads.global_grad_norm(tgr)),
                               float(jgrads.global_grad_norm(tree)),
                               rtol=1e-6)
    tclip, tnorm = tgrads.clip_grad_norm(tgr, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(tclip[k].numpy(), np.asarray(jclip[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="max_norm"):
        tgrads.clip_grad_norm(tgr, 0.0)
