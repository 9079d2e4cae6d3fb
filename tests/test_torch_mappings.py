"""The port's differentiable collective pairs (``parallel/mappings.py``)
against the JAX package's ``custom_vjp`` pairs under ``shard_map``, at
tp=2 and tp=4: each mapping's forward on every rank's input and its
gradient from every rank's cotangent, on gloo ranks on the CPU
(``tests/torch_ranks.py``). Data movement only, so the limit is exact
equality, but for the sums: 1e-6 relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from neuronx_distributed_tpu.parallel import mappings as jmap
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu_torch.parallel import mappings as tmap
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ranks

# name: (function, kwargs, input shape, whether every rank gets the same
# input, as for a replicated value)
MAPPINGS = {
    "copy": ("copy_to_tensor_parallel_region", {}, (2, 8, 8), True),
    "reduce": ("reduce_from_tensor_parallel_region", {}, (2, 8, 8), False),
    "scatter": ("scatter_to_tensor_parallel_region", {"dim": -1}, (2, 8, 8),
                True),
    "gather": ("gather_from_tensor_parallel_region", {"dim": -1}, (2, 8, 4),
               False),
    "sp_scatter": ("scatter_to_sequence_parallel_region", {"seq_dim": 1},
                   (2, 8, 8), True),
    "sp_gather": ("gather_from_sequence_parallel_region",
                  {"seq_dim": 1, "to_model_parallel": True}, (2, 4, 8),
                  False),
    "sp_gather_split": ("gather_from_sequence_parallel_region",
                        {"seq_dim": 1, "to_model_parallel": False},
                        (2, 4, 8), False),
    "sp_reduce_scatter": ("reduce_scatter_to_sequence_parallel_region",
                          {"seq_dim": 1}, (2, 8, 8), False),
    "ep_enter": ("enter_expert_parallel_region",
                 {"axis": "tp", "split_dim": 0, "concat_dim": 1},
                 (8, 4, 6), False),
    "ep_exit": ("exit_expert_parallel_region",
                {"axis": "tp", "split_dim": 1, "concat_dim": 0},
                (2, 8, 6), False),
}


def _jax_per_rank(fn, kw, xs, cts, tp):
    """``(y, dx)`` of every rank under ``shard_map``: rank r's input
    ``xs[r]`` and cotangent ``cts[r]`` (``cts`` None: the shape of the
    ranks' ``y``)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:tp]), ("tp",))
    f = getattr(jmap, fn)

    if cts is None:
        def body(x):
            return f(x[0], **kw)[None]
        return jax.eval_shape(jmesh.shard_map(
            body, mesh, in_specs=(P("tp"),), out_specs=P("tp")), xs).shape

    def body(x, ct):
        y, vjp = jax.vjp(lambda a: f(a, **kw), x[0])
        return y[None], vjp(ct[0])[0][None]

    y, dx = jax.jit(jmesh.shard_map(
        body, mesh, in_specs=(P("tp"), P("tp")),
        out_specs=(P("tp"), P("tp"))))(xs, cts)
    return np.asarray(y), np.asarray(dx)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Per tp: the JAX side's ``{name: (y, dx)}`` and the port ranks'."""
    out = {}
    for tp in (2, 4):
        rng = np.random.RandomState(tp)
        cases, jax_side = {}, {}
        for name, (fn, kw, shape, same) in MAPPINGS.items():
            x = rng.randn(*shape).astype(np.float32)
            xs = (np.stack([x] * tp) if same else
                  rng.randn(tp, *shape).astype(np.float32))
            cts = rng.randn(*_jax_per_rank(fn, kw, jnp.asarray(xs), None,
                                           tp)).astype(np.float32)
            jax_side[name] = _jax_per_rank(fn, kw, jnp.asarray(xs),
                                           jnp.asarray(cts), tp)
            cases[name] = (fn, kw, xs, cts)
        d = tmp_path_factory.mktemp(f"mappings{tp}")
        ranks = run_ranks(torch_ranks.mappings_all, tp, backend="gloo",
                          device="cpu", store_dir=str(d), args=(tp, cases),
                          timeout=120)
        out[tp] = (jax_side, ranks)
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(MAPPINGS))
def test_mapping_forward_and_gradient_match_jax(results, name, tp):
    jax_side, ranks = results[tp]
    jy, jdx = jax_side[name]
    for r, res in enumerate(ranks):
        y, dx = res[name]
        np.testing.assert_allclose(y.numpy(), jy[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} forward, rank {r}")
        np.testing.assert_allclose(dx.numpy(), jdx[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} gradient, rank {r}")


def test_mappings_are_identities_on_one_rank():
    """With one rank (no layout, or a world of one) every mapping returns
    its input and passes its gradient through."""
    import torch

    x = torch.randn(2, 8, 8, requires_grad=True)
    for fn, kw, _, _ in MAPPINGS.values():
        assert getattr(tmap, fn)(x, **kw) is x


def test_sequence_reduce_scatter_refuses_a_ragged_sequence(tmp_path):
    """A sequence the tp ranks do not divide raises with the reference's
    message, not a shape error from inside the collective."""
    xs = np.zeros((2, 2, 7, 4), np.float32)
    cases = {"bad": ("reduce_scatter_to_sequence_parallel_region",
                     {"seq_dim": 1}, xs, xs)}
    with pytest.raises(Exception, match="does not divide evenly"):
        run_ranks(torch_ranks.mappings_all, 2, backend="gloo", device="cpu",
                  store_dir=str(tmp_path), args=(2, cases), timeout=60)
