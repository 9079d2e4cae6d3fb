"""The port's sharded layers and vocab-parallel losses against the JAX
package's under ``shard_map`` from the same weights, at tp=2 and tp=4:
``ColumnParallelLinear`` (with and without ``gather_output`` and sequence
parallelism), ``RowParallelLinear`` (all-reduce, reduce-scatter, a
replicated input), the vocab-sharded ``ParallelEmbedding``,
``GQAQKVColumnParallelLinear`` (kv heads split, and fewer kv heads than
ranks: ``kv_size_multiplier`` 2), ``embedding_attend``,
``parallel_cross_entropy`` (with ``ignore_index`` and label smoothing),
``distributed_log_softmax`` and ``fused_linear_cross_entropy``. Each
rank's outputs, input gradients and parameter gradients (each rank's
local loss is the sum of its outputs times its cotangent) are held to
JAX's rank by rank within 1e-5 of the largest magnitude, in fp32. The
ranks run on gloo on the CPU (``tests/torch_ranks.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax.core import meta
from jax.sharding import PartitionSpec as P

from neuronx_distributed_tpu.parallel import layers as jlayers
from neuronx_distributed_tpu.parallel import loss_functions as jlf
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu_torch.parallel import layers as tlayers
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ranks

B, S, H = 2, 8, 8
V = 32
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


def _split(a, spec, tp, r):
    for d, ax in enumerate(spec):
        if ax == "tp":
            return np.split(a, tp, axis=d)[r]
    return a


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _module_case(mod, inputs, ispecs, kind, tkw):
    """A flax layer's global params and specs (initialised outside
    ``shard_map``, as the reference's GSPMD path makes them)."""
    boxed = mod.init(jax.random.key(0), jnp.asarray(inputs["x"]))
    specs = dict(_flat(nn.get_partition_spec(boxed)["params"]))
    params = {k: np.asarray(v, np.float32) if v.dtype != np.int32 else
              np.asarray(v) for k, v in _flat(meta.unbox(boxed)["params"])}

    def jfn(p, ins):
        out = mod.apply({"params": p}, ins["x"])
        return out if isinstance(out, tuple) else (out,)

    return dict(kind=kind, tkw=tkw, jfn=jfn, params=params,
                pspecs={k: tuple(v) for k, v in specs.items()},
                inputs=inputs, ispecs=ispecs)


def _cases(tp, rng):
    x = rng.randn(B, S, H).astype(np.float32)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :2] = -100
    rep, seq, last = (), (None, "tp"), (None, None, "tp")
    out = {}
    for sp in (False, True):
        xin = {"x": x}
        xsp = {"x": seq if sp else rep}
        out[f"column{'_sp' * sp}"] = _module_case(
            jlayers.ColumnParallelLinear(16, use_bias=True,
                                         sequence_parallel=sp, **F32),
            xin, xsp, "column",
            dict(in_features=H, out_features=16, use_bias=True,
                 sequence_parallel=sp))
        out[f"row{'_sp' * sp}"] = _module_case(
            jlayers.RowParallelLinear(H, use_bias=True,
                                      sequence_parallel=sp, **F32),
            {"x": rng.randn(B, S, 16).astype(np.float32)}, {"x": last},
            "row", dict(in_features=16, out_features=H, use_bias=True,
                        sequence_parallel=sp))
        for name, n, kv in (("gqa", 8, 4), ("gqa_rep", 8, tp // 2)):
            out[f"{name}{'_sp' * sp}"] = _module_case(
                jlayers.GQAQKVColumnParallelLinear(
                    num_heads=n, num_kv_heads=kv, head_dim=4, use_bias=True,
                    sequence_parallel=sp, tp_size=tp, **F32),
                xin, xsp, "gqa",
                dict(hidden=H, num_heads=n, num_kv_heads=kv, head_dim=4,
                     use_bias=True, sequence_parallel=sp))
        table = rng.randn(V, H).astype(np.float32)

        def attend(p, ins, sp=sp):
            return (jlayers.embedding_attend(
                p["table"], ins["x"], sequence_parallel=sp,
                dtype=jnp.float32),)

        out[f"attend{'_sp' * sp}"] = dict(
            kind="attend", tkw=dict(sequence_parallel=sp), jfn=attend,
            params={"table": table}, pspecs={"table": ("tp", None)},
            inputs=xin, ispecs=xsp)
    out["column_gather"] = _module_case(
        jlayers.ColumnParallelLinear(16, use_bias=False, gather_output=True,
                                     **F32), {"x": x}, {"x": rep}, "column",
        dict(in_features=H, out_features=16, gather_output=True))
    out["row_scatter"] = _module_case(
        jlayers.RowParallelLinear(H, use_bias=False, input_is_parallel=False,
                                  **F32),
        {"x": rng.randn(B, S, 16).astype(np.float32)}, {"x": rep}, "row",
        dict(in_features=16, out_features=H, input_is_parallel=False))
    emb = _module_case(jlayers.ParallelEmbedding(V, H, **F32), {"x": ids},
                       {"x": rep}, "embed",
                       dict(num_embeddings=V, features=H))
    out["embed"] = emb
    logits = rng.randn(B, S, V).astype(np.float32) * 3
    for smooth in (0.0, 0.1):
        def ce(p, ins, smooth=smooth):
            return (jlf.parallel_cross_entropy(
                ins["x"], ins["labels"], ignore_index=-100,
                label_smoothing=smooth),)

        out[f"ce{'_smooth' * bool(smooth)}"] = dict(
            kind="ce", tkw=dict(ignore_index=-100, label_smoothing=smooth),
            jfn=ce, params={}, pspecs={},
            inputs={"x": logits, "labels": labels},
            ispecs={"x": last, "labels": rep})
    out["logsoftmax"] = dict(
        kind="logsoftmax", tkw={},
        jfn=lambda p, ins: (jlf.distributed_log_softmax(ins["x"]),),
        params={}, pspecs={}, inputs={"x": logits}, ispecs={"x": last})
    out["fused"] = dict(
        kind="fused", tkw=dict(chunk=4),
        jfn=lambda p, ins: (jlf.fused_linear_cross_entropy(
            ins["x"], p["kernel"], ins["labels"], chunk=4,
            dtype=jnp.float32),),
        params={"kernel": rng.randn(H, V).astype(np.float32)},
        pspecs={"kernel": (None, "tp")},
        inputs={"x": x, "labels": labels}, ispecs={"x": rep, "labels": rep})
    return out


def _jax_side(case, tp, cts=None):
    """Per rank (a leading dim): the outputs' shapes, or with ``cts`` the
    outputs and the float inputs' and the params' gradients, under
    ``shard_map``."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:tp]), ("tp",))
    pspec = {k: P(*v) for k, v in case["pspecs"].items()}
    ispec = {k: P(*v) for k, v in case["ispecs"].items()}
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    inputs = {k: jnp.asarray(v) for k, v in case["inputs"].items()}
    floats = [k for k, v in case["inputs"].items() if v.dtype == np.float32]
    stack = lambda t: jax.tree.map(lambda a: a[None], t)   # noqa: E731
    if cts is None:
        fn = jmesh.shard_map(lambda p, i: stack(case["jfn"](p, i)), mesh,
                             in_specs=(pspec, ispec), out_specs=P("tp"))
        return [y.shape for y in jax.eval_shape(fn, params, inputs)]

    def body(p, i, ct):
        def loss(p, fl):
            ys = case["jfn"](p, {**i, **fl})
            return sum(jnp.sum(y * c[0]) for y, c in zip(ys, ct))

        fl = {k: i[k] for k in floats}
        ys = case["jfn"](p, i)
        gp, gi = jax.grad(loss, argnums=(0, 1))(p, fl)
        return stack(ys), stack(gi), stack(gp)

    fn = jmesh.shard_map(body, mesh, in_specs=(pspec, ispec, P("tp")),
                         out_specs=(P("tp"), P("tp"), P("tp")))
    ys, gi, gp = jax.jit(fn)(params, inputs,
                             tuple(jnp.asarray(c) for c in cts))
    return ([np.asarray(y) for y in ys],
            {k: np.asarray(v) for k, v in gi.items()},
            {k: np.asarray(v) for k, v in gp.items()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = {}
    for tp in (2, 4):
        rng = np.random.RandomState(10 + tp)
        cases = _cases(tp, rng)
        jax_side, port_cases = {}, {}
        for name, case in cases.items():
            cts = [rng.randn(*shape).astype(np.float32)
                   for shape in _jax_side(case, tp)]
            jax_side[name] = _jax_side(case, tp, cts)
            port_cases[name] = (
                case["kind"], case["tkw"],
                [{k: _split(v, case["pspecs"][k], tp, r)
                  for k, v in case["params"].items()} for r in range(tp)],
                [{k: _split(v, case["ispecs"][k], tp, r)
                  for k, v in case["inputs"].items()} for r in range(tp)],
                [[np.asarray(c[r]) for c in cts] for r in range(tp)])
        d = tmp_path_factory.mktemp(f"layers{tp}")
        ranks = run_ranks(torch_ranks.layers_all, tp, backend="gloo",
                          device="cpu", store_dir=str(d),
                          args=(tp, port_cases), timeout=180)
        out[tp] = (jax_side, ranks)
    return out


CASES = ["column", "column_sp", "column_gather", "row", "row_sp",
         "row_scatter", "embed", "gqa", "gqa_sp", "gqa_rep", "gqa_rep_sp",
         "attend", "attend_sp", "ce", "ce_smooth", "logsoftmax", "fused"]


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_sharded_layer_matches_jax(results, name, tp):
    (jys, jgi, jgp), ranks = results[tp][0][name], results[tp][1]
    for r, res in enumerate(ranks):
        ys, gi, gp = res[name]
        assert len(ys) == len(jys)
        for i, (y, jy) in enumerate(zip(ys, jys)):
            _close(y, jy[r], f"{name} output {i}, rank {r}")
        assert set(gi) == set(jgi)
        for k in gi:
            _close(gi[k], jgi[k][r], f"{name} d{k}, rank {r}")
        assert set(gp) == set(jgp), (set(gp), set(jgp))
        for k in gp:
            _close(gp[k], jgp[k][r], f"{name} d{k}, rank {r}")


def test_sharded_layers_refuse_adapters_and_bad_splits():
    """LoRA runs at tp=1 only; the kv heads must split over tp or tp over
    them; a dim tp does not divide raises."""
    with pytest.raises(ValueError, match="LoRA"):
        tlayers.ColumnParallelLinear(8, 16, tp_size=2, lora_rank=4)
    with pytest.raises(ValueError, match="LoRA"):
        tlayers.GQAQKVColumnParallelLinear(8, 4, 2, 4, tp_size=2,
                                           lora_rank=4)
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        tlayers.GQAQKVColumnParallelLinear(8, 24, 3, 4, tp_size=8)
    with pytest.raises(ValueError, match="num_kv_heads 3 not divisible"):
        tlayers.GQAQKVColumnParallelLinear(8, 12, 3, 4, tp_size=4)
    with pytest.raises(ValueError, match="not divisible"):
        tlayers.RowParallelLinear(10, 8, tp_size=4)


def test_spmd_rank_and_tp1_forms_are_the_plain_linear():
    """At tp=1 the column and row linears compute what ``Linear`` does;
    ``SPMDRank`` holds this rank's tp index (0 on one rank)."""
    torch.manual_seed(0)
    lin = tlayers.Linear(8, 6, dtype=torch.float32, use_bias=True)
    col = tlayers.ColumnParallelLinear(8, 6, dtype=torch.float32,
                                       use_bias=True)
    row = tlayers.RowParallelLinear(8, 6, dtype=torch.float32, use_bias=True)
    torch.nn.init.normal_(lin.kernel)
    torch.nn.init.normal_(lin.bias)
    x = torch.randn(2, 3, 8)
    col.load_state_dict(lin.state_dict())
    row.load_state_dict(lin.state_dict())
    assert torch.equal(col(x), lin(x)) and torch.equal(row(x), lin(x))
    assert int(tlayers.SPMDRank()()) == 0
