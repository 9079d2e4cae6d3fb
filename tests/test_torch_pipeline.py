"""The port's pipeline-parallel Llama (``models/llama_pipeline.py`` over
``pipeline/spmd_engine.py`` and ``pipeline/engine_1f1b.py``) against the JAX
package's ``llama_pipeline.make_pipeline_grad_fn`` under ``jax.jit`` on the
virtual CPU mesh, at pp=2 x tp=2 with sequence parallelism: the GPipe, 1F1B
and interleaved (C=2, also at M=6, which needs pad microbatches) schedules
and the uneven partition L=3. One world of four gloo ranks runs every case,
one layout after another, from JAX's weights (``params_from_jax``) and the
same global batch. Limits: the loss within 1e-5 relative, every gradient by
name within 1e-4 x its max |g| (the interleaved ones deinterleaved to
canonical names); the forward-only eval function's loss within 1e-5. The
uneven partition holds no pad layer: no rank has a gradient of a layer past
L."""

import pytest
import torch

from neuronx_distributed_tpu_torch.models import llama_pipeline as tlpp
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import jax_pp_refs as refs
import torch_pp_ranks

CASES = {
    "gpipe": dict(L=4, tp=2, pp=2, sp=True, schedule="gpipe", M=4,
                  eval=True),
    "1f1b": dict(L=4, tp=2, pp=2, sp=True, schedule="1f1b", M=4),
    "interleaved": dict(L=4, tp=2, pp=2, sp=True, schedule="interleaved",
                        chunks=2, M=4),
    "interleaved_m6": dict(L=4, tp=2, pp=2, sp=True,
                           schedule="interleaved", chunks=2, M=6),
    "uneven": dict(L=3, tp=2, pp=2, sp=True, schedule="1f1b", M=4),
}
BATCH = refs.batch(0, 12, 16, ignore_rows=3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jax_out, cases = {}, []
    for name, case in CASES.items():
        sd, loss, grads = refs.jax_pipeline(case, BATCH)
        jax_out[name] = (loss, grads)
        cfg = refs.port_cfg(case)
        if case.get("chunks", 1) > 1:
            sd = tlpp.interleave_pipeline_params(sd, cfg, case["pp"],
                                                 case["chunks"])
        cases.append(dict(case, name=name, cfg=cfg, sd=sd))
    store = tmp_path_factory.mktemp("pp_world")
    outs = run_ranks(torch_pp_ranks.grads_world, 4, backend="gloo",
                     device="cpu", store_dir=str(store),
                     args=(cases, BATCH), timeout=600)
    return jax_out, outs


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_equal_jax(world, name):
    jax_out, outs = world
    want_loss, want_grads = jax_out[name]
    for o in outs:
        assert o["jax_modules"] == []
        assert abs(o[name]["loss"] - want_loss) <= 1e-5 * abs(want_loss)
    refs.assert_grads_match(refs.gather_grads(outs, name, CASES[name]),
                            want_grads)


def test_uneven_partition_holds_no_pad_layer(world):
    """L=3 over 2 stages: stage 0 holds layers 0-1 (JAX's ⌈3/2⌉ a stage),
    stage 1 layer 2, the norm and the head; no pad layer 3 anywhere."""
    _, outs = world
    for o in outs:
        layers = {int(n.split(".")[1]) for n in o["uneven"]["grads"]
                  if n.startswith("layers.")}
        assert layers == ({0, 1} if o["uneven"]["coords"]["pp"] == 0
                          else {2})
    assert tlpp.stage_layers(3, 2, 1) == range(2, 3)
    assert tlpp.stage_layers(1, 2, 1) == range(1, 1)


def test_gpipe_keeps_every_graph_and_1f1b_the_in_flight_ones(world):
    """GPipe holds all M microbatch graphs on every stage; 1F1B at S=2
    holds S - s (2 on stage 0, 1 on stage 1)."""
    _, outs = world
    for o in outs:
        s = o["gpipe"]["coords"]["pp"]
        assert o["gpipe"]["stats"]["max_live"] == 4
        assert o["1f1b"]["stats"]["max_live"] == 2 - s
        assert o["1f1b"]["stats"]["ticks"] == 4 + 2 + 2 - 2


def test_eval_fn_equals_jax(world):
    """``make_pipeline_eval_fn`` (the forward alone over the GPipe clock)
    gives JAX's ``make_pipeline_eval_fn`` loss within 1e-5, the same on
    every rank, and the grad function's loss."""
    _, outs = world
    want = CASES["gpipe"]["jax_eval"]
    for o in outs:
        assert abs(o["gpipe"]["eval"] - want) <= 1e-5 * abs(want)
        assert abs(o["gpipe"]["eval"] - o["gpipe"]["loss"]) <= 1e-6 * abs(
            want)
