"""The port's pipeline-parallel Llama against the JAX package's
``llama_pipeline.make_pipeline_grad_fn`` in its other layouts and
configurations: tied embeddings under 1F1B and GPipe, ``vocab_pp`` tied
and untied, one layer and a tied table at pp=2 (stage 1 holds only the
norm and the table), pp=4 at tp=1 and pp=2 x dp=2. ``vocab_pp`` with
sequence parallelism is held to JAX's 1F1B without ``vocab_pp``: JAX's
``vocab_pp`` doubles every gradient there (its SP gather reduce-scatters
a cotangent already summed over ``(pp, tp)``), which
``test_jax_vocab_pp_under_sp_doubles_the_gradients`` records. One world of four
gloo ranks runs every case; limits as ``tests/test_torch_pipeline.py``'s
(loss 1e-5 relative, every gradient 1e-4 x its max |g|).

Also, on the port alone: the graphs a 1F1B stage holds stay at the
executor's bound as M goes 4 -> 8 -> 16 (at S=2, S - s), and attention
dropout under 1F1B: remat recomputes the forward's masks bit for bit,
masks differ per step, microbatch, stage and layer, and GPipe raises
where JAX raises."""

import dataclasses

import pytest
import torch

from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import llama_pipeline as jlpp
from neuronx_distributed_tpu.pipeline import engine_1f1b as je1
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import llama_pipeline as tlpp
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import jax_pp_refs as refs
import torch_pp_ranks

CASES = {
    "tied": dict(L=4, tp=2, pp=2, sp=True, schedule="1f1b", M=4, tie=True),
    "tied_gpipe": dict(L=4, tp=2, pp=2, sp=True, schedule="gpipe", M=4,
                       tie=True),
    "vocab_pp": dict(L=4, tp=2, pp=2, schedule="1f1b", M=4,
                     vocab_pp=True),
    "vocab_pp_tied": dict(L=4, tp=2, pp=2, schedule="1f1b", M=4,
                          vocab_pp=True, tie=True),
    # JAX's vocab_pp under sequence parallelism doubles every gradient
    # (its SP gather's reduce-scatter sums a cotangent the head's entry
    # already summed over (pp, tp)); the port is held to JAX's 1F1B
    # without vocab_pp, the same function
    "vocab_pp_sp": dict(L=4, tp=2, pp=2, sp=True, schedule="1f1b", M=4,
                        vocab_pp=True, jax=dict(vocab_pp=False)),
    "one_layer_tied": dict(L=1, tp=2, pp=2, sp=True, schedule="1f1b", M=4,
                           tie=True),
    "pp4": dict(L=4, tp=1, pp=4, schedule="1f1b", M=4),
    "pp2_dp2": dict(L=4, tp=1, pp=2, schedule="1f1b", M=3),
}
BATCH = refs.batch(1, 12, 16, ignore_rows=3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jax_out, cases = {}, []
    for name, case in CASES.items():
        sd, loss, grads = refs.jax_pipeline(dict(case, **case.get("jax", {})),
                                            BATCH)
        jax_out[name] = (loss, grads)
        cases.append(dict(case, name=name, cfg=refs.port_cfg(case), sd=sd))
    store = tmp_path_factory.mktemp("pp_variants")
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


def test_stage_holdings(world):
    """Each stage holds its parameters under their global names: the tied
    table on the first and last stage, the vocab_pp tables and norm on
    every stage as (pp, tp) shards, stage 1 of the one-layer model only
    the norm and the table."""
    _, outs = world
    for o in outs:
        s = o["tied"]["coords"]["pp"]
        assert "embed.embedding" in o["tied"]["grads"]
        assert ("norm.scale" in o["tied"]["grads"]) == (s == 1)
        assert sorted(o["one_layer_tied"]["grads"]) == (
            ["embed.embedding", "norm.scale"] if s == 1 else
            sorted(n for n in o["tied"]["grads"]
                   if n.startswith(("embed.", "layers.0."))))
        specs = o["vocab_pp_sp"]["specs"]
        assert specs["embed.embedding"] == (("pp", "tp"), None)
        assert specs["lm_head.kernel"] == (None, ("pp", "tp"))
        assert o["vocab_pp"]["grads"]["embed.embedding"].shape[0] == 256 // 4


def _live_batches(ms):
    return {m: refs.batch(2, 2 * m, 16) for m in ms}


def test_1f1b_live_graphs_stay_at_the_bound_as_m_grows(tmp_path):
    """Stage s of S holds at most max(1, 2(S-1-s)) graphs whatever M (S - s
    at S = 2), where GPipe holds M."""
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=4)
    sd = tl.init_state_dict(cfg, seed=3, device="cpu")
    ms = (4, 8, 16)
    outs = run_ranks(torch_pp_ranks.live_graphs_world, 4, backend="gloo",
                     device="cpu", store_dir=str(tmp_path),
                     args=(cfg, sd, [(2, 2), (1, 4)], ms, _live_batches(ms)),
                     timeout=600)
    for o in outs:
        for (tp, pp, m), r in o.items():
            s = r["stage"]
            assert r["stats"]["max_live"] == min(m, max(1, 2 * (pp - 1 - s))), (
                tp, pp, m, r)
            assert r["stats"]["ticks"] == m + 2 * pp - 2
            if pp == 2:
                assert r["stats"]["max_live"] == pp - s


def test_dropout_under_1f1b(tmp_path):
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=4,
                         attention_dropout=0.3, use_flash_attention=True)
    sd = tl.init_state_dict(cfg, seed=4, device="cpu")
    batch = refs.batch(5, 4, 16)
    outs = run_ranks(torch_pp_ranks.dropout_world, 4, backend="gloo",
                     device="cpu", store_dir=str(tmp_path),
                     args=(cfg, sd, batch, 11), timeout=600)
    for o in outs:
        # the remat recompute draws the forward's masks: bit for bit
        assert o["remat"]["loss"] == o["plain"]["loss"]
        for n, g in o["plain"]["grads"].items():
            assert torch.equal(o["remat"]["grads"][n], g), n
        # masks change with the step, and dropout changes the loss
        assert o["step1"]["loss"] != o["plain"]["loss"]
        assert o["nodrop"]["loss"] != o["plain"]["loss"]
    with pytest.raises(ValueError) as want:
        jlpp.make_pipeline_grad_fn(jl.tiny_config(attention_dropout=0.3), 2,
                                   None, schedule="gpipe")
    assert outs[0]["gpipe"] == str(want.value)


def test_dropout_seeds_are_distinct_per_microbatch_stage_and_layer():
    """Each (step, slot, stage) seeds its own generator and each layer
    draws in turn: no two (step, slot, stage, layer) draw one seed, and
    the same four numbers draw the same."""
    from neuronx_distributed_tpu_torch.modules.attention import (
        attention_dropout_seed)

    seeds = {}
    for step in range(2):
        for slot in range(8):
            for stage in range(2):
                gen = tlpp.dropout_generator(11, step, slot, stage)
                for layer in range(2):
                    seeds[(step, slot, stage, layer)] = \
                        attention_dropout_seed(0.3, gen)[1]
    assert len(set(seeds.values())) == len(seeds)
    again = tlpp.dropout_generator(11, 1, 5, 1)
    assert attention_dropout_seed(0.3, again)[1] == seeds[(1, 5, 1, 0)]


def test_interleave_renames_layers_as_jax_orders_them():
    cfg = dataclasses.replace(tl.tiny_config(num_layers=8))
    sd = {f"layers.{i}.w": torch.tensor(float(i)) for i in range(8)}
    sd["norm.scale"] = torch.ones(1)
    out = tlpp.interleave_pipeline_params(sd, cfg, 2, 2)
    order = [int(out[f"layers.{j}.w"]) for j in range(8)]
    assert order == je1.interleaved_layer_order(8, 2, 2).tolist()
    back = tlpp.deinterleave_pipeline_params(out, cfg, 2, 2)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    assert tlpp.unpad_pipeline_params(sd, cfg) == sd


def test_jax_vocab_pp_under_sp_doubles_the_gradients(world):
    """The divergence recorded in ROADMAP: JAX's vocab_pp gradients under
    sequence parallelism are twice its own 1F1B's on the same weights (the
    port's equal the latter, ``test_loss_and_grads_equal_jax
    [vocab_pp_sp]``); its loss is the same."""
    case = CASES["vocab_pp_sp"]
    _, loss, grads = refs.jax_pipeline(dict(case, jax={}), BATCH)
    jax_out, _ = world
    want_loss, want = jax_out["vocab_pp_sp"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for n in ("norm.scale", "layers.0.attn.qkv.q_kernel"):
        ratio = float(grads[n].abs().max() / want[n].abs().max())
        assert abs(ratio - 2.0) < 1e-4, (n, ratio)
