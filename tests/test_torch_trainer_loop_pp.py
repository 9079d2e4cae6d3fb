"""The train step, the ``Trainer`` loop and sharded checkpoints at
pipeline parallelism: the port's gloo ranks on the CPU against the JAX
package's ``make_train_step(grad_fn=)`` over ``llama_pipeline``'s 1F1B
grad function on the virtual CPU mesh, from the same weights
(``params_from_jax``) and global batches.

* two AdamW steps at pp=2 x tp=2 x dp=2 with sequence parallelism and
  ZeRO-1 (a world of 8): each loss within 1e-5 relative, each grad norm
  within 1e-5 relative, the updated parameters within 1e-3 x max|p|;
* ``Trainer.fit`` at pp=2 x tp=2 (4 steps, ``integrity_every=2``,
  checkpoints every 2): losses within 1e-5 (the first, before any update,
  1e-6), grad norms 1e-5, parameters 1e-3 x max|p|;
* tag 2 resumes bit for bit at pp=2 x tp=2 and holds the losses within
  1e-5 at tp=2 x dp=2, tp=1 (dp=4) and pp=4; a tp=2 x dp=2 tag resumes at
  pp=2 x tp=2 within 1e-5; ``reshard_checkpoint --pp 2`` writes a tag that
  loads bit for bit; a bit flipped on stage 1 is caught and every rank
  rewinds; SIGTERM to a stage-1 rank saves one tag and loses no step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import llama_pipeline as jlpp
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import jax_pp_refs as refs
import torch_pp_ranks

LR = 1e-3


def _cfg():
    return tl.tiny_config(dtype=torch.float32, num_layers=4,
                          use_flash_attention=True)


def _jax_run(batches, devices, M, zero1, fit):
    """JAX at pp=2 x tp=2 (x dp over ``devices``), sequence parallel, the
    1F1B grad function: per-step (loss, grad norm), initial and final
    params."""
    cfg = nxd.neuronx_distributed_config(
        tensor_parallel_size=2, pipeline_parallel_size=2,
        sequence_parallel=True, devices=jax.devices()[:devices],
        optimizer_config=nxd.OptimizerConfig(zero_one_enabled=zero1),
        mixed_precision_config=nxd.MixedPrecisionConfig(
            compute_dtype="float32"))
    try:
        jcfg = nxd.configure_model(cfg, jl.tiny_config(
            dtype=jnp.float32, param_dtype=jnp.float32, num_layers=4))
        pm, params = jtr.initialize_parallel_model(
            cfg, jl.LlamaForCausalLM(jcfg), jax.random.key(0),
            jnp.zeros((8, 16), jnp.int32),
            logical_axis_rules=jlpp.PIPELINE_LOGICAL_RULES)
        init = jax.tree.map(np.array, params)
        tx, state, sh = jtr.initialize_parallel_optimizer(
            pm, params, learning_rate=LR)
        gf = jlpp.make_pipeline_grad_fn(jcfg, M, pm.param_specs,
                                        schedule="1f1b")
        step = jtr.make_train_step(pm, tx, sh, grad_fn=gf, donate=False)
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        metrics = []
        if fit:
            class Rec:
                def on_train_start(self, trainer): ...

                def on_eval_end(self, trainer, m): ...

                def on_train_end(self, trainer): ...

                def on_step_end(self, trainer, m):
                    metrics.append((float(m["loss"]),
                                    float(m["grad_norm"])))

            state, _ = jloop.Trainer(step, state, callbacks=[Rec()]).fit(
                iter(jb), max_steps=len(jb))
        else:
            for b in jb:
                state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, init, jax.tree.map(np.asarray, state.params)
    finally:
        jmesh.destroy_model_parallel()


def _whole(outs, part):
    """The whole params of ``part`` from data rank 0's shards."""
    per_rank = [(o[part]["coords"] if "coords" in o[part]
                 else o["fit"]["coords"], o[part]["params"]) for o in outs]
    names = {n for _, p in per_rank for n in p}
    shapes = _shapes()
    return {n: refs.whole(per_rank, n, shapes[n]) for n in names}


def _shapes():
    return {n: t.shape for n, t in tl.LlamaForCausalLM(
        _cfg(), device="meta").state_dict().items()}


def _close_params(got, want, rel=1e-3):
    for name, w in want.items():
        w = torch.as_tensor(w)
        err = float((got[name] - w).abs().max()) / float(w.abs().max())
        assert err <= rel, (name, err)


def test_step_at_pp2_tp2_dp2_with_zero1_equals_jax(tmp_path):
    batches = [refs.batch(s, 8, 16, ignore_rows=2) for s in (7, 8)]
    jm, init, jfinal = _jax_run(batches, 8, 2, True, False)
    sd = convert.params_from_jax(_cfg(), init)
    outs = run_ranks(torch_pp_ranks.pp_step_world, 8, backend="gloo",
                     device="cpu", store_dir=str(tmp_path),
                     args=(_cfg(), sd, batches, LR), timeout=600)
    for o in outs:
        assert o["jax_modules"] == []
        for (loss, gn), (wl, wg) in zip(o["metrics"], jm):
            assert abs(loss - wl) <= 1e-5 * abs(wl)
            assert abs(gn - wg) <= 1e-5 * abs(wg)
        # ZeRO-1: the moments of a data rank's half of each parameter
        # (the embedding: 128 vocab rows a tp rank, 64 hidden over dp)
        if "embed.embedding" in o["moments"]:
            assert o["moments"]["embed.embedding"] == (128, 32)
    _close_params(_gather_step(outs), convert.params_from_jax(_cfg(),
                                                               jfinal))


def _gather_step(outs):
    per_rank = [(o["coords"], o["params"]) for o in outs]
    return {n: refs.whole(per_rank, n, s) for n, s in _shapes().items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    batches = [refs.batch(s, 8, 16, ignore_rows=2) for s in range(10, 14)]
    jm, init, jfinal = _jax_run(batches, 4, 4, False, True)
    sd = convert.params_from_jax(_cfg(), init)
    tmp = tmp_path_factory.mktemp("pp_loop")
    store = tmp / "store"
    store.mkdir()
    outs = run_ranks(torch_pp_ranks.pp_loop_world, 4, backend="gloo",
                     device="cpu", store_dir=str(store),
                     args=(_cfg(), sd, batches, str(tmp)), timeout=900)
    return dict(outs=outs, jax=jm, jfinal=jfinal, sd=sd)


def test_fit_at_pp2_tp2_equals_jax(world):
    outs, jm = world["outs"], world["jax"]
    for o in outs:
        assert o["jax_modules"] == []
        got = o["fit"]["metrics"]
        assert len(got) == 4
        assert abs(got[0][0] - jm[0][0]) <= 1e-6 * abs(jm[0][0])
        for (loss, gn), (wl, wg) in zip(got, jm):
            assert abs(loss - wl) <= 1e-5 * abs(wl)
            assert abs(gn - wg) <= 1e-5 * abs(wg)
        assert o["fit"]["checks"] == 2 and o["fit"]["mismatches"] == 0
        assert o["fit"]["tags"] == ["2", "4"]
        # each stage writes its own files; the fingerprints are global
        assert o["fit"]["files"] == ["shard_pp0_tp0_dp0.pt",
                                     "shard_pp0_tp1_dp0.pt",
                                     "shard_pp1_tp0_dp0.pt",
                                     "shard_pp1_tp1_dp0.pt"]
        assert torch.equal(o["fit"]["fps"][2], outs[0]["fit"]["fps"][2])
    _close_params(_whole(outs, "fit"),
                  convert.params_from_jax(_cfg(), world["jfinal"]))


def test_fingerprints_are_the_whole_models(world):
    """``integrity_fp`` at pp=2 x tp=2 is the one-process fingerprint of
    the whole tensors, in the whole model's parameter order."""
    from neuronx_distributed_tpu_torch.resilience import integrity

    outs = world["outs"]
    whole = _whole(outs, "fit")
    names = list(_shapes())
    want = integrity.fingerprint_tree({n: whole[n] for n in names})
    assert torch.equal(outs[0]["fit"]["fps"][4], want)


def test_same_layout_resume_is_bit_for_bit(world):
    for o in world["outs"]:
        assert o["same"]["step"] == 4
        assert o["same"]["metrics"] == o["fit"]["metrics"][2:]
        for name, p in o["same"]["params"].items():
            assert torch.equal(p, o["fit"]["params"][name]), name


@pytest.mark.parametrize("part", ["tp2dp2", "tp1", "pp4", "from_tp"])
def test_resume_at_another_layout_holds_the_losses(world, part):
    """A pp=2 x tp=2 tag at tp=2 x dp=2, tp=1 (dp=4) and pp=4, and a tp=2 x
    dp=2 tag at pp=2 x tp=2: steps 3-4 within 1e-5 of the uninterrupted
    losses."""
    outs = world["outs"]
    ref = outs[0]["fit"]["metrics"][2:]
    for o in outs:
        assert len(o[part]["metrics"]) == 2
        for (loss, _), (want, _) in zip(o[part]["metrics"], ref):
            np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_reshard_cli_writes_a_pipeline_layout(world):
    """``reshard_checkpoint --tp 2 --pp 2`` writes tag 4 as pp=2 x tp=2
    ranks would (one file per stage and tp rank), and it loads bit for bit
    into a pp=2 x tp=2 state: parameters and moments."""
    for o in world["outs"]:
        r = o["resharded"]
        assert r["step"] == 4
        assert r["files"] == o["fit"]["files"]
        for name, p in r["params"].items():
            assert torch.equal(p, o["fit"]["params"][name]), name
        for a, b in zip(r["mu"], o["tag4"]["mu"]):
            assert torch.equal(a, b)


def test_bitflip_on_one_stage_rewinds_every_rank(world):
    """A bit flipped in stage 1's tp rank 0 at the step-4 boundary, after
    that boundary's save: every rank sees the mismatch, rewinds to tag 4,
    and the rewound parameters' fingerprint is step 4's."""
    for o in world["outs"]:
        d = o["drill"]
        c = o["fit"]["coords"]
        assert d["flips"] == int(c["pp"] == 1 and c["tp"] == 0)
        assert (d["mismatches"], d["checks"], d["rewinds"],
                d["host_step"]) == (1, 2, 1, 4)
        assert torch.equal(d["rewound"], d["step4"])


def test_sigterm_to_one_stage_saves_one_tag_and_loses_no_step(world):
    for o in world["outs"]:
        s = o["sigterm"]
        assert s["preempted"] == (3, "3", 75)
        assert s["tags"] == ["3"] and s["resumed_at"] == 3
        for name, p in s["params"].items():
            assert torch.equal(p, o["fit"]["params"][name]), name


def test_grad_fn_composes_with_accumulation_and_skip_nonfinite():
    """In one process: ``make_train_step(grad_fn=)`` with
    ``grad_accum_steps=2`` over a grad function of the model's own loss
    takes the default step's update bit for bit, and with
    ``skip_nonfinite`` a non-finite gradient leaves the state as it was."""
    from neuronx_distributed_tpu_torch import trainer as ttr
    from neuronx_distributed_tpu_torch.config import (
        MixedPrecisionConfig, neuronx_distributed_config)

    cfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    sd = tl.init_state_dict(cfg, seed=2, device="cpu")
    batch = refs.batch(3, 4, 16, ignore_rows=1)
    ncfg = neuronx_distributed_config(
        mixed_precision_config=MixedPrecisionConfig(compute_dtype="float32"))

    def run(**kw):
        pm, params = ttr.initialize_parallel_model(ncfg, cfg, state_dict=sd,
                                                   device="cpu")
        tx, state = ttr.initialize_parallel_optimizer(pm, params, LR)
        poison = kw.pop("poison", False)

        def grad_fn(ps, b):
            loss = pm.module.loss(torch.as_tensor(b["input_ids"]),
                                  torch.as_tensor(b["labels"]))
            names = list(ps)
            gs = torch.autograd.grad(loss, [ps[n] for n in names])
            if poison:
                gs = [g * float("nan") for g in gs]
            return loss.detach(), dict(zip(names, gs))

        step = ttr.make_train_step(
            pm, tx, grad_fn=grad_fn if kw.pop("with_grad_fn") else None,
            **kw)
        _, m = step(state, batch)
        return m, {n: p.detach().clone() for n, p in params.items()}

    want_m, want = run(with_grad_fn=False, grad_accum_steps=2)
    got_m, got = run(with_grad_fn=True, grad_accum_steps=2)
    assert torch.equal(got_m["loss"], want_m["loss"])
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
    for n, p in want.items():
        assert torch.equal(got[n], p), n
    skip_m, skipped = run(with_grad_fn=True, skip_nonfinite=True,
                          poison=True)
    assert skip_m["nonfinite_skipped"] == 1
    for n, p in skipped.items():
        assert torch.equal(p, sd[n]), n


def test_reshard_cli_refuses_a_corrupt_tag(tmp_path):
    """The CLI verifies the tag once and refuses a corrupt one before it
    loads anything (the load does not digest the files a second time)."""
    from neuronx_distributed_tpu_torch.scripts import reshard_checkpoint
    from neuronx_distributed_tpu_torch.trainer import checkpoint as tck

    src = str(tmp_path / "src")
    tck.save_checkpoint(src, 1, {"w": torch.arange(64.0).reshape(8, 8)},
                        async_save=False)
    shard = tmp_path / "src" / "1" / "state" / "shard_tp0_dp0.pt"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0x10
    shard.write_bytes(bytes(data))
    with pytest.raises(tck.CheckpointCorruptionError, match="corrupt"):
        reshard_checkpoint.main(["--input", src, "--tag", "1", "--output",
                                 str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()
