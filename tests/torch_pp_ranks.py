"""Rank functions for the port's pipeline-parallel tests. A spawned rank
imports this module by name, so it imports no JAX and nothing of the JAX
package: the JAX references are computed in the test process."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torch_ranks import jax_modules


def pp_layout(tp: int, pp: int, sp: bool = False, zero1: bool = False,
              compute: str = "float32", num_microbatches: int = 1,
              schedule: str = "1f1b", remat: bool = False):
    """``neuronx_distributed_config`` at ``pp`` x ``tp`` over the world."""
    from neuronx_distributed_tpu_torch.config import (
        ActivationCheckpointConfig, MixedPrecisionConfig, OptimizerConfig,
        PipelineConfig, neuronx_distributed_config)

    return neuronx_distributed_config(
        tensor_parallel_size=tp, pipeline_parallel_size=pp,
        sequence_parallel=sp,
        activation_checkpoint_config=ActivationCheckpointConfig(
            mode="full" if remat else "none"),
        pipeline_config=PipelineConfig(num_microbatches=num_microbatches,
                                       schedule=schedule),
        optimizer_config=OptimizerConfig(zero_one_enabled=zero1),
        mixed_precision_config=MixedPrecisionConfig(compute_dtype=compute))


def stage_model(cfg, sd, tp: int, pp: int, sp: bool = False,
                zero1: bool = False, vocab_pp: bool = False,
                remat: bool = False):
    """``(pm, params)`` of this rank's stage through the public path."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import configure_model

    ncfg = pp_layout(tp, pp, sp, zero1, remat=remat)
    return trainer.initialize_parallel_model(
        ncfg, configure_model(ncfg, cfg), state_dict=sd, device="cpu",
        vocab_pp=vocab_pp)


def grads_world(cases: List[Dict[str, Any]], batch: Dict[str, Any]
                ) -> Dict[str, Any]:
    """For each case (``name``, ``cfg``, ``sd``, ``tp``, ``pp``, ``sp``,
    ``schedule``, ``chunks``, ``M``, ``vocab_pp``), one layout after
    another in one world: this rank's loss and gradients of one call of
    the pipeline grad function on ``batch``, its coords and the
    executor's stats."""
    from neuronx_distributed_tpu_torch.models import llama_pipeline as lpp
    from neuronx_distributed_tpu_torch.parallel import mesh

    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    for case in cases:
        pm, params = stage_model(case["cfg"], case["sd"], case["tp"],
                                 case["pp"], case.get("sp", False),
                                 vocab_pp=case.get("vocab_pp", False))
        gf = lpp.make_pipeline_grad_fn(
            pm.module.cfg, case["M"], pm, schedule=case["schedule"],
            num_chunks=case.get("chunks", 1),
            vocab_pp=case.get("vocab_pp", False))
        loss, grads = gf(params, case.get("batch", batch))
        out[case["name"]] = dict(
            loss=loss.item(), grads={n: g.clone() for n, g in grads.items()},
            coords=mesh.coords(), specs=dict(pm.specs),
            stats=dict(gf.last_stats))
        if case.get("eval"):
            out[case["name"]]["eval"] = lpp.make_pipeline_eval_fn(
                pm.module.cfg, case["M"], pm)(params, batch).item()
    return out


def live_graphs_world(cfg, sd, layouts, Ms, batches) -> Dict[str, Any]:
    """For each ``(tp, pp)`` of ``layouts`` and each M of ``Ms``, the 1F1B
    executor's stats on this rank (``max_live`` graphs, ticks) over the
    batch of ``batches[M]``."""
    from neuronx_distributed_tpu_torch.models import llama_pipeline as lpp
    from neuronx_distributed_tpu_torch.parallel import mesh

    out: Dict[str, Any] = {}
    for tp, pp in layouts:
        pm, params = stage_model(cfg, sd, tp, pp)
        for M in Ms:
            gf = lpp.make_pipeline_grad_fn(pm.module.cfg, M, pm,
                                           schedule="1f1b")
            gf(params, batches[M])
            out[(tp, pp, M)] = dict(stats=dict(gf.last_stats),
                                    stage=mesh.axis_rank(mesh.PP_AXIS))
    return out


def dropout_world(cfg, sd, batch, seed: int) -> Dict[str, Any]:
    """Attention dropout under 1F1B at pp=2 x tp=2 with sequence
    parallelism: this rank's gradients with remat and without (the same
    seed and step), at another ``dropout_step``, at dropout 0, and the
    error GPipe raises."""
    import dataclasses

    from neuronx_distributed_tpu_torch.models import llama_pipeline as lpp

    out: Dict[str, Any] = {}
    for name, remat, c, step in (("remat", True, cfg, 0),
                                 ("plain", False, cfg, 0),
                                 ("step1", False, cfg, 1),
                                 ("nodrop", False, dataclasses.replace(
                                     cfg, attention_dropout=0.0), 0)):
        pm, params = stage_model(c, sd, 2, 2, sp=True, remat=remat)
        gf = lpp.make_pipeline_grad_fn(pm.module.cfg, 2, pm,
                                       schedule="1f1b", dropout_seed=seed)
        loss, grads = gf(params, dict(batch, dropout_step=step))
        out[name] = dict(loss=loss.item(), grads=grads)
    try:
        lpp.make_pipeline_grad_fn(cfg, 2, pm, schedule="gpipe")
        out["gpipe"] = "no error"
    except ValueError as e:
        out["gpipe"] = str(e)
    return out


def moe_grads_world(cases: List[Dict[str, Any]], batch: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """:func:`grads_world` for Mixtral cases, through
    ``mixtral_pipeline.make_moe_pipeline_grad_fn`` (GPipe) and
    ``make_moe_1f1b_grad_fn``."""
    from neuronx_distributed_tpu_torch.models import mixtral_pipeline as mpp
    from neuronx_distributed_tpu_torch.parallel import mesh

    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    for case in cases:
        pm, params = stage_model(case["cfg"], case["sd"], case["tp"],
                                 case["pp"], case.get("sp", False))
        cfg = pm.module.cfg
        gf = (mpp.make_moe_pipeline_grad_fn(cfg, case["M"], pm)
              if case["schedule"] == "gpipe" else
              mpp.make_moe_1f1b_grad_fn(cfg, case["M"], pm,
                                        num_chunks=case.get("chunks", 1)))
        loss, grads = gf(params, batch)
        out[case["name"]] = dict(
            loss=loss.item(), grads={n: g.clone() for n, g in grads.items()},
            coords=mesh.coords(), specs=dict(pm.specs),
            stats=dict(gf.last_stats))
    return out


# ---------------------------------------------------------------------------
# the train step, the Trainer loop and checkpoints at pp > 1
# ---------------------------------------------------------------------------

def pp_parts(cfg, sd, tp: int, pp: int, M: int = 4, sp: bool = True,
             zero1: bool = False, lr: float = 1e-3, schedule: str = "1f1b",
             **step_kw):
    """``(pm, state, step)`` of the public path at ``pp`` x ``tp`` over
    the world: the stage's model, AdamW, and ``make_train_step`` over the
    pipeline grad function (at ``pp = 1`` the default loss)."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.models import llama_pipeline as lpp

    pm, params = stage_model(cfg, sd, tp, pp, sp=sp, zero1=zero1)
    tx, state = trainer.initialize_parallel_optimizer(pm, params, lr)
    if pp > 1:
        step_kw["grad_fn"] = lpp.make_pipeline_grad_fn(
            pm.module.cfg, M, pm, schedule=schedule)
    return pm, state, trainer.make_train_step(pm, tx, **step_kw)


def pp_step_world(cfg, sd, batches, lr: float) -> Dict[str, Any]:
    """Two AdamW updates of ``make_train_step(grad_fn=)`` at pp=2 x tp=2 x
    dp=2 with sequence parallelism and ZeRO-1: metrics, this rank's
    params and moments' shapes."""
    from torch_ranks import _params
    from neuronx_distributed_tpu_torch.parallel import mesh

    pm, state, step = pp_parts(cfg, sd, 2, 2, M=2, zero1=True, lr=lr)
    metrics = []
    for b in batches:
        _, m = step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "coords": mesh.coords(),
            "params": _params(state), "jax_modules": jax_modules(),
            "moments": {n: tuple(m.shape) for n, m in zip(
                [n for n, p in state.params.items() if p.requires_grad],
                state.opt_state.mu)}}


def pp_loop_world(cfg, sd, batches, tmp: str) -> Dict[str, Any]:
    """One world of four ranks for ``tests/test_torch_trainer_loop_pp.py``,
    each part at its own layout of the same ranks:

    * ``fit``: ``Trainer.fit`` at pp=2 x tp=2 (sequence parallel, 1F1B,
      ``integrity_every=2`` with an ``IntegrityMonitor``), sharded
      checkpoints every 2 steps into ``tmp/a``;
    * ``same`` / ``tp2dp2`` / ``tp1`` / ``pp4``: a fresh state at that
      layout loads tag 2 of ``tmp/a`` and trains steps 3-4;
    * ``from_tp``: tp=2 x dp=2 fits steps 1-2 into ``tmp/t``; a fresh
      pp=2 x tp=2 state loads its tag 2 and trains steps 3-4;
    * ``resharded``: ``reshard_checkpoint`` (on rank 0) writes tag 4 of
      ``tmp/a`` at pp=2 x tp=2 into ``tmp/r``; a fresh pp=2 x tp=2 state
      loads it;
    * ``drill``: a bit flipped in stage 1's tp rank 0 at the step-4
      boundary, the monitor's watchdog rewinding every rank to tag 2;
    * ``sigterm``: SIGTERM to rank 3 (stage 1) at step 3: every rank saves
      tag 3 and stops; a fresh state resumes from it and trains step 4."""
    import os
    import signal

    import torch.distributed as dist

    from torch_ranks import _Record, _bitflip_plan_on, _params
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        IntegrityMonitor)
    from neuronx_distributed_tpu_torch.resilience.preemption import (
        PreemptionGuard, TrainingPreempted)
    from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog
    from neuronx_distributed_tpu_torch.scripts import reshard_checkpoint
    from neuronx_distributed_tpu_torch.trainer import checkpoint as ck
    from neuronx_distributed_tpu_torch.trainer import loop

    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    a = os.path.join(tmp, "a")
    pm, state, step = pp_parts(cfg, sd, 2, 2, integrity_every=2)
    rec = _Record()
    monitor = IntegrityMonitor(every=2)
    loop.Trainer(step, state, callbacks=[
        rec, loop.CheckpointCallback(a, every=2), monitor]).fit(
            iter(batches), max_steps=4)
    out["fit"] = dict(metrics=rec.metrics, fps=rec.fps,
                      coords=mesh.coords(), params=_params(state),
                      checks=monitor.checks, mismatches=monitor.mismatches,
                      tags=ck.list_complete_tags(a),
                      files=sorted(os.listdir(os.path.join(a, "2",
                                                           "state"))))
    for name, tp, pp in (("same", 2, 2), ("tp2dp2", 2, 1), ("tp1", 1, 1),
                         ("pp4", 1, 4)):
        pm, state, step = pp_parts(cfg, sd, tp, pp, sp=tp > 1)
        ck.load_checkpoint(a, tag="2", target=state)
        rec = _Record()
        loop.Trainer(step, state, callbacks=[rec]).fit(
            iter(batches[2:]), max_steps=4)
        out[name] = dict(metrics=rec.metrics, coords=mesh.coords(),
                         params=_params(state), step=state.step)
    # a tp=2 x dp=2 tag resumed at pp=2 x tp=2
    t = os.path.join(tmp, "t")
    pm, state, step = pp_parts(cfg, sd, 2, 1)
    loop.Trainer(step, state, callbacks=[
        loop.CheckpointCallback(t, every=2)]).fit(iter(batches[:2]))
    pm, state, step = pp_parts(cfg, sd, 2, 2)
    ck.load_checkpoint(t, tag="2", target=state)
    rec = _Record()
    loop.Trainer(step, state, callbacks=[rec]).fit(iter(batches[2:]),
                                                   max_steps=4)
    out["from_tp"] = dict(metrics=rec.metrics, params=_params(state))
    # reshard_checkpoint writes a pp layout
    r = os.path.join(tmp, "r")
    # the script runs on one rank: outside the layout, so that it runs
    # no collective the other ranks would not join
    mesh.destroy_model_parallel()
    if dist.get_rank() == 0:
        reshard_checkpoint.main(["--input", a, "--tag", "4", "--output", r,
                                 "--tp", "2", "--pp", "2", "--device",
                                 "cpu"])
    dist.barrier()
    pm, state, step = pp_parts(cfg, sd, 2, 2)
    ck.load_checkpoint(r, tag="4", target=state)
    out["resharded"] = dict(params=_params(state), step=state.step,
                            files=sorted(os.listdir(os.path.join(
                                r, "4", "state"))),
                            mu=[m.clone() for m in state.opt_state.mu])
    pm, state, step = pp_parts(cfg, sd, 2, 2)
    ck.load_checkpoint(a, tag="4", target=state)
    out["tag4"] = dict(mu=[m.clone() for m in state.opt_state.mu])
    # the bit-flip drill on stage 1
    b = os.path.join(tmp, "b")
    pm, state, step = pp_parts(cfg, sd, 2, 2, integrity_every=2)
    rec = _Record(fingerprints=True)
    watchdog = Watchdog(policy="rewind", checkpoint_path=b)
    monitor = IntegrityMonitor(every=2, watchdog=watchdog,
                               chaos=_bitflip_plan_on(mesh.coords(),
                                                      {"pp": 1, "tp": 0}))
    trainer = loop.Trainer(step, state, callbacks=[
        rec, loop.CheckpointCallback(b, every=2), monitor])
    trainer.fit(iter(batches), max_steps=4)
    out["drill"] = dict(flips=monitor.flips_injected,
                        mismatches=monitor.mismatches,
                        checks=monitor.checks, rewinds=watchdog.anomalies,
                        host_step=trainer.host_step,
                        rewound=step.fingerprint(state.params),
                        step4=rec.live[4])
    # SIGTERM to a rank of the last stage
    c = os.path.join(tmp, "c")
    pm, state, step = pp_parts(cfg, sd, 2, 2)

    class Kill:
        def on_train_start(self, trainer): ...

        def on_eval_end(self, trainer, metrics): ...

        def on_train_end(self, trainer): ...

        def on_step_end(self, trainer, metrics):
            if trainer.host_step == 3 and dist.get_rank() == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    guard = PreemptionGuard(grace_s=60.0)
    try:
        loop.Trainer(step, state, callbacks=[
            loop.CheckpointCallback(c, every=100), Kill()],
            preemption_guard=guard).fit(iter(batches), max_steps=4)
        preempted = None
    except TrainingPreempted as e:
        preempted = (e.step, e.saved_tag, e.code)
    finally:
        guard.uninstall()
    pm, state, step = pp_parts(cfg, sd, 2, 2)
    resumed = loop.Trainer(step, state, resume_path=c)
    start = resumed.host_step
    resumed.fit(iter(batches[start:]), max_steps=4)
    out["sigterm"] = dict(preempted=preempted, tags=ck.list_complete_tags(c),
                          resumed_at=start, params=_params(state))
    return out
