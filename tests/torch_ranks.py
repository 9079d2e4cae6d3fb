"""Rank functions for the port's multi-process tests. A spawned rank
imports this module by name, so it imports no JAX and nothing of the JAX
package: the JAX references are computed in the test process."""

from __future__ import annotations

from typing import Any, Dict, Optional

import sys

import numpy as np
import torch

JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "neuronx_distributed_tpu")


def jax_modules():
    """The modules of JAX or of the JAX package this process has
    imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def _layout(tp: int, zero1: bool = False, sp: bool = False,
            compute: str = "float32"):
    from neuronx_distributed_tpu_torch.config import (
        MixedPrecisionConfig, OptimizerConfig, neuronx_distributed_config)

    return neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=sp,
        optimizer_config=OptimizerConfig(zero_one_enabled=zero1),
        mixed_precision_config=MixedPrecisionConfig(compute_dtype=compute))


def train_steps(cfg, sd: Dict[str, torch.Tensor], batches, lr: float,
                tp: int, zero1: bool, sp: bool,
                grad_accum_steps: int = 1) -> Dict[str, Any]:
    """One update per global batch of ``batches`` through the public path
    at ``tp`` over the world: ``neuronx_distributed_config`` ->
    ``configure_model`` -> ``initialize_parallel_model`` ->
    ``initialize_parallel_optimizer`` -> ``make_train_step``; returns each
    step's metrics, this rank's coords, its moments' shapes and its
    parameters after the steps."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import configure_model
    from neuronx_distributed_tpu_torch.parallel import mesh

    ncfg = _layout(tp, zero1, sp)
    cfg = configure_model(ncfg, cfg)
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, state_dict=sd,
                                                   device="cpu")
    tx, state = trainer.initialize_parallel_optimizer(pm, params, lr)
    step = trainer.make_train_step(pm, tx, grad_accum_steps=grad_accum_steps)
    metrics = []
    for batch in batches:
        _, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "coords": mesh.coords(),
            "jax_modules": jax_modules(),
            "moments": [tuple(m.shape) for m in state.opt_state.mu],
            "params": {n: p.detach().clone() for n, p in params.items()}}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def mesh_and_comm(tp: int, ep: int, xs: np.ndarray) -> Dict[str, Any]:
    """The layout's getters, each collective of ``comm`` on this rank's row
    ``xs[rank]`` (``[world, 4, 6]``), the per-rank generators, and
    ``dp_consensus_fingerprints``, on one rank."""
    from neuronx_distributed_tpu_torch.parallel import comm
    from neuronx_distributed_tpu_torch.parallel import mesh as ps
    from neuronx_distributed_tpu_torch.parallel import random as prng
    from neuronx_distributed_tpu_torch.resilience import integrity

    ps.initialize_model_parallel(tensor_model_parallel_size=tp,
                                 expert_model_parallel_size=ep)
    r = _rank()
    x = torch.from_numpy(xs[r])
    tpn = ps.get_tensor_model_parallel_size()
    out = {
        "sizes": {a: ps.axis_size(a) for a in ("pp", "dp", "cp", "tp", "ep",
                                               "dp_exp")},
        "world": ps.get_world_size(), "coords": ps.coords(),
        "members": {a: ps.axis_members(a) for a in ("tp", "dp", "ep",
                                                    "dp_exp")},
        "zero1": ps.axis_members(ps.DATA_AXES),
        "replica_groups": {
            "tp": ps.get_tensor_model_parallel_replica_groups(),
            "dp": ps.get_data_parallel_replica_groups(),
            "ep": ps.get_expert_model_parallel_replica_groups(),
            "zero1": ps.get_zero1_sharding_replica_groups()},
        "all_reduce": comm.all_reduce(x),
        "all_reduce_max": comm.all_reduce(x, op="max"),
        "all_reduce_dp": comm.all_reduce(x, ps.DP_AXIS),
        "all_gather": comm.all_gather(x, dim=-1),
        "all_gather0": comm.all_gather(x, dim=0),
        "reduce_scatter": comm.reduce_scatter(
            torch.cat([x] * tpn, dim=1), dim=1),
        "all_to_all": comm.all_to_all(torch.cat([x] * tpn, dim=0), ps.TP_AXIS,
                                      0, 1),
        "ppermute": comm.ppermute(x, ps.TP_AXIS,
                                  [(i, (i + 1) % tpn) for i in range(tpn)]),
        "split": comm.split_along_dim(torch.cat([x] * tpn, dim=-1)),
        "staged": dict(comm.host_staged_bytes),
        "mp_rng": torch.randn(4, generator=prng.model_parallel_rng(7)),
        "dp_rng": torch.randn(4, generator=prng.data_parallel_rng(7)),
        "consensus": integrity.dp_consensus_fingerprints({"w": x}),
        "fingerprint": integrity.fingerprint_tree({"w": x}),
        "jax_modules": jax_modules(),
    }
    return out


def mappings_all(tp: int, cases: Dict[str, Any]) -> Dict[str, Any]:
    """Each mapping of ``mappings`` forward on this rank's input and
    backward from this rank's cotangent: ``{name: (y, dx)}``."""
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.parallel import mappings

    neuronx_distributed_config(tensor_parallel_size=tp)
    r = _rank()
    out = {}
    for name, (fn, kw, xs, cts) in cases.items():
        x = torch.from_numpy(xs[r]).requires_grad_(True)
        y = getattr(mappings, fn)(x, **kw)
        (y * torch.from_numpy(cts[r])).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def _port_layer(kind: str, kw: Dict[str, Any], tp: int):
    from neuronx_distributed_tpu_torch.parallel import layers

    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    if kind == "column":
        return layers.ColumnParallelLinear(tp_size=tp, **f32, **kw)
    if kind == "row":
        return layers.RowParallelLinear(tp_size=tp, **f32, **kw)
    if kind == "embed":
        return layers.ParallelEmbedding(tp_size=tp, **f32, **kw)
    if kind == "gqa":
        return layers.GQAQKVColumnParallelLinear(tp_size=tp, **f32, **kw)
    raise ValueError(kind)


def _port_call(kind, kw, tp, params, inputs):
    """``(outputs, differentiable inputs, parameters)`` of one case."""
    from neuronx_distributed_tpu_torch.parallel import layers
    from neuronx_distributed_tpu_torch.parallel import loss_functions as lf

    inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    for v in inputs.values():
        if v.is_floating_point():
            v.requires_grad_(True)
    if kind in ("column", "row", "embed", "gqa"):
        layer = _port_layer(kind, kw, tp)
        layer.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
        ys = layer(inputs["x"])
        named = dict(layer.named_parameters())
    else:
        named = {k: torch.from_numpy(v).requires_grad_(True)
                 for k, v in params.items()}
        if kind == "attend":
            ys = layers.embedding_attend(named["table"], inputs["x"],
                                         torch.float32, tp_size=tp, **kw)
        elif kind == "ce":
            ys = lf.parallel_cross_entropy(inputs["x"], inputs["labels"],
                                           **kw)
        elif kind == "logsoftmax":
            ys = lf.distributed_log_softmax(inputs["x"])
        elif kind == "fused":
            ys = lf.fused_linear_cross_entropy(
                inputs["x"], named["kernel"], inputs["labels"],
                dtype=torch.float32, **kw)
        else:
            raise ValueError(kind)
    ys = ys if isinstance(ys, tuple) else (ys,)
    return ys, inputs, named


def layers_all(tp: int, cases: Dict[str, Any]) -> Dict[str, Any]:
    """Each case's outputs, input gradients and parameter gradients on
    this rank, from its shards of the weights and its inputs and
    cotangents: ``{name: (ys, {input: grad}, {param: grad})}``."""
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)

    neuronx_distributed_config(tensor_parallel_size=tp)
    r = _rank()
    out = {}
    for name, (kind, kw, params, inputs, cts) in cases.items():
        ys, ins, named = _port_call(kind, kw, tp, params[r], inputs[r])
        loss = sum((y * torch.from_numpy(ct)).sum()
                   for y, ct in zip(ys, cts[r]))
        loss.backward()
        out[name] = ([y.detach() for y in ys],
                     {k: v.grad for k, v in ins.items() if v.requires_grad},
                     {k: v.grad for k, v in named.items()})
    return out


def operators_all(tp: int, x: np.ndarray, k: int) -> Dict[str, Any]:
    """``distributed_argmax`` and ``distributed_topk`` of this rank's
    vocab shard of ``x``."""
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.ops import operators
    from neuronx_distributed_tpu_torch.parallel import comm

    neuronx_distributed_config(tensor_parallel_size=tp)
    local = comm.split_along_dim(torch.from_numpy(x), dim=-1)
    return {"argmax": operators.distributed_argmax(local),
            "topk": operators.distributed_topk(local, k)}


def synced_grads_both(cfg, sd: Dict[str, torch.Tensor],
                      batch: Dict[str, Any], tp: int) -> Dict[bool, Any]:
    """:func:`synced_grads` without and with sequence parallelism."""
    return {sp: synced_grads(cfg, sd, batch, tp, sp) for sp in (False, True)}


def synced_grads(cfg, sd: Dict[str, torch.Tensor], batch: Dict[str, Any],
                 tp: int, sp: bool) -> Dict[str, Any]:
    """This rank's gradient shards after the backward of its rows and
    ``allreduce_gradients`` (the tp sum of the norms under sequence
    parallelism, the mean over the data ranks), and its coords."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import configure_model
    from neuronx_distributed_tpu_torch.parallel import grads, mesh

    ncfg = _layout(tp, False, sp)
    cfg = configure_model(ncfg, cfg)
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, state_dict=sd,
                                                   device="cpu")
    rows = mesh.data_slice(batch["input_ids"].shape[0])
    trainer.data_parallel_loss(pm.module, {k: torch.as_tensor(v[rows])
                                           for k, v in batch.items()}
                               ).backward()
    synced = grads.allreduce_gradients(
        {n: p.grad for n, p in params.items()}, pm.specs,
        sequence_parallel_names=pm.sequence_parallel_names)
    return {"coords": mesh.coords(), "grads": synced,
            "norm": grads.global_grad_norm(synced, pm.specs),
            "sp_names": pm.sequence_parallel_names}


def refusals_across_ranks(cfg, tmp: str) -> Dict[str, str]:
    """What stays out at a world above 1, each refusal's message: the
    other model families, serving a Llama or a Mixtral at tp > 1 or a
    Mixtral at ep > 1, a quantized expert bank at tp > 1, and a model
    config at another tp_size."""
    import dataclasses

    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.models import gpt_neox, llama, mixtral
    from neuronx_distributed_tpu_torch.modules.moe import MoE

    ncfg = _layout(2)
    moe = mixtral.tiny_moe_config(dtype=torch.float32, num_layers=1)
    tries = {
        "gpt_neox": lambda: trainer.initialize_parallel_model(
            ncfg, gpt_neox.tiny_neox_config(), device="cpu"),
        "serving": lambda: llama.build_model(
            dataclasses.replace(cfg, tp_size=2), {}, "cpu"),
        "serving_mixtral": lambda: mixtral.build_model(
            dataclasses.replace(moe, tp_size=2), {}, "cpu"),
        "quantized_bank": lambda: MoE(4, 16, 32, expert_impl="int8",
                                      tp_size=2, device="meta"),
        "tp_size": lambda: trainer.initialize_parallel_model(
            ncfg, dataclasses.replace(cfg, tp_size=1), device="cpu"),
        # the Sinkhorn router across data ranks runs
        # (tests/test_torch_mixtral_ep.py); serving at ep > 1 stays out
        "serving_mixtral_ep": lambda: mixtral.build_model(
            dataclasses.replace(moe, ep_size=2), {}, "cpu"),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)
    return out


def train_variants(cfgs, sds, batches, lr: float, tp: int) -> Any:
    """``train_steps`` at ``tp`` with sequence parallelism and ZeRO-1 for
    each config of ``cfgs`` in turn (one world, one layout per config)."""
    return [train_steps(cfg, sd, batches, lr, tp, True, True)["metrics"]
            for cfg, sd in zip(cfgs, sds)]


# ---------------------------------------------------------------------------
# the Trainer loop, sharded checkpoints, integrity and dropout across ranks
# ---------------------------------------------------------------------------

def _loop_parts(cfg, sd, tp: int, zero1: bool = True, sp: bool = True,
                lr: float = 1e-3, **step_kw):
    """``(pm, state, step)`` of the public path at ``tp`` over the world,
    from the whole weights ``sd``."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import configure_model

    ncfg = _layout(tp, zero1, sp)
    pm, params = trainer.initialize_parallel_model(
        ncfg, configure_model(ncfg, cfg), state_dict=sd, device="cpu")
    tx, state = trainer.initialize_parallel_optimizer(pm, params, lr)
    return pm, state, trainer.make_train_step(pm, tx, **step_kw)


class _Record:
    """A callback logging each step's loss, grad norm and the integrity
    fingerprint when the step reports one (duck-typed)."""

    def __init__(self, fingerprints: bool = False):
        self.metrics, self.fps, self.live = [], {}, {}
        self.fingerprints = fingerprints

    def on_train_start(self, trainer): ...

    def on_eval_end(self, trainer, metrics): ...

    def on_train_end(self, trainer): ...

    def on_step_end(self, trainer, metrics):
        self.metrics.append((metrics["loss"].item(),
                             metrics["grad_norm"].item()))
        if "integrity_fp" in metrics:
            self.fps[trainer.host_step] = metrics["integrity_fp"].clone()
        if self.fingerprints:
            self.live[trainer.host_step] = trainer.step_fn.fingerprint(
                trainer.state.params)


def _params(state) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in state.params.items()}


def _bitflip_plan_on(rank_coords, want):
    from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan

    if all(rank_coords[k] == v for k, v in want.items()):
        return FaultPlan.parse(
            "seed=5; integrity|params : bitflip, after=1, times=1")
    return None


def loop_world(cfg, sd: Dict[str, torch.Tensor], batches, tmp: str,
               drop_cfg, drop_seed: int) -> Dict[str, Any]:
    """One world of four ranks for ``tests/test_torch_trainer_loop_tp.py``,
    each part at its own layout of the same ranks:

    * ``fit``: ``Trainer.fit`` at tp=2 x dp=2 (sequence parallel, ZeRO-1,
      ``integrity_every=2`` with an ``IntegrityMonitor``) over ``batches``,
      async sharded checkpoints every 2 steps into ``tmp/a``;
    * ``same``: a fresh state at the same layout loads tag 2 and trains
      steps 3-4; ``tp4``: the same at tp=4 x dp=1 without ZeRO-1;
    * ``corrupt``: a byte of one rank file of tag 4 flipped: auto-resume
      falls back to tag 2 on every rank, an explicit load of tag 4 raises;
    * ``drill``: the bit-flip drill, a bit flipped in data rank 1's shard
      at the step-4 boundary, the monitor's watchdog rewinding;
    * ``sigterm``: SIGTERM to rank 3 at step 3: every rank saves tag 3 and
      stops; a fresh state resumes from it and trains step 4;
    * ``dropout``: three steps of ``drop_cfg`` with a dropout generator
      seeded ``drop_seed``; ``masks``: this rank's keep mask;
    * ``restore``: the reference's ``test_sharded_save_resharded_restore``,
      a tensor saved at tp=4 along dim 1, loaded at tp=2 along dim 0; and
      the one-process tag ``tmp/one`` loaded the same way."""
    import os
    import signal

    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.modules.attention import (
        rank_dropout_offsets)
    from neuronx_distributed_tpu_torch.ops.flash_attention import (
        dropout_keep_mask, flat_bh)
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        IntegrityMonitor)
    from neuronx_distributed_tpu_torch.resilience.preemption import (
        PreemptionGuard, TrainingPreempted)
    from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog
    from neuronx_distributed_tpu_torch.trainer import checkpoint as ck
    from neuronx_distributed_tpu_torch.trainer import loop

    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    a = os.path.join(tmp, "a")
    # fit
    pm, state, step = _loop_parts(cfg, sd, 2, integrity_every=2)
    rec = _Record()
    monitor = IntegrityMonitor(every=2)
    loop.Trainer(step, state, callbacks=[
        rec, loop.CheckpointCallback(a, every=2, num_kept=3),
        monitor]).fit(iter(batches), max_steps=4)
    out["fit"] = dict(metrics=rec.metrics, fps=rec.fps,
                      coords=mesh.coords(), params=_params(state),
                      checks=monitor.checks, mismatches=monitor.mismatches,
                      tags=ck.list_complete_tags(a),
                      moments=[tuple(m.shape) for m in state.opt_state.mu])
    # resume at the same layout, and at tp=4
    for name, tp, zero1 in (("same", 2, True), ("tp4", 4, False)):
        pm, state, step = _loop_parts(cfg, sd, tp, zero1=zero1)
        ck.load_checkpoint(a, tag="2", target=state)
        rec = _Record()
        loop.Trainer(step, state, callbacks=[rec]).fit(
            iter(batches[2:]), max_steps=4)
        out[name] = dict(metrics=rec.metrics, coords=mesh.coords(),
                         params=_params(state), step=state.step)
    # a corrupt rank file: the whole tag fails on every rank
    pm, state, step = _loop_parts(cfg, sd, 2)
    if dist.get_rank() == 0:
        shard = os.path.join(a, "4", "state", "shard_tp1_dp1.pt")
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x10]))
    dist.barrier()
    ck.load_checkpoint(a, tag=None, target=state)
    try:
        ck.load_checkpoint(a, tag="4", target=state)
        explicit = "loaded"
    except ck.CheckpointCorruptionError as e:
        explicit = str(e)
    out["corrupt"] = dict(step=state.step, explicit=explicit)
    # the bit-flip drill
    b = os.path.join(tmp, "b")
    pm, state, step = _loop_parts(cfg, sd, 2, integrity_every=2)
    rec = _Record(fingerprints=True)
    watchdog = Watchdog(policy="rewind", checkpoint_path=b)
    monitor = IntegrityMonitor(every=2, watchdog=watchdog,
                               chaos=_bitflip_plan_on(mesh.coords(),
                                                      {"dp": 1, "tp": 0}))
    trainer = loop.Trainer(step, state, callbacks=[
        rec, loop.CheckpointCallback(b, every=2), monitor])
    trainer.fit(iter(batches), max_steps=4)
    out["drill"] = dict(flips=monitor.flips_injected,
                        mismatches=monitor.mismatches,
                        checks=monitor.checks, rewinds=watchdog.anomalies,
                        divergent=monitor.divergent_replicas,
                        host_step=trainer.host_step,
                        rewound=step.fingerprint(state.params),
                        step4=rec.live[4])
    # SIGTERM to one rank
    c = os.path.join(tmp, "c")
    pm, state, step = _loop_parts(cfg, sd, 2)

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
    pm, state, step = _loop_parts(cfg, sd, 2)
    resumed = loop.Trainer(step, state, resume_path=c)
    start = resumed.host_step
    resumed.fit(iter(batches[start:]), max_steps=4)
    out["sigterm"] = dict(preempted=preempted, tags=ck.list_complete_tags(c),
                          resumed_at=start, params=_params(state))
    # dropout at global coordinates
    pm, state, step = _loop_parts(
        drop_cfg, sd, 2,
        dropout_generator=torch.Generator().manual_seed(drop_seed))
    rec = _Record()
    loop.Trainer(step, state, callbacks=[rec]).fit(iter(batches[:3]))
    offsets = rank_dropout_offsets(2, 2, 4)
    s = 16
    out["dropout"] = dict(metrics=rec.metrics, coords=mesh.coords(),
                          offsets=offsets, mask=dropout_keep_mask(
                              drop_seed, flat_bh(2, 2, offsets=offsets),
                              torch.arange(s)[:, None],
                              torch.arange(s)[None, :], s, 0.3))
    # saved at tp=4 along dim 1, restored at tp=2 along dim 0
    d = os.path.join(tmp, "d")
    _layout(4)
    r = mesh.axis_rank(mesh.TP_AXIS)
    whole = torch.arange(32.0).reshape(8, 4)
    ck.save_checkpoint(d, 1, {"w": whole[:, r:r + 1].contiguous()},
                       async_save=False, specs={"w": (None, "tp")})
    _layout(2)
    target = {"w": torch.zeros(4, 4)}
    ck.load_checkpoint(d, 1, target=target, specs={"w": ("tp", None)})
    # a tag one process saved, loaded at tp=2 along dim 0 as well
    one = {"w": torch.zeros(4, 4)}
    ck.load_checkpoint(os.path.join(tmp, "one"), 1, target=one,
                       specs={"w": ("tp", None)})
    out["restore"] = dict(w=target["w"], one=one["w"], coords=mesh.coords())
    return out


# ---------------------------------------------------------------------------
# Mixtral across ranks
# ---------------------------------------------------------------------------

def mixtral_world(cases, batches, lr: float = 1e-3) -> Dict[str, Any]:
    """For each ``(name, cfg, sd)`` of ``cases`` at tp=2 x dp=2 with
    sequence parallelism and ZeRO-1 (one layout after another in one
    world): two updates over ``batches`` (metrics, this rank's params),
    then on fresh weights the router's aux losses of the first batch (the
    model's forward) and the synchronised gradients of its default loss
    (``data_parallel_loss``, then ``allreduce_gradients``)."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.parallel import grads, mesh

    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    for name, cfg, sd in cases:
        pm, state, step = _loop_parts(cfg, sd, 2, lr=lr)
        metrics = [tuple(v.item() for v in (m["loss"], m["grad_norm"]))
                   for m in (step(state, b)[1] for b in batches)]
        res = dict(metrics=metrics, coords=mesh.coords(),
                   params=_params(state),
                   moments=[tuple(m.shape) for m in state.opt_state.mu])
        pm, state, _ = _loop_parts(cfg, sd, 2, lr=lr)
        batch = {k: torch.as_tensor(v) for k, v in batches[0].items()}
        rows = {k: v[mesh.data_slice(v.shape[0])] for k, v in batch.items()}
        with torch.no_grad():
            _, res["aux"] = pm.module(rows["input_ids"])
        trainer.data_parallel_loss(pm.module, rows).backward()
        named = dict(pm.module.named_parameters())
        res["grads"] = grads.allreduce_gradients(
            {n: p.grad for n, p in named.items()}, pm.specs,
            sequence_parallel_names=pm.sequence_parallel_names)
        res["sp_names"] = pm.sequence_parallel_names
        out[name] = res
    return out
