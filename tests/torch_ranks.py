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
    ``Trainer`` loop, checkpoints, ``integrity_every``, dropout, Mixtral,
    serving at tp > 1, and a model config at another tp_size."""
    import dataclasses

    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.models import llama, mixtral
    from neuronx_distributed_tpu_torch.trainer import checkpoint, loop

    ncfg = _layout(2)
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, device="cpu")
    tx, state = trainer.initialize_parallel_optimizer(pm, params)
    step = trainer.make_train_step(pm, tx)
    tries = {
        "trainer": lambda: loop.Trainer(step, state),
        "save": lambda: checkpoint.save_checkpoint(tmp, 0, state),
        "load": lambda: checkpoint.load_checkpoint(tmp),
        "integrity": lambda: trainer.make_train_step(pm, tx,
                                                     integrity_every=2),
        "dropout": lambda: trainer.make_train_step(
            pm, tx, dropout_generator=torch.Generator()),
        "mixtral": lambda: trainer.initialize_parallel_model(
            ncfg, mixtral.tiny_moe_config(), device="cpu"),
        "serving": lambda: llama.build_model(
            dataclasses.replace(cfg, tp_size=2), {}, "cpu"),
        "tp_size": lambda: trainer.initialize_parallel_model(
            ncfg, dataclasses.replace(cfg, tp_size=1), device="cpu"),
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
