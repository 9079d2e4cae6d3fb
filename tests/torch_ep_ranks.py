"""Rank functions for the port's expert-parallel tests
(``tests/test_torch_ep_dispatch.py``, ``tests/test_torch_mixtral_ep.py``,
``tests/test_torch_mixtral_ep_step.py``,
``tests/test_torch_trainer_loop_ep.py``). A spawned rank imports this
module by name, so it imports no JAX and nothing of the JAX package: the
JAX references are computed in the test process."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from torch_ranks import jax_modules


def _layout(tp: int, ep: int, zero1: bool = False, sp: bool = False):
    from neuronx_distributed_tpu_torch.config import (
        MixedPrecisionConfig, OptimizerConfig, neuronx_distributed_config)

    return neuronx_distributed_config(
        tensor_parallel_size=tp, expert_parallel_size=ep,
        sequence_parallel=sp,
        optimizer_config=OptimizerConfig(zero_one_enabled=zero1),
        mixed_precision_config=MixedPrecisionConfig(compute_dtype="float32"))


def _rows(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's rows of ``x``'s first dim sharded over ``axis``."""
    from neuronx_distributed_tpu_torch.parallel import comm

    n = x.shape[0] // comm.axis_size(axis)
    i = comm.combined_axis_index(axis)
    return x[i * n:(i + 1) * n].clone()


# ---------------------------------------------------------------------------
# tests/test_torch_ep_dispatch.py
# ---------------------------------------------------------------------------

def _bank(kw, gate_up, down, tp: int, ep: int):
    """An expert bank at this rank's coords with the whole ``gate_up`` /
    ``down`` cut to its shards."""
    from neuronx_distributed_tpu_torch.models import convert
    from neuronx_distributed_tpu_torch.modules.moe import ExpertMLPs
    from neuronx_distributed_tpu_torch.parallel import mesh

    m = ExpertMLPs(dtype=torch.float32, tp_size=tp, ep_size=ep, device="cpu",
                   **kw)
    sizes = {"tp": tp, "ep": ep}
    coords = {"tp": mesh.axis_rank("tp"), "ep": mesh.axis_rank("ep")}
    spec_gu = ("ep", None, None, "tp")
    spec_dn = ("ep", "tp", None)
    with torch.no_grad():
        m.gate_up.copy_(convert.shard_tensor("gate_up", torch.as_tensor(
            gate_up), spec_gu, sizes, coords))
        m.down.copy_(convert.shard_tensor("down", torch.as_tensor(down),
                                          spec_dn, sizes, coords))
    return m


def bank_outputs(m, x, gates, idx, loss: str = "tanh") -> Dict[str, Any]:
    """The bank's forward on this rank's tokens and the gradients of its
    local loss (``sum(tanh(y))`` or ``sum(y**2)``): the bank's
    parameters', the tokens' and the gates'."""
    x = x.clone().requires_grad_(True)
    gates = gates.clone().requires_grad_(True)
    m.zero_grad(set_to_none=True)
    y, aux = m(x, gates, idx)
    (torch.tanh(y) if loss == "tanh" else y ** 2).sum().backward()
    return dict(y=y.detach().clone(), gate_up=m.gate_up.grad.clone(),
                down=m.down.grad.clone(), x=x.grad.clone(),
                gates=gates.grad.clone(),
                dropped=float(aux["dropped_fraction"]))


def dispatch_world(x: np.ndarray, ys: np.ndarray, gx: np.ndarray,
                   gy: np.ndarray, mlp: Dict[str, Any]) -> Dict[str, Any]:
    """At ep=4 over the four ranks (tp=1 x dp=4): for each wire (fp32,
    int8, fp8) and each form (ring, monolithic) the chunks
    ``gather_token_chunks`` gives of this rank's rows of ``x`` and the
    shard ``combine_token_chunks`` gives of this rank's partials ``ys[:,
    rows]``, with both backwards (the losses ``sum_t <chunk_t, gx[t,
    rows]>`` and ``<combined, gy[rows]>``, whose cotangents are exact in
    both packages); the raw collectives they
    replace at fp32; ``overlap_engaged``; the wire-byte counters; and the
    blockwise bank of ``mlp`` at each wire and form: output and every
    gradient."""
    from neuronx_distributed_tpu_torch.obs import metrics as om
    from neuronx_distributed_tpu_torch.parallel import comm
    from neuronx_distributed_tpu_torch.parallel import ep_dispatch as epd
    from neuronx_distributed_tpu_torch.parallel import mesh

    _layout(1, 4)
    n = 4
    me = mesh.get_expert_model_parallel_rank()
    xl = _rows(torch.from_numpy(x), "ep")
    rows = slice(me * xl.shape[0], (me + 1) * xl.shape[0])
    ysl = torch.from_numpy(ys)[:, rows]
    gxl, gyl = torch.from_numpy(gx)[:, rows], torch.from_numpy(gy)[rows]
    out: Dict[str, Any] = {"jax_modules": jax_modules(), "me": me}
    reg = om.get_registry()
    reg.reset()
    reg.enable()
    try:
        for wire_name in ("fp32", "int8", "fp8"):
            wire = epd.wire_config(wire_name)
            for ring in (True, False):
                comm.collective_bytes.clear()
                chunks = epd.gather_token_chunks(xl, wire=wire, overlap=ring)
                moved = dict(comm.collective_bytes)
                y = epd.combine_token_chunks([ysl[t] for t in range(n)],
                                             wire=wire, overlap=ring)
                xg = xl.clone().requires_grad_(True)
                cs = epd.gather_token_chunks(xg, wire=wire, overlap=ring)
                sum((c * gxl[t]).sum() for t, c in enumerate(cs)).backward()
                yg = ysl.clone().requires_grad_(True)
                (epd.combine_token_chunks(
                    [yg[t] for t in range(n)], wire=wire,
                    overlap=ring) * gyl).sum().backward()
                out[(wire_name, ring)] = dict(
                    chunks=[c.detach().clone() for c in chunks],
                    combined=y.detach().clone(), dx=xg.grad.clone(),
                    dys=yg.grad.clone(), gather_bytes=moved)
        out["wire_bytes"] = {
            (s["labels"]["collective"], s["labels"]["dtype"]): s["value"]
            for s in reg.snapshot()["nxd_wire_bytes_total"]["samples"]}
    finally:
        reg.disable()
    t = xl.shape[0]
    ag = comm.all_gather(xl, "ep", 0).reshape((n, t) + tuple(xl.shape[1:]))
    out["all_gather"] = [ag[(me + i) % n].clone() for i in range(n)]
    dest = torch.roll(ysl, me, 0).reshape((n * t,) + tuple(ysl.shape[2:]))
    out["reduce_scatter"] = comm.reduce_scatter(dest, "ep", 0)
    out["engaged"] = {k: epd.overlap_engaged(k, "ep")
                      for k in (None, True, False)}
    # the layer: the blockwise bank over the dispatch module
    xs, gates, idx = (torch.from_numpy(mlp[k]) for k in ("x", "gates",
                                                          "idx"))
    bank = {}
    for wire_name in ("fp32", "int8"):
        for ring in (True, False):
            m = _bank(dict(mlp["kw"], ep_wire_dtype=wire_name,
                           ep_overlap=ring), mlp["gate_up"], mlp["down"],
                      1, n)
            bank[(wire_name, ring)] = bank_outputs(
                m, _rows(xs, "ep"), _rows(gates, "ep"), _rows(idx, "ep"))
    out["bank"] = bank
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_mixtral_ep.py
# ---------------------------------------------------------------------------

def _train(cfg, sd, batches, lr: float, tp: int, ep: int, zero1: bool,
           sp: bool) -> Dict[str, Any]:
    """The public path at tp x ep over the world, one update per global
    batch: metrics, coords, the moments' shapes, this rank's parameters
    and their specs; then, on fresh weights, the synchronised gradients of
    the first batch's default loss (``data_parallel_loss``, then
    ``allreduce_gradients``)."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import configure_model
    from neuronx_distributed_tpu_torch.parallel import grads, mesh

    ncfg = _layout(tp, ep, zero1, sp)
    pm, params = trainer.initialize_parallel_model(
        ncfg, configure_model(ncfg, cfg), state_dict=sd, device="cpu")
    tx, state = trainer.initialize_parallel_optimizer(pm, params, lr)
    step = trainer.make_train_step(pm, tx)
    metrics = []
    for batch in batches:
        _, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    out = dict(metrics=metrics, coords=mesh.coords(),
               moments={n: tuple(m.shape) for n, m in zip(
                   [n for n, p in params.items() if p.requires_grad],
                   state.opt_state.mu)},
               params={n: p.detach().clone() for n, p in params.items()},
               specs=dict(state.shard_specs), local_cfg=pm.module.cfg)
    pm, params = trainer.initialize_parallel_model(
        ncfg, configure_model(ncfg, cfg), state_dict=sd, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    rows = {k: v[mesh.data_slice(v.shape[0])] for k, v in batch.items()}
    trainer.data_parallel_loss(pm.module, rows).backward()
    out["grads"] = grads.allreduce_gradients(
        {n: p.grad for n, p in params.items()}, pm.specs,
        sequence_parallel_names=pm.sequence_parallel_names)
    return out


def mixtral_ep_world(banks, sinkhorn, shuffle) -> Dict[str, Any]:
    """The parts of ``tests/test_torch_mixtral_ep.py`` in one world of four
    ranks, each at its own layout:

    * ``banks``: ``(name, kw, tp, ep, gate_up, down, x, gates, idx, loss)``
      cases of the expert bank (capacity or blockwise) at tp x ep, each
      rank on its ep rank's rows: ``bank_outputs``;
    * ``sinkhorn``: the Sinkhorn router (kernel ``[H, E]``) at tp=1 x
      dp=4 on this rank's rows of ``x``: the chosen experts and gates;
    * ``shuffle``: ``token_shuffle`` and ``token_unshuffle`` over dp_exp=2
      (tp=1 x dp=4 x ep=2) of this rank's rows, seeded alike."""
    from neuronx_distributed_tpu_torch.modules.moe import (
        RouterSinkhorn, token_shuffle, token_unshuffle)
    from neuronx_distributed_tpu_torch.parallel import mesh

    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    for name, kw, tp, ep, gate_up, down, x, gates, idx, loss in banks:
        _layout(tp, ep)
        m = _bank(kw, gate_up, down, tp, ep)
        rows = [_rows(torch.from_numpy(a), "ep") for a in (x, gates, idx)]
        out[name] = dict(bank_outputs(m, *rows, loss=loss),
                         coords=mesh.coords())
    _layout(1, 1)
    kernel, x = (torch.from_numpy(a) for a in sinkhorn)
    router = RouterSinkhorn(kernel.shape[0], kernel.shape[1], device="cpu")
    with torch.no_grad():
        router.kernel.copy_(kernel)
        gates, idx, _ = router(_rows(x, ("dp", "cp")))
    out["sinkhorn"] = dict(gates=gates, idx=idx, coords=mesh.coords())
    _layout(1, 2)
    xs = _rows(torch.from_numpy(shuffle), ("dp", "cp"))
    shuffled, perm = token_shuffle(xs, torch.Generator().manual_seed(7),
                                   step=3)
    again, perm2 = token_shuffle(xs, torch.Generator().manual_seed(7),
                                 step=3)
    back = token_unshuffle(shuffled, perm)
    out["shuffle"] = dict(x=xs, shuffled=shuffled, perm=perm, back=back,
                          replay=bool(torch.equal(again, shuffled)
                                      and torch.equal(perm, perm2)),
                          coords=mesh.coords())
    return out


def mixtral_ep_steps_world(steps, lr: float) -> Dict[str, Any]:
    """``tests/test_torch_mixtral_ep_step.py``'s world: for each ``(name,
    cfg, sd, batches, tp, ep)`` of ``steps`` the Mixtral train step at tp
    x ep with sequence parallelism (at tp > 1) and ZeRO-1 (``_train``)."""
    out: Dict[str, Any] = {"jax_modules": jax_modules()}
    for name, cfg, sd, batches, tp, ep in steps:
        out[name] = _train(cfg, sd, batches, lr, tp, ep, True, tp > 1)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_trainer_loop_ep.py
# ---------------------------------------------------------------------------

def _local_state(state) -> Dict[str, torch.Tensor]:
    """Every tensor of ``state`` by its checkpoint path, copied."""
    from neuronx_distributed_tpu_torch.trainer.checkpoint import (
        state_to_tree, tree_leaves)

    tree = state_to_tree(state, lambda t: t.detach().clone())
    return dict(tree_leaves(tree))


def _parts(cfg, sd, tp: int, ep: int, zero1: bool, lr: float):
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import configure_model

    ncfg = _layout(tp, ep, zero1, sp=tp > 1)
    pm, params = trainer.initialize_parallel_model(
        ncfg, configure_model(ncfg, cfg), state_dict=sd, device="cpu")
    tx, state = trainer.initialize_parallel_optimizer(pm, params, lr)
    return pm, state, trainer.make_train_step(pm, tx)


def checkpoint_ep_world(cfg, sd, batches, tmp: str, lr: float
                        ) -> Dict[str, Any]:
    """Saves and resharded loads across the expert-parallel layouts of four
    ranks, each part's state by path with its specs and this rank's
    coords:

    * ``saved``: two steps at tp=2 x dp=2 x ep=2 (ZeRO-1), saved as tag 2
      under ``tmp/a``; ``ep1``: a fresh state at tp=2 x dp=2 x ep=1 loads
      it; ``merged``: rank 0 merges it through the reshard CLI into
      ``tmp/m`` (one rank), and tp=1 x dp=4 x ep=1 loads that; ``back``:
      tp=2 x dp=2 x ep=2 loads the merged tag;
    * ``saved_ep1``: two steps at tp=2 x dp=2 x ep=1 saved as tag 2 under
      ``tmp/b``; ``ep2``: tp=2 x dp=2 x ep=2 loads it;
    * ``saved_dpexp``: two steps at tp=1 x dp=4 x ep=2 (ZeRO-1: the
      expert moments over dp_exp=2) saved under ``tmp/c``; ``dpexp_ep1``:
      tp=2 x dp=2 x ep=1 loads it and trains one more step, as does
      ``dpexp_same`` at the saved layout."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.scripts import reshard_checkpoint
    from neuronx_distributed_tpu_torch.trainer import checkpoint as ck

    from neuronx_distributed_tpu_torch.resilience.integrity import (
        fingerprint_tree_sharded)

    out: Dict[str, Any] = {"jax_modules": jax_modules()}

    def record(name, state, pm):
        out[name] = dict(state=_local_state(state),
                         specs=dict(state.shard_specs),
                         coords=mesh.coords(), step=state.step,
                         fingerprint=fingerprint_tree_sharded(
                             state.params, pm.specs))

    a, b, c, m = (os.path.join(tmp, d) for d in "abcm")
    pm, state, step = _parts(cfg, sd, 2, 2, True, lr)
    for batch in batches[:2]:
        step(state, batch)
    ck.save_checkpoint(a, 2, state, async_save=False)
    record("saved", state, pm)
    pm, state, _ = _parts(cfg, sd, 2, 1, True, lr)
    ck.load_checkpoint(a, tag="2", target=state)
    record("ep1", state, pm)
    # the one-rank tool needs every rank out of the layout first
    mesh.destroy_model_parallel()
    if dist.get_rank() == 0:
        reshard_checkpoint.main(["--input", a, "--tag", "2", "--output", m,
                                 "--device", "cpu"])
    dist.barrier()
    pm, state, _ = _parts(cfg, sd, 1, 1, False, lr)
    ck.load_checkpoint(m, tag="2", target=state)
    record("merged", state, pm)
    pm, state, _ = _parts(cfg, sd, 2, 2, True, lr)
    ck.load_checkpoint(m, tag="2", target=state)
    record("back", state, pm)
    pm, state, step = _parts(cfg, sd, 2, 1, True, lr)
    for batch in batches[:2]:
        step(state, batch)
    ck.save_checkpoint(b, 2, state, async_save=False)
    record("saved_ep1", state, pm)
    pm, state, _ = _parts(cfg, sd, 2, 2, True, lr)
    ck.load_checkpoint(b, tag="2", target=state)
    record("ep2", state, pm)
    pm, state, step = _parts(cfg, sd, 1, 2, True, lr)
    for batch in batches[:2]:
        step(state, batch)
    ck.save_checkpoint(c, 2, state, async_save=False)
    record("saved_dpexp", state, pm)
    _, state, step = _parts(cfg, sd, 1, 2, True, lr)
    for batch in batches[:2]:
        step(state, batch)
    m3 = step(state, batches[2])[1]
    out["dpexp_run"] = (m3["loss"].item(), m3["grad_norm"].item())
    for name, tp, ep in (("dpexp_same", 1, 2), ("dpexp_ep1", 2, 1)):
        pm, state, step = _parts(cfg, sd, tp, ep, True, lr)
        ck.load_checkpoint(c, tag="2", target=state)
        record(name, state, pm)
        m3 = step(state, batches[2])[1]
        out[name]["next"] = (m3["loss"].item(), m3["grad_norm"].item())
    return out
