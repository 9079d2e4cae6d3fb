"""The GPipe pipeline executor over ``torch.distributed`` ranks (counterpart
of ``neuronx_distributed_tpu/pipeline/spmd_engine.py``).

The reference runs the whole pipeline as one SPMD program: a ``lax.scan``
over ``M + S - 1`` ticks whose stage IO is a ``ppermute`` over the ``pp``
axis, and derives the backward pipeline by autodiff of that scan. The port
runs one process per rank, each on its own stage, in the same clock:

* forward: tick ``t`` in ``0 .. M + S - 2``, stage ``s`` runs microbatch
  ``t - s`` when it is one (bubble ticks run nothing), then the stages
  pass their outputs one hop down the line (:func:`..parallel.comm.
  ppermute` over ``pp``, ``s -> s + 1``; zeros from a bubble tick). Every
  microbatch's autograd graph is kept: its input (a leaf that requires
  grad, or the embedding's graph on stage 0), its output and its aux;
* backward: the ticks in reverse order, stage ``s`` backpropagates
  microbatch ``t - s`` from the cotangent its successor sent the tick
  before (``torch.autograd.backward(out, grad)``; on the last stage from
  the head's loss, computed there) and passes its input's gradient one
  hop up the line. Parameter gradients accumulate in ``.grad``.

This is the transpose of the reference's scan, tick for tick: the same
microbatch meets the same stage at the same reverse tick, so the losses and
gradients are the reference's. The graphs of all ``M`` microbatches are
live at once, as the reference's autodiff residuals are.

:func:`pipeline_spmd` is the forward alone, for the evaluation step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..parallel import comm
from ..parallel import mesh as ps


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """``[B, ...] -> [M, B/M, ...]`` (reference: microbatch slicing in
    ``NxDPPModel.run_train``)."""
    if x.shape[0] % num_microbatches != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by num_microbatches "
            f"{num_microbatches}")
    return x.reshape(num_microbatches, x.shape[0] // num_microbatches,
                     *x.shape[1:])


def stage_coords(num_stages: int, axis: str = ps.PP_AXIS) -> int:
    """This rank's stage, after checking that ``axis`` holds
    ``num_stages`` ranks (JAX's bound-axis checks)."""
    bound = comm.axis_size(axis)
    if bound != num_stages:
        raise ValueError(f"pp axis size {bound} != num_stages {num_stages}"
                         + ("; lay the ranks out with "
                            "neuronx_distributed_config(pipeline_parallel_"
                            "size=...)" if bound == 1 else ""))
    return ps.axis_rank(axis) if bound > 1 else 0


def _zeros(like: Tuple[Sequence[int], torch.dtype, torch.device]
           ) -> torch.Tensor:
    shape, dtype, device = like
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _leaf(x: torch.Tensor) -> torch.Tensor:
    """A received activation as the input leaf of this stage's graph."""
    return x.detach().requires_grad_(True)


def _split(res: Any, with_aux: bool) -> Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]:
    return (res[0], res[1]) if with_aux else (res, None)


def backward_stage(out: torch.Tensor, dout: torch.Tensor,
                   aux: Optional[torch.Tensor] = None,
                   aux_ct: Optional[torch.Tensor] = None) -> None:
    """Backpropagate one stage call from the cotangent of its output and,
    with aux, the aux cotangent ``aux_ct``."""
    outs, cts = [out], [dout.to(out.dtype)]
    if aux is not None and aux.requires_grad:
        outs.append(aux)
        cts.append(aux_ct.to(aux.dtype))
    torch.autograd.backward(outs, cts)


def pipeline_gpipe_grads(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    stage_fn: Callable[[torch.Tensor], Any],
    head_loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    ids_mb: torch.Tensor,
    labels_mb: torch.Tensor,
    num_stages: int,
    num_microbatches: int,
    act_like: Tuple[Sequence[int], torch.dtype, torch.device],
    axis: str = ps.PP_AXIS,
    aux_weight: Optional[torch.Tensor] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the GPipe forward and backward pipelines on this rank's stage.

    ``embed_fn(ids [mb, seq]) -> act`` runs on stage 0; ``stage_fn(act)``
    is this stage's layers (``(act, aux [A])`` with ``aux_weight``);
    ``head_loss_fn(act, labels) -> scalar`` runs on the last stage and
    returns the microbatch's contribution to the local mean loss (already
    divided by the local label count), so its cotangent is 1.
    ``act_like`` is ``(shape, dtype, device)`` of one stage activation,
    what a bubble tick sends. ``aux_weight [A]``: d(loss)/d(aux) of one
    stage call; the aux cotangent every backward is seeded with.

    Returns ``(local_loss, aux_total)``: the summed head losses on the last
    stage, zero elsewhere, and this stage's aux summed over its
    microbatches (None without aux); the caller replicates them over pp.
    ``stats``, when given, gets ``ticks`` and ``max_live`` (the most
    microbatch graphs this stage held at once)."""
    S, M = num_stages, num_microbatches
    my = stage_coords(S, axis)
    with_aux = aux_weight is not None
    ticks = M + S - 1
    graphs: Dict[int, Tuple] = {}
    max_live = 0
    recv = None
    aux_total = None
    for t in range(ticks):
        m = t - my
        send = None
        if 0 <= m < M:
            inp = embed_fn(ids_mb[m]) if my == 0 else _leaf(recv)
            out, aux = _split(stage_fn(inp), with_aux)
            graphs[m] = (inp, out, aux)
            max_live = max(max_live, len(graphs))
            if aux is not None:
                a = aux.detach().float()
                aux_total = a if aux_total is None else aux_total + a
            send = out.detach()
        if S > 1:
            recv = comm.ppermute(send if send is not None else _zeros(
                act_like), axis, [(i, i + 1) for i in range(S - 1)])
    loss = torch.zeros((), dtype=torch.float32, device=act_like[2])
    grad = None
    for t in reversed(range(ticks)):
        m = t - my
        send = None
        if 0 <= m < M:
            inp, out, aux = graphs.pop(m)
            if my == S - 1:
                loss_m = head_loss_fn(out, labels_mb[m])
                total = loss_m
                if aux is not None:
                    total = total + (aux.float() * aux_weight).sum()
                total.backward()
                loss = loss + loss_m.detach().float()
            else:
                backward_stage(out, grad, aux, aux_weight)
            if my > 0:
                send = inp.grad
        if S > 1:
            grad = comm.ppermute(send if send is not None else _zeros(
                act_like), axis, [(i, i - 1) for i in range(1, S)])
    if stats is not None:
        stats.update(ticks=ticks, max_live=max_live)
    return loss, aux_total


@torch.no_grad()
def pipeline_spmd(stage_fn: Callable[[torch.Tensor], Any],
                  x_mb: torch.Tensor, num_stages: int,
                  num_microbatches: int,
                  act_like: Tuple[Sequence[int], torch.dtype, torch.device],
                  axis: str = ps.PP_AXIS, with_aux: bool = False,
                  input_fn: Optional[Callable] = None):
    """The forward pipeline alone (JAX ``pipeline_spmd``, no gradient):
    ``[M, mb, ...]`` outputs, valid on the last stage only (zeros
    elsewhere); with ``with_aux`` also this stage's aux summed over its
    microbatches. ``input_fn`` maps stage 0's raw microbatch (token ids)
    to its input activation."""
    S, M = num_stages, num_microbatches
    my = stage_coords(S, axis)
    outs = [None] * M
    aux_total = None
    recv = None
    for t in range(M + S - 1):
        m = t - my
        send = None
        if 0 <= m < M:
            if my == 0:
                inp = input_fn(x_mb[m]) if input_fn is not None else x_mb[m]
            else:
                inp = recv
            out, aux = _split(stage_fn(inp), with_aux)
            if aux is not None:
                aux_total = (aux.float() if aux_total is None
                             else aux_total + aux.float())
            outs[m] = out
            send = out
        if S > 1:
            recv = comm.ppermute(send if send is not None else _zeros(
                act_like), axis, [(i, i + 1) for i in range(S - 1)])
    if my != S - 1:
        outs = [_zeros(act_like)] * M
    out = torch.stack(outs)
    return (out, aux_total) if with_aux else out


def last_stage_value(x: torch.Tensor, axis: str = ps.PP_AXIS
                     ) -> torch.Tensor:
    """``x`` of the last pp rank on every rank (no gradient crosses)."""
    n = comm.axis_size(axis)
    if n == 1:
        return x
    mine = ps.axis_rank(axis) == n - 1
    return comm.all_reduce(x if mine else torch.zeros_like(x), axis)


def data_parallel_mean(loss: torch.Tensor,
                       axes: Tuple[str, ...] = ps.DATA_AXES
                       ) -> torch.Tensor:
    """The mean of a per-rank loss over the data axes."""
    n = comm.axis_size(axes)
    return loss if n == 1 else comm.all_reduce(loss, axes) / n
