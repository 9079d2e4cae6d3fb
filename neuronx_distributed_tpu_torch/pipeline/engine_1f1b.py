"""The 1F1B and interleaved pipeline executor over ``torch.distributed``
ranks (counterpart of ``neuronx_distributed_tpu/pipeline/engine_1f1b.py``).

The reference runs the reference's ``Train1F1BSchedule``
(``pipeline/scheduler.py:157``) and ``TrainInterleavedSchedule`` (``:256``)
as one scanned SPMD program in which every tick holds one forward and one
backward sub-slot per stage. The port runs each stage in its own process
on the same clock, tick for tick:

* with ``SC = S·C`` virtual stages and microbatches injected in groups of
  ``S``, the forward of (microbatch ``f``, chunk ``c``) runs on stage ``s``
  at tick ``τ(f,c) + s``, ``τ(f,c) = (f//S)·SC + c·S + f%S``, and its
  backward at ``(SC-1) + β(f,c) + (S-1-s)``, ``β(f,c) = (f//S)·SC +
  (C-1-c)·S + f%S``; on the last stage the backward of chunk ``C-1``
  falls on its forward's tick, so the head's loss feeds it directly;
* stage IO is two rings per tick over ``pp`` (:func:`..parallel.comm.
  ppermute`): activations ``s -> s+1 mod S`` and gradients ``s -> s-1 mod
  S``; the mod-S wrap carries a microbatch from chunk ``c`` on the last
  stage to chunk ``c+1`` on stage 0;
* ``T = M·C + S·C + S - 2`` ticks; ``C = 1`` is plain 1F1B.

Design: the reference recomputes a stage's forward from a ring buffer of
``2·S·C`` saved inputs at its backward tick (``jax.vjp``); eager PyTorch
keeps each in-flight microbatch's autograd graph instead, as the
upstream executor does. A graph is made at the forward sub-slot and
freed at the backward one. On a stage before the last the backward
sub-slot runs first (it reads only the cotangent of the tick before), so
for ``C = 1`` stage ``s`` holds at most ``2·(S-1-s)`` graphs (one on the
last stage): the round trip of a microbatch from stage ``s`` to the last
and back, one hop a tick each way. That is ``S - s`` at ``S = 2`` and is
independent of ``M``. What a graph keeps is what autograd saves for the
stage's layers (with ``remat``, each layer's input only).

Stochastic layers: with ``stage_takes_slot`` the stage receives the
microbatch slot ``σ(f,c) = τ(f,c)``, unique per (microbatch, chunk) in a
step, from which it draws its dropout seeds; a remat recompute inside the
graph reuses the seeds the forward drew.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import comm
from ..parallel import mesh as ps
from .spmd_engine import _leaf, _split, _zeros, backward_stage, stage_coords


def interleaved_layer_order(num_layers: int, num_stages: int,
                            num_chunks: int) -> np.ndarray:
    """``order[j]`` = canonical layer index stored at interleaved slot
    ``j``: stage ``s``'s chunks stored contiguously, so the pipeline's
    split of the stack stays contiguous (``storage[j] =
    dense[order[j]]``; invert with ``np.argsort(order)``)."""
    sc = num_stages * num_chunks
    if num_layers % sc != 0:
        raise ValueError(
            f"num_layers {num_layers} not divisible by stages*chunks {sc}")
    lv = num_layers // sc
    order = [v * lv + i
             for s in range(num_stages)
             for c in range(num_chunks)
             for v in ((c * num_stages + s),)
             for i in range(lv)]
    return np.asarray(order)


def ring_buffer_slots(num_stages: int, num_chunks: int = 1) -> int:
    """The reference's saved-input ring size: the longest in-flight (f, c)
    lifetime is ``2·S·C - 2`` ticks (stage 0, chunk 0)."""
    return 2 * num_stages * num_chunks


def slot_decode(slot: int, num_microbatches: int, num_stages: int,
                num_chunks: int) -> Tuple[bool, int, int]:
    """``slot -> (valid, f, c)`` for the group-of-S injection order."""
    M, S, C = num_microbatches, num_stages, num_chunks
    valid = 0 <= slot < M * C
    slot = min(max(slot, 0), M * C - 1)
    g, r = slot // (S * C), slot % (S * C)
    return valid, g * S + r % S, r // S


def slot_of(f: int, c: int, num_stages: int, num_chunks: int) -> int:
    """``σ(f, c) = (f//S)·SC + c·S + f%S``."""
    S = num_stages
    return (f // S) * S * num_chunks + c * S + f % S


def pipeline_1f1b_grads(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    stage_fn: Callable[..., Any],
    head_loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    ids_mb: torch.Tensor,
    labels_mb: torch.Tensor,
    num_stages: int,
    num_microbatches: int,
    act_like: Tuple[Sequence[int], torch.dtype, torch.device],
    num_chunks: int = 1,
    axis: str = ps.PP_AXIS,
    aux_weight: Optional[torch.Tensor] = None,
    num_real_microbatches: Optional[int] = None,
    vocab_parallel_pp: bool = False,
    stage_takes_slot: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the 1F1B (or interleaved, ``num_chunks > 1``) forward and
    backward pipeline on this rank's stage; parameter gradients
    accumulate in ``.grad``.

    ``embed_fn(ids [mb, seq]) -> act``: stage 0's chunk-0 prologue.
    ``stage_fn(c, act)`` (``stage_fn(c, act, slot)`` with
    ``stage_takes_slot``): chunk ``c`` of this stage's layers, returning
    ``act``, or ``(act, aux [A])`` with ``aux_weight``. ``head_loss_fn(act,
    labels) -> scalar``: the last stage's epilogue, the microbatch's
    contribution to the local mean loss. ``act_like``: ``(shape, dtype,
    device)`` of one stage activation.

    ``aux_weight [A]``: d(loss)/d(aux) of one stage call (router
    coefficients over M); every backward seeds the aux with it, and the
    aux of the real microbatches joins the loss. ``num_real_microbatches``:
    with pad microbatches (all labels ignored, lifting the interleaved
    ``M % S`` constraint) the count of real ones; the pads' aux is left
    out. ``vocab_parallel_pp``: ``embed_fn`` and ``head_loss_fn`` hold a
    ``(pp, tp)`` vocab shard and carry their own collectives over it; they
    then run on every rank at the first (embedding) and last (head)
    stage's schedule, with the last stage's activation and stage 0's
    input gradient broadcast over pp.

    Returns ``(loss, aux_total)``: the local loss, the same on every pp
    rank (with the aux term), and the aux summed over stages and real
    microbatches (None without aux). ``stats``, when given, gets ``ticks``
    and ``max_live``, the most graphs this stage held at once."""
    S, M, C = num_stages, num_microbatches, num_chunks
    SC = S * C
    M_real = M if num_real_microbatches is None else num_real_microbatches
    if C > 1 and M % S != 0:
        raise ValueError(
            f"interleaved schedule requires num_microbatches {M} divisible "
            f"by pipeline stages {S} (pad microbatches with all-ignore "
            "labels and pass num_real_microbatches — the model grad_fns do "
            "this automatically)")
    my = stage_coords(S, axis)
    last = my == S - 1
    has_aux = aux_weight is not None
    T = M * C + SC + S - 2
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]
    bwd_perm = [(i, (i - 1) % S) for i in range(S)]
    dev = act_like[2]

    def decode(slot):
        return slot_decode(slot, M, S, C)

    def aux_ct(f):
        return aux_weight.float() * float(f < M_real) if has_aux else None

    graphs: Dict[int, Tuple] = {}
    embeds: Dict[int, torch.Tensor] = {}
    max_live = 0
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    aux_acc = (torch.zeros(aux_weight.shape, dtype=torch.float32, device=dev)
               if has_aux else None)
    act_recv = grad_recv = None

    for t in range(T):
        if vocab_parallel_pp:
            # stage 0's forward schedule, decoded without the rank offset:
            # every rank embeds its vocab shard of the same microbatch
            v0, f0, c0 = decode(t)
            if v0 and c0 == 0:
                embeds[f0] = embed_fn(ids_mb[f0])

        def backward_slot():
            bvalid, b, c_pos = decode(t - (SC - 1) - (S - 1 - my))
            c_b = (C - 1) - c_pos
            if not bvalid:
                return None, None
            inp, out, aux = graphs.pop(slot_of(b, c_b, S, C))
            if last and c_b == C - 1 and not vocab_parallel_pp:
                loss_b = head_loss_fn(out, labels_mb[b])
                total = loss_b
                if aux is not None and aux.requires_grad:
                    total = total + (aux.float() * aux_ct(b)).sum()
                total.backward()
                head[0] = head[0] + loss_b.detach().float()
            else:
                dout = (head[1] if last and c_b == C - 1 else grad_recv)
                backward_stage(out, dout, aux, aux_ct(b))
            if my == 0 and c_b == 0 and not vocab_parallel_pp:
                return None, (b, c_b)   # the embedding is in the graph
            return inp.grad, (b, c_b)

        head = [torch.zeros((), dtype=torch.float32, device=dev), None]
        dact_in = None
        if not last:
            dact_in, _ = backward_slot()

        # ---- forward sub-slot
        fvalid, f, c_f = decode(t - my)
        out = None
        if fvalid:
            sigma_f = slot_of(f, c_f, S, C)
            if my == 0 and c_f == 0:
                inp = (_leaf(embeds[f]) if vocab_parallel_pp
                       else embed_fn(ids_mb[f]))
            else:
                inp = _leaf(act_recv)
            args = (c_f, inp, sigma_f) if stage_takes_slot else (c_f, inp)
            out, aux = _split(stage_fn(*args), has_aux)
            graphs[sigma_f] = (inp, out, aux)
            max_live = max(max_live, len(graphs))
            if aux is not None and f < M_real:
                aux_acc = aux_acc + aux.detach().float()

        if vocab_parallel_pp:
            # the last stage's head schedule, decoded uniformly: its
            # activation is broadcast and every rank runs its vocab shard
            vL, bL, cposL = decode(t - (SC - 1))
            if vL and (C - 1) - cposL == C - 1:
                act_b = _leaf(comm.all_reduce(
                    out.detach() if last else _zeros(act_like), axis))
                loss_b = head_loss_fn(act_b, labels_mb[bL])
                loss_b.backward()
                head[0] = loss_b.detach().float()
                head[1] = act_b.grad

        if last:
            dact_in, _ = backward_slot()
        loss_acc = loss_acc + head[0]

        if vocab_parallel_pp:
            # stage 0's backward schedule, decoded uniformly: its input
            # gradient is broadcast and every rank backpropagates its
            # vocab shard of the embedding
            vb0, b0, cpos0 = decode(t - (SC - 1) - (S - 1))
            if vb0 and (C - 1) - cpos0 == 0:
                d = comm.all_reduce(dact_in if my == 0 else
                                    _zeros(act_like), axis)
                torch.autograd.backward(embeds.pop(b0), d.to(act_like[1]))

        if S > 1:
            act_recv = comm.ppermute(
                out.detach() if out is not None else _zeros(act_like),
                axis, fwd_perm)
            grad_recv = comm.ppermute(
                dact_in if dact_in is not None else _zeros(act_like),
                axis, bwd_perm)
        else:
            act_recv = out.detach() if out is not None else None
            grad_recv = dact_in

    if stats is not None:
        stats.update(ticks=T, max_live=max_live)
    if vocab_parallel_pp or S == 1:
        # every rank accumulated the head's loss already
        loss = loss_acc
    else:
        loss = comm.all_reduce(loss_acc if last else
                               torch.zeros_like(loss_acc), axis)
    if has_aux:
        aux_acc = comm.all_reduce(aux_acc, axis)
        loss = loss + torch.dot(aux_acc, aux_weight.float())
    return loss, aux_acc
