"""Gradient synchronisation and norms across ranks (counterpart of
``neuronx_distributed_tpu/parallel/grads.py``, JAX ``:46-153``).

Gradients are keyed by parameter name, as the port's state is; ``specs``
maps a name to its partition spec, one entry per dim: None, an axis name
or a tuple of them (:func:`..models.convert.param_specs`, extended over
the data axes by ZeRO-1, :func:`..trainer.optimizer.zero1_state_specs`).

The sequence-parallel rule is the upstream's (``grads.py:330``): a
parameter replicated over tp whose layer sees sequence-sharded activations
(the norms under ``sequence_parallel``) holds on each tp rank the gradient
of that rank's sequence shard only, so :func:`allreduce_gradients` sums it
over tp. The reference's GSPMD step needs no such pass; its explicit form
folds the same sum into the norm's ``copy_to`` backward.

The expert-parallel rule: a gradient sharded over ``ep`` (an expert bank
at ``ep > 1``) already holds, on each rank, the sum over its ep group's
ranks of their losses' gradients, since the expert dispatch's backward
brings every rank's output gradient to the rank that holds the expert.
So it is summed over ``dp_exp`` (the ranks that hold the same experts)
and divided by the whole data-parallel size: averaging over ``dp_exp``
alone would leave it ``ep`` times too large, and averaging over every
data rank would mix different experts. Where the default loss weighs the
ranks by their counted labels the weights are already in each rank's
loss, so the same sum carries them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

from ..trainer.optimizer import global_norm
from . import comm
from . import mesh as ps

Spec = Tuple


def spec_axes(spec: Optional[Spec]) -> set:
    """The axis names a spec mentions."""
    axes = set()
    for p in spec or ():
        if p is None:
            continue
        axes.update(p if isinstance(p, tuple) else (p,))
    return axes


def allreduce_gradients(
        grads: Mapping[str, torch.Tensor],
        specs: Optional[Mapping[str, Spec]] = None,
        axes: Sequence[str] = ps.DATA_AXES,
        sequence_parallel_names: Iterable[str] = (),
        zero_dims: Optional[Mapping[str, Optional[int]]] = None
) -> Dict[str, torch.Tensor]:
    """Sum each gradient of ``sequence_parallel_names`` over tp, then
    average every gradient over the data ``axes`` of size above 1 that its
    spec does not shard it over (reference
    ``bucket_allreduce_gradients:259``, the SP reduce ``:330`` and the CP
    reduce ``:348``), in place. The loss is each rank's local mean, so the
    global gradient is the mean of the local ones. A gradient with a
    ZeRO-1 dim in ``zero_dims`` is reduce-scattered along it over the
    merged data axes instead: the returned dict holds this rank's slice
    of its mean. A gradient sharded over ``ep`` is summed (or with ZeRO-1
    reduce-scattered) over ``dp_exp`` and divided by the data axes' size
    (the module docstring's expert-parallel rule)."""
    for name in sequence_parallel_names:
        comm.all_reduce_(grads[name], ps.TP_AXIS)
    out = dict(grads)
    bound = [ax for ax in axes if comm.axis_size(ax) > 1]
    if not bound:
        return out
    n_data = comm.axis_size(tuple(axes))
    ep = comm.axis_size(ps.EP_AXIS) > 1
    for name, g in grads.items():
        d = zero_dims.get(name) if zero_dims else None
        if ep and specs and ps.EP_AXIS in spec_axes(specs.get(name)):
            if d is not None:
                out[name] = comm.reduce_scatter(
                    g, ps.EXP_DP_AXIS, d).div_(n_data)
            else:
                comm.all_reduce_(g, ps.EXP_DP_AXIS).div_(n_data)
            continue
        if d is not None:
            red = tuple(axes)
            out[name] = comm.reduce_scatter(g, red, d).div_(
                comm.axis_size(red))
            continue
        mentioned = spec_axes(specs.get(name)) if specs else set()
        red = tuple(ax for ax in bound if ax not in mentioned)
        if red:
            comm.all_reduce_(g, red).div_(comm.axis_size(red))
    return out


def global_grad_norm(grads: Mapping[str, torch.Tensor],
                     specs: Optional[Mapping[str, Spec]] = None
                     ) -> torch.Tensor:
    """The L2 norm over every element of the whole (unsharded) gradient
    (reference ``get_grad_norm:41``): each leaf's local sum of squares is
    summed over the axes its spec shards it on, so a replicated leaf
    counts once. One all-reduce per distinct set of axes; where no leaf is
    sharded over an axis above 1 rank, :func:`..trainer.optimizer.global_norm`
    of the leaves."""
    by_axes: Dict[Tuple[str, ...], list] = {}
    for name, g in grads.items():
        axes = tuple(sorted(ax for ax in spec_axes(
            specs.get(name) if specs else None) if comm.axis_size(ax) > 1))
        by_axes.setdefault(axes, []).append(g)
    if list(by_axes) == [()]:
        return global_norm(by_axes[()])
    total = None
    for axes, leaves in by_axes.items():
        s = global_norm(leaves) ** 2
        for ax in axes:
            s = comm.all_reduce(s, ax)
        total = s if total is None else total + s
    return torch.sqrt(total)


def global_grad_norm_pp(grads: Mapping[str, torch.Tensor],
                        specs: Optional[Mapping[str, Spec]],
                        device: torch.device) -> torch.Tensor:
    """:func:`global_grad_norm` across pipeline stages: ``grads`` are the
    leaves this rank's stage counts (each stage holds other leaves, so
    ranks differ in which axis sets they have). The squares are summed in
    four fixed groups (sharded over none, tp, the data axes, or both), each
    reduced over its axes, then the total over pp: every rank runs the same
    collectives whatever it holds."""
    data = set(ps.DATA_AXES)
    groups = [[], [], [], []]
    for name, g in grads.items():
        axes = spec_axes(specs.get(name) if specs else None)
        on_tp = ps.TP_AXIS in axes and comm.axis_size(ps.TP_AXIS) > 1
        on_data = bool(axes & data) and comm.axis_size(ps.DATA_AXES) > 1
        groups[2 * on_data + on_tp].append(g)
    sums = torch.stack([
        global_norm(leaves) ** 2 if leaves
        else torch.zeros((), dtype=torch.float32, device=device)
        for leaves in groups])
    tp_part = comm.all_reduce(sums[1::2].contiguous(), ps.TP_AXIS)
    data_part = comm.all_reduce(
        torch.stack([sums[2], tp_part[1]]), ps.DATA_AXES)
    total = sums[0] + tp_part[0] + data_part.sum()
    return torch.sqrt(comm.all_reduce(total, ps.PP_AXIS))


def clip_grad_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                   specs: Optional[Mapping[str, Spec]] = None
                   ) -> Tuple[Mapping[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient in place by ``min(1, max_norm / (norm +
    1e-6))`` (reference ``clip_grad_norm:192``); a non-finite norm scales
    by 1, so a step can still be skipped. Returns ``(grads, norm)``."""
    if max_norm <= 0:
        raise ValueError(f"max_norm must be positive, got {max_norm}")
    norm = global_grad_norm(grads, specs)
    scale = torch.where(torch.isfinite(norm),
                        torch.clamp(max_norm / (norm + 1e-6), max=1.0),
                        torch.ones_like(norm))
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, norm
