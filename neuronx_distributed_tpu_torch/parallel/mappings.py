"""The differentiable collective pairs of tensor, sequence and expert
parallelism (counterpart of ``neuronx_distributed_tpu/parallel/
mappings.py``, JAX ``:73-258``):

====================================  ============  =================
mapping                               forward       backward
====================================  ============  =================
copy_to_tensor_parallel_region        identity      all-reduce
reduce_from_tensor_parallel_region    all-reduce    identity
scatter_to_tensor_parallel_region     split         all-gather
gather_from_tensor_parallel_region    all-gather    split
scatter_to_sequence_parallel_region   split(seq)    all-gather(seq)
gather_from_sequence_parallel_region  all-gather    reduce-scatter/split
reduce_scatter_to_seq_parallel_region reduce-scat.  all-gather
enter/exit_expert_parallel_region     all-to-all    all-to-all (inverse)
====================================  ============  =================

Each is a ``torch.autograd.Function`` over :mod:`.comm` on the axis's
process group (the reference's ``jax.custom_vjp`` pairs), and the identity
both ways where the axis holds one rank. The sequence dim defaults to 1
(``[B, S, H]``), as in the reference.
"""

from __future__ import annotations

import torch

from . import comm
from . import mesh as ps


def _check_seq_divisible(x: torch.Tensor, axis: ps.Axis, seq_dim: int,
                         op: str) -> None:
    """A sequence length that does not tile over the axis raises with the
    names attached (JAX ``:73``)."""
    n = comm.axis_size(axis)
    if n <= 1:
        return
    d = seq_dim % x.dim()
    if x.shape[d] % n != 0:
        raise ValueError(
            f"{op}: sequence length {x.shape[d]} (dim {seq_dim}) does not "
            f"divide evenly over mesh axis {axis!r} of size {n}; pad or "
            f"trim the sequence to a multiple of {n}")


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return comm.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return comm.split_along_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.axis, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return comm.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return comm.split_along_dim(g, ctx.axis, ctx.dim), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, seq_dim, to_model_parallel):
        ctx.axis, ctx.dim, ctx.reduce = axis, seq_dim, to_model_parallel
        return comm.all_gather(x, axis, seq_dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            _check_seq_divisible(
                g, ctx.axis, ctx.dim,
                "gather_from_sequence_parallel_region (backward "
                "reduce-scatter)")
            return comm.reduce_scatter(g, ctx.axis, ctx.dim), None, None, \
                None
        return comm.split_along_dim(g, ctx.axis, ctx.dim), None, None, None


class _SeqReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, seq_dim):
        _check_seq_divisible(x, axis, seq_dim,
                             "reduce_scatter_to_sequence_parallel_region")
        ctx.axis, ctx.dim = axis, seq_dim
        return comm.reduce_scatter(x, axis, seq_dim)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.split, ctx.concat = axis, split_dim, concat_dim
        return comm.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (comm.all_to_all(g, ctx.axis, ctx.concat, ctx.split), None,
                None, None)


def copy_to_tensor_parallel_region(x: torch.Tensor,
                                   axis: ps.Axis = ps.TP_AXIS):
    """Identity forward, all-reduce backward (reference ``mappings.py:175``)."""
    return x if comm.axis_size(axis) == 1 else _Copy.apply(x, axis)


def reduce_from_tensor_parallel_region(x: torch.Tensor,
                                       axis: ps.Axis = ps.TP_AXIS):
    """All-reduce forward, identity backward (reference ``mappings.py:196``)."""
    return x if comm.axis_size(axis) == 1 else _Reduce.apply(x, axis)


def scatter_to_tensor_parallel_region(x: torch.Tensor,
                                      axis: ps.Axis = ps.TP_AXIS,
                                      dim: int = -1):
    """Split forward, all-gather backward (reference ``mappings.py:214``)."""
    return x if comm.axis_size(axis) == 1 else _Scatter.apply(x, axis, dim)


def gather_from_tensor_parallel_region(x: torch.Tensor,
                                       axis: ps.Axis = ps.TP_AXIS,
                                       dim: int = -1):
    """All-gather forward, split backward (reference ``mappings.py:235``)."""
    return x if comm.axis_size(axis) == 1 else _Gather.apply(x, axis, dim)


def scatter_to_sequence_parallel_region(x: torch.Tensor,
                                        axis: ps.Axis = ps.TP_AXIS,
                                        seq_dim: int = 1):
    """Split the sequence forward, all-gather it backward."""
    return (x if comm.axis_size(axis) == 1
            else _Scatter.apply(x, axis, seq_dim))


def gather_from_sequence_parallel_region(x: torch.Tensor,
                                         axis: ps.Axis = ps.TP_AXIS,
                                         seq_dim: int = 1,
                                         to_model_parallel: bool = True):
    """All-gather the sequence forward. Backward: reduce-scatter when
    entering a TP block (``to_model_parallel``, reference
    ``mappings.py:280``: every rank's contribution summed, then
    re-sharded), else a plain split."""
    if comm.axis_size(axis) == 1:
        return x
    return _SeqGather.apply(x, axis, seq_dim, to_model_parallel)


def reduce_scatter_to_sequence_parallel_region(x: torch.Tensor,
                                               axis: ps.Axis = ps.TP_AXIS,
                                               seq_dim: int = 1):
    """Exit a TP block into the SP region (reference ``mappings.py:322``):
    reduce-scatter forward, all-gather backward."""
    if comm.axis_size(axis) == 1:
        return x
    return _SeqReduceScatter.apply(x, axis, seq_dim)


def enter_expert_parallel_region(x: torch.Tensor,
                                 axis: ps.Axis = ps.EP_AXIS,
                                 split_dim: int = 0, concat_dim: int = 1):
    """All-to-all splitting ``split_dim``, the inverse all-to-all backward
    (reference ``mappings.py:355``)."""
    if comm.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def exit_expert_parallel_region(x: torch.Tensor,
                                axis: ps.Axis = ps.EP_AXIS,
                                split_dim: int = 1, concat_dim: int = 0):
    """The reverse all-to-all of :func:`enter_expert_parallel_region`
    (reference ``mappings.py:521``)."""
    if comm.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)
