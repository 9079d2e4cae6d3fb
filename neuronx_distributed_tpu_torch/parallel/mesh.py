"""Process groups and parallel state over ``torch.distributed`` (counterpart
of ``neuronx_distributed_tpu/parallel/mesh.py``).

The reference builds one ``jax.sharding.Mesh`` with axes ``("pp", "dp",
"cp", "tp")`` and runs one SPMD program over it. The port runs one process
per rank, as the survey's upstream does: the ranks of the default process
group are laid out as the rank tensor ``[pp, dp, cp, tp]`` with tp
innermost (JAX ``:148``), and each axis gets one ``new_group`` per line of
that tensor. The expert view ``[pp, dp_exp, ep, tp]`` regroups the same
ranks (the dp and cp axes merged and re-split), so tp groups are the same
in both views; ZeRO-1 shards over the merged dp x cp group.

Every size and rank getter returns a host int: a process has its rank.
:func:`replica_groups` is a pure function of the sizes, so the lists the
``get_*_replica_groups`` getters return can be compared with JAX's without
launching processes.

What has no torch meaning is left out: ``shard_map``, ``named_sharding*``
and ``with_sharding_constraint`` (the port's tensors are each rank's local
shards, placed by the process that holds them), the topology-aware and
multi-slice device orders (``dcn_data_parallel_size``), the axis hierarchy
and the per-phase MoE meshes of the serving tiers, which come with them.

The state is one object per process, as the reference's: call
:func:`destroy_model_parallel` before initialising another layout in the
same process. The ranks of one default process group may be laid out
again at other sizes as often as they like (tp=2 x dp=2, then tp=4, then
tp=1 x dp=4), so one start of the processes can save a checkpoint at one
layout and load it at another; the groups of an earlier layout live on,
unused, until the default group is destroyed.

Host decisions that every rank must take together (stop for a
preemption, rewind on an integrity mismatch, skip a corrupt checkpoint)
go through :func:`agree`, one all-reduce of a host number over the whole
world; :func:`barrier` orders the checkpoint engine's file writes. Both
are called from the training thread only: the checkpoint engine's commit
threads coordinate through files, never through a collective, so no
collective of theirs can interleave with the step's on the same group.
JAX's loop is one controller and needs neither.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

PP_AXIS = "pp"
DP_AXIS = "dp"
CP_AXIS = "cp"
TP_AXIS = "tp"
EP_AXIS = "ep"
EXP_DP_AXIS = "dp_exp"
#: the merged data axes ZeRO-1 shards over (reference ``parallel_state.py:1684``)
DATA_AXES = (DP_AXIS, CP_AXIS)
#: the merged pipeline and tensor axes a ``vocab_pp`` table shards over
#: (JAX ``llama_pipeline.make_1f1b_grad_fn(vocab_pp=True)``), pp major
PP_TP_AXES = (PP_AXIS, TP_AXIS)

MESH_AXES = (PP_AXIS, DP_AXIS, CP_AXIS, TP_AXIS)
EXPERT_MESH_AXES = (PP_AXIS, EXP_DP_AXIS, EP_AXIS, TP_AXIS)

Axis = Union[str, Tuple[str, ...]]


def _groups_over(ids: np.ndarray, axis: int) -> List[List[int]]:
    moved = np.moveaxis(ids, axis, -1)
    return [list(map(int, row)) for row in moved.reshape(-1, moved.shape[-1])]


def replica_groups(sizes: Dict[str, int]) -> Dict[str, List[List[int]]]:
    """The rank lists of every axis for the sizes :func:`..config.
    mesh_factorization` resolves: ``tp``, ``dp``, ``pp``, ``cp`` over the
    rank tensor ``[pp, dp, cp, tp]`` (ranks in order, tp innermost), ``ep``
    and ``dp_exp`` over its expert view ``[pp, dp_exp, ep, tp]``, and
    ``zero1`` over ``[pp, dp x cp, tp]`` (JAX ``:412-476``)."""
    pp, dp, cp, tp = (sizes[a] for a in MESH_AXES)
    ep, dp_exp = sizes["ep"], sizes["dp_exp"]
    ids = np.arange(pp * dp * cp * tp).reshape(pp, dp, cp, tp)
    expert = ids.reshape(pp, dp_exp, ep, tp)
    return {TP_AXIS: _groups_over(ids, 3), DP_AXIS: _groups_over(ids, 1),
            PP_AXIS: _groups_over(ids, 0), CP_AXIS: _groups_over(ids, 2),
            EP_AXIS: _groups_over(expert, 2),
            EXP_DP_AXIS: _groups_over(expert, 1),
            "zero1": _groups_over(ids.reshape(pp, dp * cp, tp), 1)}


def _pp_tp_groups(sizes: Dict[str, int]) -> List[List[int]]:
    """The rank lists of the merged ``(pp, tp)`` axes: for each data and
    context index, its ranks pp major, tp minor."""
    pp, dp, cp, tp = (sizes[a] for a in MESH_AXES)
    ids = np.arange(pp * dp * cp * tp).reshape(pp, dp, cp, tp)
    return [list(map(int, row)) for row in
            np.moveaxis(ids, 0, 2).reshape(dp * cp, pp * tp)]


class _ParallelState:
    """The sizes, this process's rank on every axis, and the process group
    (None at size 1) of every axis this process belongs to."""

    def __init__(self) -> None:
        self.sizes: Dict[str, int] = {}
        self.ranks: Dict[str, int] = {}
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        self.members: Dict[str, List[int]] = {}


_STATE = _ParallelState()


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        context_parallel_size: int = 1,
        expert_model_parallel_size: int = 1,
        data_parallel_size: Optional[int] = None) -> Dict[str, int]:
    """Lay the ranks of the default process group out as ``[pp, dp, cp,
    tp]`` and make each axis's groups (reference
    ``parallel_state.py:391``). Without an initialised process group the
    world is this process alone, and every size must be 1. Every rank must
    call it with the same sizes: ``new_group`` is collective. Returns the
    resolved sizes."""
    from ..config import mesh_factorization

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = mesh_factorization(
        world, tensor_parallel_size=tensor_model_parallel_size,
        pipeline_parallel_size=pipeline_model_parallel_size,
        context_parallel_size=context_parallel_size,
        expert_parallel_size=expert_model_parallel_size,
        data_parallel_size=data_parallel_size)
    destroy_model_parallel()
    made: Dict[Tuple[int, ...], dist.ProcessGroup] = {}
    axes = dict(replica_groups(sizes), pp_tp=_pp_tp_groups(sizes))
    for axis, lines in axes.items():
        for line in lines:
            key = tuple(line)
            if len(line) > 1 and key not in made:
                # collective: every rank makes every group, in one order
                made[key] = dist.new_group(list(line))
            if rank in line:
                _STATE.members[axis] = list(line)
                _STATE.ranks[axis] = line.index(rank)
                _STATE.groups[axis] = made.get(key)
    _STATE.members[DATA_AXES] = _STATE.members.pop("zero1")
    _STATE.ranks[DATA_AXES] = _STATE.ranks.pop("zero1")
    _STATE.groups[DATA_AXES] = _STATE.groups.pop("zero1")
    for table in (_STATE.members, _STATE.ranks, _STATE.groups):
        table[PP_TP_AXES] = table.pop("pp_tp")
    _STATE.sizes = dict(sizes, rank=rank)
    return dict(sizes)


def model_parallel_is_initialized() -> bool:
    """Reference: ``parallel_state.py`` ``model_parallel_is_initialized``."""
    return bool(_STATE.sizes)


def destroy_model_parallel() -> None:
    """Forget the layout (reference ``parallel_state.py:1226``). The groups
    themselves live as long as the default process group."""
    _STATE.sizes, _STATE.ranks = {}, {}
    _STATE.groups, _STATE.members = {}, {}


def _require_init() -> None:
    if not _STATE.sizes:
        raise RuntimeError("model parallel state not initialized; call "
                           "initialize_model_parallel() first")


def _key(axis: Axis) -> Axis:
    """An axis name, or a tuple of them: a tuple keeps the axes of size
    above 1, and the merged data axes name their own group."""
    if isinstance(axis, str):
        return axis
    names = tuple(a for a in axis if _size(a) > 1)
    if not names:
        return axis[0]
    if len(names) == 1:
        return names[0]
    if set(names) == set(DATA_AXES):
        return DATA_AXES
    if names == PP_TP_AXES:
        return PP_TP_AXES
    raise ValueError(f"no process group spans the axes {names}")


def _size(axis: str) -> int:
    _require_init()
    return int(_STATE.sizes[axis])


def axis_size(axis: Axis) -> int:
    """The number of ranks along ``axis`` (a product over a tuple)."""
    if isinstance(axis, str):
        return _size(axis)
    return int(np.prod([_size(a) for a in axis]))


def axis_rank(axis: Axis) -> int:
    """This process's index along ``axis``; over a tuple, the flat index
    major to minor, the offset of a dim sharded over those axes."""
    _require_init()
    if isinstance(axis, str):
        return int(_STATE.ranks[axis])
    idx = 0
    for a in axis:
        idx = idx * _size(a) + int(_STATE.ranks[a])
    return idx


def axis_group(axis: Axis) -> Optional[dist.ProcessGroup]:
    """The process group along ``axis``, None where it holds one rank."""
    _require_init()
    return _STATE.groups[_key(axis)] if axis_size(axis) > 1 else None


def axis_members(axis: Axis) -> List[int]:
    """The global ranks of this process's group along ``axis``, in axis
    order."""
    _require_init()
    key = _key(axis)
    return list(_STATE.members[key]) if axis_size(axis) > 1 else [
        int(_STATE.sizes["rank"])]


def get_tensor_model_parallel_size() -> int:
    return _size(TP_AXIS)


def get_pipeline_model_parallel_size() -> int:
    return _size(PP_AXIS)


def get_data_parallel_size() -> int:
    return _size(DP_AXIS)


def get_context_parallel_size() -> int:
    return _size(CP_AXIS)


def get_expert_model_parallel_size() -> int:
    return _size(EP_AXIS)


def get_expert_data_parallel_size() -> int:
    return _size(EXP_DP_AXIS)


def get_world_size() -> int:
    return _size("world")


def get_tensor_model_parallel_rank() -> int:
    return axis_rank(TP_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return axis_rank(PP_AXIS)


def get_data_parallel_rank() -> int:
    return axis_rank(DP_AXIS)


def get_context_parallel_rank() -> int:
    return axis_rank(CP_AXIS)


def get_expert_model_parallel_rank() -> int:
    return axis_rank(EP_AXIS)


def get_expert_data_parallel_rank() -> int:
    return axis_rank(EXP_DP_AXIS)


def get_expert_data_parallel_group() -> Optional[dist.ProcessGroup]:
    """The dp_exp group: the ranks that hold the same expert shard (None
    where one does)."""
    return axis_group(EXP_DP_AXIS)


def coords() -> Dict[str, int]:
    """This process's index on every axis of both views."""
    _require_init()
    return {a: axis_rank(a) for a in MESH_AXES + (EP_AXIS, EXP_DP_AXIS)}


def _replica(axis: str) -> List[List[int]]:
    _require_init()
    return replica_groups(_STATE.sizes)[axis]


def get_tensor_model_parallel_replica_groups() -> List[List[int]]:
    return _replica(TP_AXIS)


def get_data_parallel_replica_groups() -> List[List[int]]:
    return _replica(DP_AXIS)


def get_pipeline_model_parallel_replica_groups() -> List[List[int]]:
    return _replica(PP_AXIS)


def get_context_parallel_replica_groups() -> List[List[int]]:
    return _replica(CP_AXIS)


def get_expert_model_parallel_replica_groups() -> List[List[int]]:
    return _replica(EP_AXIS)


def get_expert_data_parallel_replica_groups() -> List[List[int]]:
    return _replica(EXP_DP_AXIS)


def get_zero1_sharding_replica_groups() -> List[List[int]]:
    """ZeRO-1 shards optimizer state over merged DP x CP (reference
    ``parallel_state.py:1684``)."""
    return _replica("zero1")


def get_context_parallel_ring_pairs() -> List[Tuple[int, int]]:
    """Ring edges ``(src, dst)`` over the cp axis, as cp-axis indices."""
    cp = get_context_parallel_size()
    return [(i, (i + 1) % cp) for i in range(cp)]


def world_size() -> int:
    """The ranks of the default process group: 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default process group: 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def agree(value: float, op: str = "max") -> float:
    """``value`` reduced (``"max"`` or ``"min"``) over every rank of the
    default process group, returned on every rank: the host decisions all
    ranks take together. ``value`` itself in a world of one."""
    if world_size() == 1:
        return value
    ops = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    dev = ("cpu" if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=ops[op])
    return float(t.item())


def barrier() -> None:
    """Wait for every rank of the default process group (nothing in a
    world of one)."""
    if world_size() > 1:
        dist.barrier()


def data_slice(n: int, axes: Sequence[str] = DATA_AXES) -> slice:
    """This rank's rows of a leading dim of ``n`` sharded over ``axes``
    (the reference's ``PartitionSpec("dp")`` batch)."""
    parts = axis_size(tuple(axes))
    if n % parts:
        raise ValueError(f"batch dim {n} not divisible by the "
                         f"{'x'.join(axes)} size {parts}")
    per = n // parts
    start = axis_rank(tuple(axes)) * per
    return slice(start, start + per)
