"""The port's training config (counterpart of the parts of
``neuronx_distributed_tpu/config.py`` that the port's trainer reads).

:func:`neuronx_distributed_config` lays the ranks of the default
``torch.distributed`` process group out as the mesh (tensor and data
parallel, ZeRO-1 over the data ranks, and pipeline parallel with a
:class:`PipelineConfig`, expert parallel over the data ranks); context
parallelism, collective-matmul overlap and activation compression wait
for later slices and raise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


def mesh_factorization(
    world: int,
    tensor_parallel_size: int = 1,
    pipeline_parallel_size: int = 1,
    context_parallel_size: int = 1,
    expert_parallel_size: int = 1,
    data_parallel_size: Optional[int] = None,
    dcn_data_parallel_size: Optional[int] = None,
) -> dict:
    """Validate a factorization of ``world`` ranks and return the resolved
    axis sizes ``{pp, dp, cp, tp, ep, dp_exp, dcn_dp, world}``, with the
    reference's messages (JAX ``config.py:63``)."""
    tp, pp, cp, ep = (tensor_parallel_size, pipeline_parallel_size,
                      context_parallel_size, expert_parallel_size)
    denom = tp * pp * cp
    if world % denom != 0:
        raise ValueError(
            f"world size {world} not divisible by tp*pp*cp = {denom}")
    dp = world // denom
    if data_parallel_size is not None and data_parallel_size != dp:
        raise ValueError(
            f"explicit data_parallel_size {data_parallel_size} inconsistent "
            f"with world {world} / (tp*pp*cp) = {dp}")
    if (dp * cp) % ep != 0:
        raise ValueError(
            f"dp*cp = {dp * cp} not divisible by expert parallel size {ep}")
    dcn_dp = dcn_data_parallel_size or 1
    if dcn_dp > 1 and dp % dcn_dp != 0:
        raise ValueError(
            f"dp {dp} not divisible by dcn_data_parallel_size {dcn_dp}")
    return dict(pp=pp, dp=dp, cp=cp, tp=tp, ep=ep, dp_exp=dp * cp // ep,
                dcn_dp=dcn_dp, world=world)


@dataclass(frozen=True)
class ParallelConfig:
    """The mesh's degrees (the reference's ``ParallelConfig``, for the
    fields the port has); data parallel is the world over the rest.
    Tensor, pipeline, data and expert parallelism run (expert parallelism
    splits the data ranks, ``dp*cp % ep == 0``, and ``dp_exp = dp*cp/ep``
    ranks replicate each expert shard). ``moe_ep_wire_dtype`` (``"fp32"``,
    ``"int8"``, ``"fp8"``) and ``moe_overlap_dispatch`` (None: the ring at
    ep >= 4; True, False) pick the expert-parallel dispatch
    (:mod:`.parallel.ep_dispatch`), with the reference's checks. A
    context degree above 1 raises, and so do ``tp_overlap_comm=True`` and
    a compressed ``tp_activation_comm_dtype``."""

    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    context_parallel_size: int = 1
    expert_parallel_size: int = 1
    tp_overlap_comm: Optional[bool] = None
    tp_activation_comm_dtype: str = "fp32"
    moe_ep_wire_dtype: str = "fp32"
    moe_overlap_dispatch: Optional[bool] = None

    def __post_init__(self) -> None:
        for f in ("tensor_parallel_size", "pipeline_parallel_size",
                  "context_parallel_size", "expert_parallel_size"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{f} must be a positive int, got {v!r}")
        if self.moe_ep_wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"moe_ep_wire_dtype must be one of {_WIRE_DTYPES}, "
                f"got {self.moe_ep_wire_dtype!r}")
        if self.moe_overlap_dispatch not in (None, True, False):
            raise ValueError(
                "moe_overlap_dispatch must be None (auto), True, or False, "
                f"got {self.moe_overlap_dispatch!r}")
        if (self.moe_overlap_dispatch is True
                and self.expert_parallel_size <= 1):
            raise ValueError(
                "moe_overlap_dispatch=True requires expert_parallel_size > "
                f"1 (got ep={self.expert_parallel_size}): with a single EP "
                "rank there is no dispatch to decompose — use None (auto) "
                "or raise expert_parallel_size")
        later = [f"context_parallel_size={self.context_parallel_size}"
                 ] if self.context_parallel_size != 1 else []
        if self.tp_overlap_comm:
            later.append("tp_overlap_comm=True")
        if self.tp_activation_comm_dtype != "fp32":
            later.append("tp_activation_comm_dtype="
                         f"{self.tp_activation_comm_dtype!r}")
        if later:
            raise ValueError(f"{', '.join(later)}: not in the port yet (a "
                             "later slice); it runs tensor, pipeline, "
                             "expert and data parallelism")
        if self.pipeline_parallel_size > 1 and self.expert_parallel_size > 1:
            raise ValueError(
                f"pipeline_parallel_size={self.pipeline_parallel_size} x "
                f"expert_parallel_size={self.expert_parallel_size}: not in "
                "the port yet (a later slice); the pipeline executors run "
                "the experts at ep = 1")


#: the wire dtypes of the expert-parallel dispatch (those of
#: :mod:`.parallel.wire_codec`)
_WIRE_DTYPES = ("fp32", "int8", "fp8")

#: the schedules :class:`PipelineConfig` names (JAX ``config.py:269``)
PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved", "inference")


@dataclass(frozen=True)
class PipelineConfig:
    """The reference's ``pipeline_config`` (JAX ``config.py:269``): the
    microbatches a step splits its batch into and the schedule's name,
    which :func:`..models.llama_pipeline.make_pipeline_grad_fn` takes.
    ``manual_cut_points`` takes only its default ``()``: the JAX package
    reads it nowhere, and the port cuts the layers evenly (the first
    stages take one more where the count does not divide)."""

    num_microbatches: int = 1
    schedule: str = "1f1b"
    manual_cut_points: tuple = ()

    def __post_init__(self) -> None:
        if not isinstance(self.num_microbatches, int) \
                or self.num_microbatches < 1:
            raise ValueError("num_microbatches must be a positive int, got "
                             f"{self.num_microbatches!r}")
        if self.schedule not in PIPELINE_SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {self.schedule!r}; "
                             f"options {list(PIPELINE_SCHEDULES)}")
        object.__setattr__(self, "manual_cut_points",
                           tuple(self.manual_cut_points))
        if self.manual_cut_points != ():
            raise ValueError(
                f"PipelineConfig.manual_cut_points="
                f"{self.manual_cut_points!r}: nothing reads it; only the "
                "default () is accepted")


@dataclass(frozen=True)
class OptimizerConfig:
    """Global-norm clipping of the gradients before AdamW; with
    ``zero_one_enabled`` the Adam moments are sharded over the data ranks
    (ZeRO-1, :mod:`.trainer.optimizer`)."""

    zero_one_enabled: bool = False
    grad_clipping: bool = True
    max_grad_norm: float = 1.0

    def __post_init__(self) -> None:
        if self.grad_clipping and self.max_grad_norm <= 0:
            raise ValueError(
                "max_grad_norm must be positive when grad_clipping is "
                f"enabled, got {self.max_grad_norm!r}")


def _only_defaults(cfg: Any, names: tuple, why: str) -> None:
    """Raise on a field of ``names`` set to anything but its default: the
    port reads none of them, and an option that does not work raises."""
    for f in dataclasses.fields(cfg):
        if f.name in names and getattr(cfg, f.name) != f.default:
            raise ValueError(
                f"{type(cfg).__name__}.{f.name}={getattr(cfg, f.name)!r}: "
                f"{why}; only the default {f.default!r} is accepted")


@dataclass(frozen=True)
class MixedPrecisionConfig:
    """The reference's ``mixed_precision_config``. ``compute_dtype`` names
    the dtype of products and activations (a ``torch`` attribute name),
    which :func:`configure_model` carries into the model. The other fields
    are there for the reference's signature and take only their defaults:
    the parameters stay in their own dtype (fp32 by default), gradients
    accumulate in it, and bf16 parameters get fp32 masters through
    :func:`~.trainer.mixed_precision.with_fp32_master_weights`."""

    use_master_weights: bool = True
    use_fp32_grad_acc: bool = True
    use_master_weights_in_ckpt: bool = False
    compute_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        _only_defaults(self, ("use_master_weights", "use_fp32_grad_acc",
                              "use_master_weights_in_ckpt"),
                       "the port's trainer does not read it")


@dataclass(frozen=True)
class ActivationCheckpointConfig:
    """Remat selection. ``mode`` is one of ``"none"``, ``"full"``,
    ``"attention"``, ``"custom"``; any mode but ``"none"`` turns on the
    model's ``remat`` (:func:`configure_model`). ``policy`` is carried as
    the reference carries it and not propagated: the model's
    ``remat_policy`` picks what is saved (:mod:`.utils.remat`)."""

    mode: str = "none"
    policy: Optional[str] = None


@dataclass(frozen=True)
class CheckpointConfig:
    """The reference's checkpoint options, there for its signature. No
    trainer reads them (nor does the reference's): checkpointing is set on
    :class:`~.trainer.loop.CheckpointCallback` (``path``, ``every``,
    ``num_kept``), so every field takes only its default."""

    output_dir: str = "checkpoints"
    save_interval: int = 0      # 0 = disabled
    keep_last: int = -1         # -1 = keep all (the num_kept argument)
    async_save: bool = True
    use_master_weights_in_ckpt: bool = False

    def __post_init__(self) -> None:
        _only_defaults(self, tuple(f.name for f in dataclasses.fields(self)),
                       "set checkpointing on CheckpointCallback")


@dataclass(frozen=True)
class NxDConfig:
    """Top-level config of the port's trainer."""

    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mixed_precision: MixedPrecisionConfig = field(
        default_factory=MixedPrecisionConfig)
    activation_checkpoint: ActivationCheckpointConfig = field(
        default_factory=ActivationCheckpointConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    sequence_parallel: bool = False


def neuronx_distributed_config(
        tensor_parallel_size: int = 1,
        pipeline_parallel_size: int = 1,
        context_parallel_size: int = 1,
        expert_parallel_size: int = 1,
        pipeline_config: Optional[PipelineConfig] = None,
        optimizer_config: Optional[OptimizerConfig] = None,
        activation_checkpoint_config: Optional[
            ActivationCheckpointConfig] = None,
        mixed_precision_config: Optional[MixedPrecisionConfig] = None,
        checkpoint_config: Optional[CheckpointConfig] = None,
        sequence_parallel: bool = False,
        init_mesh: bool = True, tp_overlap_comm: Optional[bool] = None,
        tp_activation_comm_dtype: str = "fp32",
        moe_ep_wire_dtype: str = "fp32",
        moe_overlap_dispatch: Optional[bool] = None) -> NxDConfig:
    """Build an :class:`NxDConfig` and, by default, lay the ranks out
    (:func:`.parallel.mesh.initialize_model_parallel`), as the reference
    does (JAX ``config.py:356``). The world is the default
    ``torch.distributed`` process group (``dist.get_world_size()``); with
    none initialised it is this process alone, so a tensor- or
    data-parallel degree above 1 raises. ``init_mesh=False`` only builds
    the config."""
    cfg = NxDConfig(
        parallel=ParallelConfig(
            tensor_parallel_size=tensor_parallel_size,
            pipeline_parallel_size=pipeline_parallel_size,
            context_parallel_size=context_parallel_size,
            expert_parallel_size=expert_parallel_size,
            tp_overlap_comm=tp_overlap_comm,
            tp_activation_comm_dtype=tp_activation_comm_dtype,
            moe_ep_wire_dtype=moe_ep_wire_dtype,
            moe_overlap_dispatch=moe_overlap_dispatch),
        optimizer=optimizer_config or OptimizerConfig(),
        pipeline=pipeline_config or PipelineConfig(),
        mixed_precision=mixed_precision_config or MixedPrecisionConfig(),
        activation_checkpoint=(activation_checkpoint_config
                               or ActivationCheckpointConfig()),
        checkpoint=checkpoint_config or CheckpointConfig(),
        sequence_parallel=sequence_parallel)
    if init_mesh:
        import torch.distributed as dist

        from .parallel import mesh

        if not dist.is_initialized() and (tensor_parallel_size > 1
                                          or pipeline_parallel_size > 1
                                          or expert_parallel_size > 1):
            raise ValueError(
                f"tensor_parallel_size={tensor_parallel_size} x "
                f"pipeline_parallel_size={pipeline_parallel_size} x "
                f"expert_parallel_size={expert_parallel_size} needs "
                "that many ranks, and no torch.distributed process group is "
                "initialised: start the ranks first "
                "(utils.cpu_mesh.run_ranks), or pass init_mesh=False")
        mesh.initialize_model_parallel(
            tensor_model_parallel_size=tensor_parallel_size,
            pipeline_model_parallel_size=pipeline_parallel_size,
            context_parallel_size=context_parallel_size,
            expert_model_parallel_size=expert_parallel_size)
    return cfg


def configure_model(cfg: NxDConfig, model_cfg: Any) -> Any:
    """Carry the framework's knobs into a model config dataclass, as the
    reference's ``configure_model`` (``config.py:17-60``) does for the
    fields the port's configs have: ``sequence_parallel``, ``remat =
    activation_checkpoint.mode != "none"``, ``dtype`` from
    ``mixed_precision.compute_dtype`` and ``tp_size`` from
    ``parallel.tensor_parallel_size``, and for a config that has them
    ``ep_size``, ``moe_ep_wire_dtype`` and ``moe_overlap_dispatch`` from
    ``parallel`` (JAX ``config.py:46-49``). The policy is not carried (the
    reference does not carry it either). An MoE config is then held to
    :func:`.modules.moe.validate_moe_config`."""
    updates = {}
    fields = {f.name for f in dataclasses.fields(model_cfg)}
    if "sequence_parallel" in fields:
        updates["sequence_parallel"] = cfg.sequence_parallel
    if "tp_size" in fields:
        updates["tp_size"] = cfg.parallel.tensor_parallel_size
    if "ep_size" in fields:
        updates["ep_size"] = cfg.parallel.expert_parallel_size
    if "moe_ep_wire_dtype" in fields:
        updates["moe_ep_wire_dtype"] = cfg.parallel.moe_ep_wire_dtype
    if "moe_overlap_dispatch" in fields:
        updates["moe_overlap_dispatch"] = cfg.parallel.moe_overlap_dispatch
    if "remat" in fields:
        updates["remat"] = cfg.activation_checkpoint.mode != "none"
    if "dtype" in fields:
        dtype = getattr(torch, cfg.mixed_precision.compute_dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError("unknown compute_dtype "
                             f"{cfg.mixed_precision.compute_dtype!r}")
        updates["dtype"] = dtype
    model_cfg = dataclasses.replace(model_cfg, **updates)
    if "num_experts" in fields:
        from .modules.moe.config_validator import validate_moe_config

        model_cfg = validate_moe_config(model_cfg, cfg)
    return model_cfg
