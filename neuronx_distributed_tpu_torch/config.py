"""The port's training config (counterpart of the parts of
``neuronx_distributed_tpu/config.py`` that a single-device trainer reads).

Only one device and tensor-parallel size 1 exist until the parallel slice:
:func:`neuronx_distributed_config` raises on anything else, and so does
ZeRO-1, which needs data-parallel ranks to shard over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    """Global-norm clipping of the gradients before AdamW."""

    zero_one_enabled: bool = False
    grad_clipping: bool = True
    max_grad_norm: float = 1.0

    def __post_init__(self) -> None:
        if self.zero_one_enabled:
            raise ValueError("zero_one_enabled needs data-parallel ranks; "
                             "ZeRO-1 comes with the parallel slice")
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

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mixed_precision: MixedPrecisionConfig = field(
        default_factory=MixedPrecisionConfig)
    activation_checkpoint: ActivationCheckpointConfig = field(
        default_factory=ActivationCheckpointConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)


def neuronx_distributed_config(
        tensor_parallel_size: int = 1,
        optimizer_config: Optional[OptimizerConfig] = None,
        activation_checkpoint_config: Optional[
            ActivationCheckpointConfig] = None,
        mixed_precision_config: Optional[MixedPrecisionConfig] = None,
        checkpoint_config: Optional[CheckpointConfig] = None) -> NxDConfig:
    """Build an :class:`NxDConfig`. Only ``tensor_parallel_size=1`` is
    accepted until the parallel slice; there is no mesh to initialise."""
    if tensor_parallel_size != 1:
        raise ValueError(f"tensor_parallel_size={tensor_parallel_size}: the "
                         "port runs tp=1 only until the parallel slice")
    return NxDConfig(
        optimizer=optimizer_config or OptimizerConfig(),
        mixed_precision=mixed_precision_config or MixedPrecisionConfig(),
        activation_checkpoint=(activation_checkpoint_config
                               or ActivationCheckpointConfig()),
        checkpoint=checkpoint_config or CheckpointConfig())


def configure_model(cfg: NxDConfig, model_cfg: Any) -> Any:
    """Carry the framework's knobs into a model config dataclass, as the
    reference's ``configure_model`` (``config.py:17-60``) does for the
    fields the port's configs have: ``remat = activation_checkpoint.mode
    != "none"`` and ``dtype`` from ``mixed_precision.compute_dtype``. The
    policy is not carried (the reference does not carry it either). An MoE
    config is then held to :func:`.modules.moe.validate_moe_config`."""
    updates = {}
    fields = {f.name for f in dataclasses.fields(model_cfg)}
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
