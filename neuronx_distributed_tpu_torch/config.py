"""The port's training config (counterpart of the parts of
``neuronx_distributed_tpu/config.py`` that a single-device train step
reads).

Only one device and tensor-parallel size 1 exist until the parallel slice:
:func:`neuronx_distributed_config` raises on anything else, and so does
ZeRO-1, which needs data-parallel ranks to shard over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


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


@dataclass(frozen=True)
class NxDConfig:
    """Top-level config of the port's trainer."""

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


def neuronx_distributed_config(tensor_parallel_size: int = 1,
                               optimizer_config: Optional[OptimizerConfig]
                               = None) -> NxDConfig:
    """Build an :class:`NxDConfig`. Only ``tensor_parallel_size=1`` is
    accepted until the parallel slice; there is no mesh to initialise."""
    if tensor_parallel_size != 1:
        raise ValueError(f"tensor_parallel_size={tensor_parallel_size}: the "
                         "port runs tp=1 only until the parallel slice")
    return NxDConfig(optimizer=optimizer_config or OptimizerConfig())
