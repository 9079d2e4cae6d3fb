"""The single-device train step and the ``Trainer`` loop (counterpart of
``neuronx_distributed_tpu/trainer``)."""

from .loop import Callback, CheckpointCallback, MetricsLogger, Trainer
from .mixed_precision import with_fp32_master_weights
from .optimizer import AdamW, AdamWState, make_optimizer
from .trainer import (ParallelModel, TrainState, initialize_parallel_model,
                      initialize_parallel_optimizer, make_train_step)

__all__ = ["AdamW", "AdamWState", "Callback", "CheckpointCallback",
           "MetricsLogger", "ParallelModel", "TrainState", "Trainer",
           "initialize_parallel_model", "initialize_parallel_optimizer",
           "make_optimizer", "make_train_step", "with_fp32_master_weights"]
