"""The train step, on one device or across ranks, and the ``Trainer`` loop
(counterpart of ``neuronx_distributed_tpu/trainer``)."""

from .loop import Callback, CheckpointCallback, MetricsLogger, Trainer
from .mixed_precision import with_fp32_master_weights
from .optimizer import AdamW, AdamWState, make_optimizer
from .trainer import (ParallelModel, TrainState, data_parallel_loss,
                      initialize_parallel_model,
                      initialize_parallel_optimizer, make_train_step,
                      trainable)

__all__ = ["AdamW", "AdamWState", "Callback", "CheckpointCallback",
           "MetricsLogger", "ParallelModel", "TrainState", "Trainer",
           "data_parallel_loss",
           "initialize_parallel_model", "initialize_parallel_optimizer",
           "make_optimizer", "make_train_step", "trainable",
           "with_fp32_master_weights"]
