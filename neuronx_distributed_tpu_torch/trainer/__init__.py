"""The single-device train step (counterpart of
``neuronx_distributed_tpu/trainer``)."""

from .optimizer import AdamW, AdamWState, make_optimizer
from .trainer import (ParallelModel, TrainState, initialize_parallel_model,
                      initialize_parallel_optimizer, make_train_step)

__all__ = ["AdamW", "AdamWState", "ParallelModel", "TrainState",
           "initialize_parallel_model", "initialize_parallel_optimizer",
           "make_optimizer", "make_train_step"]
