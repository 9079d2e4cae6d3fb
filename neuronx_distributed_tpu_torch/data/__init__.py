"""Data loading (counterpart of ``neuronx_distributed_tpu/data``): the
native C++ prefetch loader and its numpy path."""

from .native_loader import TokenBatchLoader

__all__ = ["TokenBatchLoader"]
