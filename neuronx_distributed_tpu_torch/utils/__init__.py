"""Host-side utilities (counterpart of ``neuronx_distributed_tpu/utils``).

Submodules import on use: ``batch_utils``, ``bfloat16``, ``logger``,
``remat``, ``tensor_capture``, ``timeline``."""
