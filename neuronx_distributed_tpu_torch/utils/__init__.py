"""Host-side utilities (counterpart of ``neuronx_distributed_tpu/utils``)."""
