"""Mixture of experts (counterpart of ``neuronx_distributed_tpu/modules/
moe/``): the top-k router, the expert bank with capacity and blockwise
dispatch, and the MoE layer."""

from .blockwise import (combine_from_blocks, compute_block_metadata,
                        round_up, scatter_to_blocks)
from .expert_mlps import ExpertMLPs, build_dispatch_combine, compute_capacity
from .model import MoE
from .routing import RouterTopK

__all__ = ["ExpertMLPs", "MoE", "RouterTopK", "build_dispatch_combine",
           "combine_from_blocks", "compute_block_metadata",
           "compute_capacity", "round_up", "scatter_to_blocks"]
