"""Mixture of experts (counterpart of ``neuronx_distributed_tpu/modules/
moe/``): the routers, the expert bank with capacity and blockwise dispatch,
shared experts, the MoE layer, the config validator and token shuffling."""

from .blockwise import (combine_from_blocks, compute_block_metadata,
                        round_up, scatter_to_blocks)
from .config_validator import validate_moe_config
from .expert_mlps import (ExpertMLPs, build_dispatch_combine, capacity_glu,
                          compute_capacity)
from .model import ROUTERS, MoE, SharedExperts
from .routing import GroupLimitedRouter, RouterSinkhorn, RouterTopK
from .token_shuffling import token_shuffle, token_unshuffle

__all__ = ["ExpertMLPs", "GroupLimitedRouter", "MoE", "ROUTERS",
           "RouterSinkhorn", "RouterTopK", "SharedExperts",
           "build_dispatch_combine", "capacity_glu", "combine_from_blocks",
           "compute_block_metadata", "compute_capacity", "round_up",
           "scatter_to_blocks", "token_shuffle", "token_unshuffle",
           "validate_moe_config"]
