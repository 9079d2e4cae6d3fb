"""MoE configuration validation (counterpart of
``neuronx_distributed_tpu/modules/moe/config_validator.py``): incoherent
MoE knobs raise at configure time with the JAX validator's messages,
instead of surfacing as shape errors inside a step.

With the framework config it also holds ``num_experts`` to the
expert-parallel size and ``intermediate_size`` to the tensor-parallel
size, and ``moe_overlap_dispatch=True`` to an expert-parallel size above
1, as JAX does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

logger = logging.getLogger(__name__)

_DISPATCH_MODES = ("capacity", "blockwise")
_EXPERT_IMPLS = ("float", "int8", "fp8", "mx_fp4", "mx_fp8")
_ROUTER_TYPES = ("top_k", "sinkhorn", "group_limited")
_WIRE_DTYPES = ("fp32", "int8", "fp8")

MX_BLOCK = 32


def validate_moe_config(model_cfg: Any, parallel_cfg: Optional[Any] = None):
    """Validate an MoE model config (any dataclass with ``num_experts``;
    others pass through) and return it unchanged. Raises ``ValueError``
    where the JAX validator raises; ``parallel_cfg`` is the framework
    config, whose expert- and tensor-parallel sizes the bank's widths must
    divide."""
    f = {fl.name for fl in dataclasses.fields(model_cfg)}
    if "num_experts" not in f:
        return model_cfg

    e = model_cfg.num_experts
    k = getattr(model_cfg, "top_k", 1)
    if e < 1:
        raise ValueError(f"num_experts must be >= 1, got {e}")
    if not (1 <= k <= e):
        raise ValueError(
            f"top_k {k} must lie in [1, num_experts={e}]. Please adjust "
            "your configuration.")

    dispatch = getattr(model_cfg, "moe_dispatch", "capacity")
    if dispatch not in _DISPATCH_MODES:
        raise ValueError(
            f"moe_dispatch must be one of {_DISPATCH_MODES}, got "
            f"{dispatch!r}")
    router = getattr(model_cfg, "router_type", "top_k")
    if router not in _ROUTER_TYPES:
        raise ValueError(
            f"router_type must be one of {_ROUTER_TYPES}, got {router!r}")

    cap = getattr(model_cfg, "capacity_factor", None)
    if dispatch == "blockwise":
        bs = getattr(model_cfg, "moe_block_size", 0)
        if bs < 1:
            raise ValueError(
                f"blockwise dispatch requires moe_block_size >= 1, got {bs}")
        if cap is not None and cap not in (0.0, 2.0):
            logger.warning(
                "blockwise (dropless) dispatch ignores capacity_factor "
                "(got %s)", cap)
    else:
        if cap is not None and cap <= 0.0:
            raise ValueError(
                "capacity dispatch requires capacity_factor > 0.0 "
                f"(got {cap}); use moe_dispatch='blockwise' for dropless. "
                "Please adjust your configuration.")
        if getattr(model_cfg, "moe_sentinel_empty", False):
            raise ValueError(
                "moe_sentinel_empty (decode weight-DMA elision) only "
                "applies to moe_dispatch='blockwise'")

    wire = getattr(model_cfg, "moe_ep_wire_dtype", "fp32")
    if wire not in _WIRE_DTYPES:
        raise ValueError(
            f"moe_ep_wire_dtype must be one of {_WIRE_DTYPES}, got "
            f"{wire!r}. Please adjust your configuration.")
    overlap = getattr(model_cfg, "moe_overlap_dispatch", None)
    if overlap not in (None, True, False):
        raise ValueError(
            "moe_overlap_dispatch must be None (auto), True, or False, "
            f"got {overlap!r}")
    if dispatch != "blockwise":
        if wire != "fp32":
            raise ValueError(
                f"moe_ep_wire_dtype={wire!r} requires "
                "moe_dispatch='blockwise' (the quantized EP wire rides the "
                f"dropless token dispatch); got moe_dispatch={dispatch!r}. "
                "Please adjust your configuration.")
        if overlap is True:
            raise ValueError(
                "moe_overlap_dispatch=True requires "
                "moe_dispatch='blockwise' (the ppermute-ring dispatch is "
                f"the blockwise-EP token gather); got "
                f"moe_dispatch={dispatch!r}")
    if overlap is True and parallel_cfg is not None:
        ep = parallel_cfg.parallel.expert_parallel_size
        if ep <= 1:
            raise ValueError(
                "moe_overlap_dispatch=True requires expert_parallel_size "
                f"> 1 (got ep={ep}): a single EP rank has no dispatch to "
                "decompose. Use None (auto) or raise expert_parallel_size.")

    impl = getattr(model_cfg, "moe_expert_impl", "float")
    if impl not in _EXPERT_IMPLS:
        raise ValueError(
            f"moe_expert_impl must be one of {_EXPERT_IMPLS}, got {impl!r}")
    if impl.startswith("mx_"):
        h = getattr(model_cfg, "hidden_size", 0)
        i = getattr(model_cfg, "intermediate_size", 0)
        if h % MX_BLOCK or i % MX_BLOCK:
            raise ValueError(
                f"MX expert banks need hidden_size ({h}) and "
                f"intermediate_size ({i}) divisible by the MX block "
                f"({MX_BLOCK})")

    if parallel_cfg is not None:
        p = parallel_cfg.parallel
        ep = p.expert_parallel_size
        tp = p.tensor_parallel_size
        if ep > 1 and e % ep != 0:
            raise ValueError(
                f"num_experts {e} not divisible by expert_parallel_size "
                f"{ep}. Please adjust your configuration.")
        i = getattr(model_cfg, "intermediate_size", 0)
        if tp > 1 and i % tp != 0:
            raise ValueError(
                f"intermediate_size {i} not divisible by "
                f"tensor_parallel_size {tp}")
    return model_cfg
