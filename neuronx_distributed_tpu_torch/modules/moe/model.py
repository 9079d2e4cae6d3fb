"""The MoE layer: router, expert bank and optional shared experts
(counterpart of ``MoE`` and ``SharedExperts`` in
``neuronx_distributed_tpu/modules/moe/model.py``).

The expert bank follows ``expert_impl``: ``"float"`` (:class:`ExpertMLPs`,
capacity or blockwise dispatch), ``"int8"``/``"fp8"``
(:class:`...quantization.quantization_layers.QuantizedExpertMLPs`) or
``"mx_fp4"``/``"mx_fp8"`` (:class:`...quantization.mx_layers.MXExpertMLPs`).
The quantized banks have the capacity path only, and refuse blockwise
dispatch as the JAX layer does; they are not sharded by the port, so they
refuse tp or ep above 1. ``ep_wire_dtype`` and ``ep_overlap`` reach the
float bank's expert-parallel dispatch (JAX ``model.py:66-67``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops import blockwise_moe as ops_bw
from ...parallel import mappings
from ...parallel import mesh as ps
from ...parallel.layers import RowParallelLinear
from .expert_mlps import ExpertMLPs
from .routing import GroupLimitedRouter, RouterSinkhorn, RouterTopK

ROUTERS = {
    "top_k": RouterTopK,
    "sinkhorn": RouterSinkhorn,
    "group_limited": GroupLimitedRouter,
}
EXPERT_IMPLS = ("float", "int8", "fp8", "mx_fp4", "mx_fp8")


class SharedExperts(nn.Module):
    """An always-on dense GLU added to the routed output:
    ``gate_up_kernel [H, 2, I]`` and ``down.kernel [I, H]``, held in
    ``param_dtype`` and used in ``dtype``; at ``tp_size > 1`` column- then
    row-parallel over I (``[H, 2, I/tp]``, ``[I/tp, H]``), as JAX's."""

    def __init__(self, hidden: int, intermediate: int,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None, device=None,
                 tp_size: int = 1):
        super().__init__()
        self.dtype = dtype
        self.gate_up_kernel = nn.Parameter(torch.empty(
            (hidden, 2, intermediate // tp_size), dtype=param_dtype or dtype,
            device=device))
        self.down = RowParallelLinear(intermediate, hidden, dtype=dtype,
                                      device=device, param_dtype=param_dtype,
                                      tp_size=tp_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = mappings.copy_to_tensor_parallel_region(x, ps.TP_AXIS)
        g = torch.einsum("th,hki->tki", x.to(self.dtype),
                         self.gate_up_kernel.to(self.dtype))
        return self.down(ops_bw._silu(g[..., 0, :]) * g[..., 1, :])


def _expert_bank(impl: str, num_experts: int, hidden: int,
                 intermediate: int, capacity_factor: float,
                 dispatch_mode: str, block_size: int, sentinel_empty: bool,
                 dtype: torch.dtype, param_dtype: Optional[torch.dtype],
                 device, tp_size: int = 1, ep_size: int = 1,
                 ep_wire_dtype: str = "fp32",
                 ep_overlap: Optional[bool] = None) -> nn.Module:
    if impl not in EXPERT_IMPLS:
        raise ValueError(f"unknown expert_impl {impl!r}")
    if impl == "float":
        return ExpertMLPs(
            num_experts, hidden, intermediate,
            capacity_factor=capacity_factor, dispatch_mode=dispatch_mode,
            block_size=block_size, sentinel_empty=sentinel_empty,
            dtype=dtype, param_dtype=param_dtype, device=device,
            tp_size=tp_size, ep_size=ep_size, ep_wire_dtype=ep_wire_dtype,
            ep_overlap=ep_overlap)
    if tp_size > 1 or ep_size > 1:
        raise ValueError(f"expert_impl={impl!r} at tp_size={tp_size}, "
                         f"ep_size={ep_size}: the quantized banks are not "
                         "sharded by the port")
    if dispatch_mode != "capacity":
        raise ValueError(
            f"expert_impl={impl!r} supports only dispatch_mode='capacity' "
            f"(got {dispatch_mode!r}); use float experts for "
            "blockwise/dropless dispatch")
    if impl.startswith("mx_"):
        from ...quantization.mx_layers import MXExpertMLPs

        return MXExpertMLPs(num_experts, hidden, intermediate,
                            capacity_factor=capacity_factor,
                            mx_format=impl[len("mx_"):], dtype=dtype,
                            device=device)
    from ...quantization.quantization_layers import QuantizedExpertMLPs
    from ...quantization.quantization_utils import QuantizedDtype

    return QuantizedExpertMLPs(
        num_experts, hidden, intermediate, capacity_factor=capacity_factor,
        quantized_dtype=(QuantizedDtype.INT8 if impl == "int8"
                         else QuantizedDtype.FP8E4M3),
        dtype=dtype, device=device)


class MoE(nn.Module):
    """Mixture-of-experts block over flat ``[T, H]`` or ``[B, S, H]``
    inputs. Returns ``(y, aux)``, aux holding the router's
    ``load_balance_loss`` and ``z_loss`` and the experts'
    ``dropped_fraction``. The Sinkhorn router takes no ``top_k`` (it picks
    one expert); the bank reads the router's width from its choices. At
    ``tp_size > 1`` the router is whole on every rank and sees every
    token; the expert bank and the shared experts are sharded over I. At
    ``ep_size > 1`` the bank holds ``E / ep_size`` experts (the router
    stays whole)."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 dispatch_mode: str = "capacity", block_size: int = 512,
                 sentinel_empty: bool = False, expert_impl: str = "float",
                 router_type: str = "top_k",
                 shared_expert_intermediate: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None, device=None,
                 tp_size: int = 1, ep_size: int = 1,
                 ep_wire_dtype: str = "fp32",
                 ep_overlap: Optional[bool] = None):
        super().__init__()
        if router_type not in ROUTERS:
            raise ValueError(f"router_type must be one of {tuple(ROUTERS)}, "
                             f"got {router_type!r}")
        self.hidden = hidden
        router_kw = {} if router_type == "sinkhorn" else {"top_k": top_k}
        self.router = ROUTERS[router_type](hidden, num_experts,
                                           device=device, **router_kw)
        self.experts = _expert_bank(
            expert_impl, num_experts, hidden, intermediate, capacity_factor,
            dispatch_mode, block_size, sentinel_empty, dtype, param_dtype,
            device, tp_size, ep_size, ep_wire_dtype, ep_overlap)
        self.shared = (SharedExperts(hidden, shared_expert_intermediate,
                                     dtype, param_dtype, device, tp_size)
                       if shared_expert_intermediate > 0 else None)

    def forward(self, x: torch.Tensor, sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        flat = x.reshape(-1, self.hidden)
        gates, idx, aux = self.router(flat)
        y, eaux = self.experts(flat, gates, idx, sentinel_empty)
        aux.update(eaux)
        if self.shared is not None:
            y = y + self.shared(flat)
        return y.reshape(x.shape), aux
