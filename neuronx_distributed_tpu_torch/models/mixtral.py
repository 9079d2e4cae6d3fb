"""Mixtral, the MoE Llama (counterpart of
``neuronx_distributed_tpu/models/mixtral.py`` at tp = ep = 1): the Llama
decoder with the MLP swapped for :class:`..modules.moe.MoE`.

The state dict keeps the JAX names and layouts: per layer
``moe.router.kernel [H, E]`` (held in fp32), ``moe.experts.gate_up [E, H, 2,
I]`` and ``moe.experts.down [E, I, H]``, beside Llama's attention and norm
keys, so :mod:`.convert` maps a JAX Mixtral tree across.

Training goes through :meth:`MixtralForCausalLM.loss`, the JAX loss: the
causal-LM cross entropy plus the router's load-balance and z losses summed
over the layers, weighted by ``router_aux_coef`` and ``router_z_coef``.
Serving goes through :func:`mixtral_forward_with_cache`, the paged step of
:func:`.llama.paged_forward`. With ``moe_dispatch="blockwise"`` the experts
run the grouped GLU: K5 on a wide step, and K6 with ``sentinel_empty``
metadata on a step so narrow that ``tokens x top_k <= num_experts``, as the
JAX model decides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike
from ..inference.paging import PagedCacheView, PagedKVCache
from ..modules.moe import MoE
from ..modules.norms import RMSNorm
from ..parallel.loss_functions import causal_lm_loss
from . import llama
from .llama import LlamaAttention, LlamaConfig, LlamaForCausalLM


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    """The fields of the JAX ``MixtralConfig`` that this port honours."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    # "capacity" (mask einsums, may drop) or "blockwise" (dropless)
    moe_dispatch: str = "capacity"
    moe_block_size: int = 512
    # blocks of no real row become sentinels (forward only)
    moe_sentinel_empty: bool = False
    router_type: str = "top_k"
    # weights of the router's aux losses in the train loss
    router_aux_coef: float = 0.02
    router_z_coef: float = 0.001

    def __post_init__(self):
        if self.moe_dispatch not in ("capacity", "blockwise"):
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}")
        if self.router_type != "top_k":
            raise ValueError(f"router_type {self.router_type!r} is not "
                             "ported; only 'top_k' is")


MIXTRAL_8X7B = MixtralConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
    num_experts=8, top_k=2)


def tiny_moe_config(**kw) -> MixtralConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
                num_experts=4, top_k=2)
    base.update(kw)
    return MixtralConfig(**base)


class MixtralDecoderLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                  device, cfg.param_dtype)
        self.attn = LlamaAttention(cfg, device)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                 device, cfg.param_dtype)
        self.moe = MoE(cfg.num_experts, cfg.hidden_size,
                       cfg.intermediate_size, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       dispatch_mode=cfg.moe_dispatch,
                       block_size=cfg.moe_block_size,
                       sentinel_empty=cfg.moe_sentinel_empty, dtype=cfg.dtype,
                       param_dtype=cfg.param_dtype, device=device)

    def forward(self, x, cos, sin, positions,
                view: Optional[PagedCacheView] = None,
                dropout_generator: Optional[torch.Generator] = None,
                sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x, aux)``, aux = ``[load_balance_loss, z_loss]``; with a
        paged ``view`` the serving step, without, causal self-attention
        (with attention dropout given a ``dropout_generator``)."""
        x = x + self.attn(self.input_norm(x), cos, sin, positions, view,
                          dropout_generator)
        moe_out, aux = self.moe(self.post_norm(x), sentinel_empty)
        return x + moe_out, torch.stack([aux["load_balance_loss"],
                                         aux["z_loss"]])


class MixtralForCausalLM(LlamaForCausalLM):
    """Embedding, Mixtral decoder stack, final norm, untied LM head."""

    layer_cls = MixtralDecoderLayer

    def hidden(self, input_ids: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX ``MixtralModel``: ``(normed hidden [B, S, H], aux)``,
        aux summed over the layers."""
        x = self.embed(input_ids)
        cos, sin = self.rope_tables(input_ids.device)
        aux = []
        for layer in self.layers:
            x, a = layer(x, cos, sin, positions, None, dropout_generator)
            aux.append(a)
        return self.norm(x), torch.stack(aux).sum(0)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                ignore_index: int = -100,
                dropout_generator: Optional[torch.Generator] = None):
        """``(logits [B, S, V], aux [2])``, or, given ``labels`` (the
        next-token ids, already shifted), the JAX ``MixtralForCausalLM.loss``
        (``models/mixtral.py:315``): ``ce + router_aux_coef · aux[0] +
        router_z_coef · aux[1]``, ce the mean causal-LM loss over the labels
        that are not ``ignore_index``. ``loss`` (inherited) calls this."""
        x, aux = self.hidden(input_ids, positions, dropout_generator)
        logits = self.lm_head(x)
        if labels is None:
            return logits, aux
        cfg = self.cfg
        ce = causal_lm_loss(logits, labels, ignore_index=ignore_index)
        return ce + cfg.router_aux_coef * aux[0] + cfg.router_z_coef * aux[1]


def build_model(cfg: MixtralConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None) -> MixtralForCausalLM:
    """A frozen serving model in ``cfg.dtype``, the router in fp32
    (:func:`.llama.build_model`)."""
    return llama.build_model(cfg, state_dict, device, MixtralForCausalLM)


def init_state_dict(cfg: MixtralConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights (:func:`.llama.init_state_dict`); the router's in
    fp32."""
    return llama.init_state_dict(cfg, seed, std, device, MixtralForCausalLM)


def decode_sentinel_empty(cfg: MixtralConfig, num_tokens: int) -> bool:
    """Whether a step of ``num_tokens`` runs the decode grouped GLU on
    sentinel metadata: blockwise dispatch and ``tokens x top_k <=
    num_experts``, or ``moe_sentinel_empty`` set."""
    return cfg.moe_sentinel_empty or (
        cfg.moe_dispatch == "blockwise"
        and num_tokens * cfg.top_k <= cfg.num_experts)


@torch.no_grad()
def mixtral_forward_with_cache(model: MixtralForCausalLM,
                               input_ids: torch.Tensor,
                               positions: torch.Tensor,
                               kv_cache: PagedKVCache,
                               slot_ids: torch.Tensor):
    """Paged-pool forward of one packed step, as
    :func:`.llama.llama_forward_with_cache` (same arguments, same in-place
    pool writes); returns ``(logits [1, T, V], kv_cache)``."""
    sentinel = decode_sentinel_empty(model.cfg,
                                     input_ids.shape[0] * input_ids.shape[1])
    return llama.paged_forward(
        model, input_ids, positions, kv_cache, slot_ids,
        lambda layer, *args: layer(*args, sentinel_empty=sentinel)[0])
