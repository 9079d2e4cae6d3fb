"""Mixtral, the MoE Llama (counterpart of
``neuronx_distributed_tpu/models/mixtral.py``): the Llama decoder with the
MLP swapped for :class:`..modules.moe.MoE`.

At ``tp_size > 1`` (training across ranks, the reference's explicit form)
the attention is Llama's, the router is whole on every rank, and the
experts and shared experts are sharded over the intermediate width
(:class:`..modules.moe.ExpertMLPs`). Under ``sequence_parallel`` the MoE
sees whole sequences: its input is gathered with ``to_model_parallel=
False`` (backward a split: the bank's ``copy_to`` already sums its input
gradient over tp) and its output split again after (JAX ``:127-155``).

At ``ep_size > 1`` (training across ranks: ``expert_parallel_size`` splits
the data ranks) each rank's expert bank holds ``E / ep`` experts, ``gate_up
[E/ep, H, 2, I/tp]`` and ``down [E/ep, I/tp, H]``, and the bank runs its
expert-parallel dispatch (:class:`..modules.moe.ExpertMLPs`), over the wire
``moe_ep_wire_dtype`` and, with ``moe_overlap_dispatch`` (None: at ep >=
4), the ring (JAX ``:41-47``, ``:143-144``). The JAX GSPMD step computes
the same function over the global batch.

The state dict keeps the JAX names and layouts: per layer
``moe.router.kernel [H, E]`` (held in fp32), ``moe.experts.gate_up [E, H, 2,
I]`` and ``moe.experts.down [E, I, H]`` (or the quantized bank's pairs),
``moe.shared.*`` with shared experts, beside Llama's attention and norm
keys, so :mod:`.convert` maps a JAX Mixtral tree across.

The router is ``top_k``, ``sinkhorn`` or ``group_limited``. Under
``weight_quant`` the experts are quantized in the tier's format unless
``moe_expert_impl`` pins another bank (``moe_expert_impl_``); a quantized
bank needs capacity dispatch, as in JAX.

Training goes through :meth:`MixtralForCausalLM.loss`, the JAX loss: the
causal-LM cross entropy plus the router's load-balance and z losses summed
over the layers, weighted by ``router_aux_coef`` and ``router_z_coef``;
``remat`` recomputes each layer whole. ``tie_embeddings`` (which the
reference refuses too), ``loss_chunk`` (which the reference ignores) and
``lora`` (the reference's Mixtral has no LoRA of its own) raise.
Serving goes through :func:`mixtral_forward_with_cache`, the cached step
of :func:`.llama.cached_forward` over a paged pool or a contiguous cache.
With ``moe_dispatch="blockwise"`` the experts run the grouped GLU: K5 on a
wide step, and K6 with ``sentinel_empty`` metadata on a step so narrow
that ``tokens x top_k <= num_experts`` (all tokens of the batch counted),
as the JAX model decides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike
from ..inference.kv_cache import QuantizedKVCache
from ..modules.moe import ROUTERS, MoE
from ..modules.norms import RMSNorm
from ..parallel import mappings
from ..parallel import mesh as ps
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
    # expert bank: "float" | "int8" | "fp8" | "mx_fp4" | "mx_fp8"
    moe_expert_impl: str = "float"
    router_type: str = "top_k"
    shared_expert_intermediate: int = 0
    # weights of the router's aux losses in the train loss
    router_aux_coef: float = 0.02
    router_z_coef: float = 0.001
    # the expert-parallel wire ("fp32" | "int8" | "fp8", blockwise only)
    # and the ring (None: at ep >= 4); :mod:`..parallel.ep_dispatch`
    moe_ep_wire_dtype: str = "fp32"
    moe_overlap_dispatch: Optional[bool] = None
    # the expert-parallel degree the bank's shards were cut for
    ep_size: int = 1

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.ep_size, int) or self.ep_size < 1:
            raise ValueError(f"ep_size must be a positive int, got "
                             f"{self.ep_size!r}")
        if self.num_experts % self.ep_size:
            raise ValueError(f"num_experts {self.num_experts} not divisible "
                             f"by ep_size {self.ep_size}")
        later = ["tie_embeddings"] if self.tie_embeddings else []
        if self.loss_chunk is not None:
            later.append("loss_chunk")
        if self.lora is not None:
            # the reference's Mixtral would get adapters only in the
            # attention it shares with Llama; the port adds none
            later.append("lora")
        if later:
            raise ValueError(f"{', '.join(later)}: not ported for Mixtral "
                             "yet (a later slice)")
        if self.moe_dispatch not in _DISPATCH_MODES:
            raise ValueError(f"moe_dispatch must be one of {_DISPATCH_MODES}"
                             f", got {self.moe_dispatch!r}")
        if self.router_type not in ROUTERS:
            raise ValueError(f"router_type must be one of {tuple(ROUTERS)}, "
                             f"got {self.router_type!r}")
        if (self.weight_quant is not None
                and self.moe_dispatch != "capacity"
                and self.moe_expert_impl == "float"):
            raise ValueError(
                f"weight_quant={self.weight_quant!r} serves experts "
                "quantized, which requires moe_dispatch='capacity' (got "
                f"{self.moe_dispatch!r}); set moe_dispatch='capacity' or "
                "pin moe_expert_impl explicitly")

    @property
    def moe_expert_impl_(self) -> str:
        """The expert bank in use: a ``weight_quant`` tier quantizes the
        experts too unless ``moe_expert_impl`` was pinned."""
        if self.weight_quant is not None and self.moe_expert_impl == "float":
            return _WEIGHT_QUANT_EXPERT_IMPL[self.weight_quant]
        return self.moe_expert_impl


_DISPATCH_MODES = ("capacity", "blockwise")
# weight_quant tier -> its quantized expert bank
_WEIGHT_QUANT_EXPERT_IMPL = {"int8": "int8", "fp8": "fp8",
                             "mxfp4": "mx_fp4", "mxfp8": "mx_fp8"}


MIXTRAL_8X7B = MixtralConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
    num_experts=8, top_k=2)

# DBRX's widths: 16 fine-grained experts, top-4, GQA with 8 kv heads
DBRX = MixtralConfig(
    vocab_size=100352, hidden_size=6144, intermediate_size=10752,
    num_layers=40, num_heads=48, num_kv_heads=8, rope_theta=5e5,
    max_seq_len=32768, num_experts=16, top_k=4)


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
                       sentinel_empty=cfg.moe_sentinel_empty,
                       expert_impl=cfg.moe_expert_impl_,
                       router_type=cfg.router_type,
                       shared_expert_intermediate=(
                           cfg.shared_expert_intermediate),
                       dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                       device=device, tp_size=cfg.tp, ep_size=cfg.ep_size,
                       ep_wire_dtype=cfg.moe_ep_wire_dtype,
                       ep_overlap=cfg.moe_overlap_dispatch)
        self.sp = cfg.sp

    def forward(self, x, cos, sin, positions,
                view: Optional[llama.CacheView] = None,
                dropout: Optional[llama.Dropout] = None,
                sentinel_empty: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x, aux)``, aux = ``[load_balance_loss, z_loss]``; with a
        cache ``view`` the serving step, without, causal self-attention
        (with attention dropout given ``dropout = (p, seed)``)."""
        x = x + self.attn(self.input_norm(x), cos, sin, positions, view,
                          dropout)
        h = self.post_norm(x)
        if self.sp:
            h = mappings.gather_from_sequence_parallel_region(
                h, ps.TP_AXIS, 1, to_model_parallel=False)
        moe_out, aux = self.moe(h, sentinel_empty)
        if self.sp:
            moe_out = mappings.scatter_to_sequence_parallel_region(
                moe_out, ps.TP_AXIS, 1)
        return x + moe_out, torch.stack([aux["load_balance_loss"],
                                         aux["z_loss"]])


class MixtralForCausalLM(LlamaForCausalLM):
    """Embedding, Mixtral decoder stack, final norm, untied LM head.

    With ``cfg.remat`` each decoder layer is rematerialised with the
    policy ``"nothing"`` whatever ``cfg.remat_policy`` says, as the
    reference wraps its layers in ``nn.remat`` with ``nothing_saveable``:
    the backward recomputes the whole layer, so K2 and K5 run twice a
    layer, K3, K4, K7 and K8 once. The recompute routes every token to the
    same experts (the router's stable sort, in fp32) and rebuilds the same
    block metadata, so the gradients equal those without remat bit for
    bit."""

    layer_cls = MixtralDecoderLayer

    @property
    def layer_remat_policy(self) -> str:
        return "nothing"

    def hidden(self, input_ids: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX ``MixtralModel``: ``(normed hidden [B, S, H], aux)``,
        aux summed over the layers."""
        x = self.embed(input_ids)
        if self.cfg.sp:
            x = mappings.scatter_to_sequence_parallel_region(x, ps.TP_AXIS,
                                                             1)
        cos, sin = self.rope_tables(input_ids.device)
        aux = []
        for layer in self.layers:
            x, a = self.run_layer(layer, x, cos, sin, positions,
                                  dropout_generator)
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
        if labels is None:
            x, aux = self.hidden(input_ids, positions, dropout_generator)
            return self.lm_head(x), aux
        ce, extra = self.loss_parts(input_ids, labels, positions,
                                    ignore_index, dropout_generator)
        return ce + extra

    def loss_parts(self, input_ids: torch.Tensor, labels: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   ignore_index: int = -100,
                   dropout_generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loss as ``(ce, router_aux_coef · aux[0] + router_z_coef ·
        aux[1])``: across data ranks the train step weighs the
        cross-entropy by the rank's share of the counted labels and leaves
        the router's terms, already global or plain means, as they are."""
        x, aux = self.hidden(input_ids, positions, dropout_generator)
        cfg = self.cfg
        ce = causal_lm_loss(self.lm_head(x), labels,
                            ignore_index=ignore_index)
        return ce, cfg.router_aux_coef * aux[0] + cfg.router_z_coef * aux[1]


def build_model(cfg: MixtralConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None) -> MixtralForCausalLM:
    """A frozen serving model in ``cfg.dtype``, the router in fp32
    (:func:`.llama.build_model`); serving runs at tp = ep = 1."""
    if cfg.ep_size > 1:
        raise ValueError(f"serving at ep_size={cfg.ep_size}: not in the "
                         "port yet (a later slice); it serves at ep=1")
    return llama.build_model(cfg, state_dict, device, MixtralForCausalLM)


def init_state_dict(cfg: MixtralConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights (:func:`.llama.init_state_dict`); the router's in
    fp32."""
    return llama.init_state_dict(cfg, seed, std, device, MixtralForCausalLM)


def decode_sentinel_empty(cfg: MixtralConfig, num_tokens: int) -> bool:
    """Whether a step of ``num_tokens`` runs the decode grouped GLU on
    sentinel metadata: blockwise dispatch and ``tokens x top_k <=
    num_experts``, or ``moe_sentinel_empty`` set. It reads the config's
    ``top_k`` whatever the router, as the JAX model does (the Sinkhorn
    router's one choice a token leaves the rule conservative)."""
    return cfg.moe_sentinel_empty or (
        cfg.moe_dispatch == "blockwise"
        and num_tokens * cfg.top_k <= cfg.num_experts)


@torch.no_grad()
def mixtral_forward_with_cache(model: MixtralForCausalLM,
                               input_ids: torch.Tensor,
                               positions: torch.Tensor, kv_cache,
                               slot_ids: Optional[torch.Tensor] = None,
                               return_hidden: bool = False):
    """KV-cached forward of one step, as
    :func:`.llama.llama_forward_with_cache` (same arguments, same in-place
    writes) over a paged pool or a contiguous ``KVCache``. As in JAX there
    is no int8 contiguous cache for Mixtral. Returns ``(logits, cache)``."""
    if isinstance(kv_cache, QuantizedKVCache):
        raise TypeError("Mixtral's contiguous path has no int8 cache")
    sentinel = decode_sentinel_empty(model.cfg,
                                     input_ids.shape[0] * input_ids.shape[1])
    return llama.cached_forward(
        model, input_ids, positions, kv_cache, slot_ids,
        lambda layer, *args: layer(*args, sentinel_empty=sentinel)[0],
        return_hidden)
