"""BERT with its MLM pretraining head (counterpart of
``neuronx_distributed_tpu/models/bert.py`` at tp=1): learned position and
token-type embeddings, post-LN blocks of bidirectional attention and an
erf-GELU MLP, hidden dropout after each sublayer's projection, and either
an untied ``mlm_head`` or (``mlm_transform``) HF's transform, dense ->
GELU -> LayerNorm, into the word embeddings (tied) plus ``mlm_bias``.

The JAX module makes ``type_embedding`` only when it is called with
``token_type_ids``; the port always holds it, and
:func:`.convert.params_from_jax` gives it zeros for a tree made without
(a forward without token types never reads it). The state dict keeps the
JAX names and layouts (:mod:`.common`). ``scan_layers`` and ``tp_size``
are not fields here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..modules.attention import self_attention
from ..parallel.layers import (GQAQKVColumnParallelLinear, ParallelEmbedding,
                               dropout, embedding_attend)
from ..parallel.loss_functions import causal_lm_loss
from .common import (FamilyModel, LayerDropout, build_serving_model,
                     hidden_generator, layer_norm, linear,
                     random_state_dict)


@dataclass(frozen=True)
class BertConfig:
    """The JAX ``BertConfig``'s fields that one device honours. Dropout is
    active only when the caller passes a ``dropout_generator``."""

    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layernorm_eps: float = 1e-12
    mlm_transform: bool = False
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    use_flash_attention: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_LARGE = BertConfig()


def tiny_bert_config(**kw) -> BertConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, max_seq_len=64)
    base.update(kw)
    return BertConfig(**base)


class BertLayer(nn.Module):
    """Post-LN: ``x = ln_attn(x + drop(o_proj(attn(x))))``, then ``ln_mlp(x
    + drop(down(gelu(up(x)))))``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_heads, cfg.head_dim,
            dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype,
            use_bias=True)
        self.o_proj = linear(cfg, cfg.hidden_size, cfg.hidden_size, device)
        self.ln_attn = layer_norm(cfg, device)
        self.up = linear(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.down = linear(cfg, cfg.intermediate_size, cfg.hidden_size,
                           device)
        self.ln_mlp = layer_norm(cfg, device)

    def forward(self, x: torch.Tensor,
                seeds: Optional[LayerDropout] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s = x.shape[:2]
        attn_drop, hidden = seeds or (None, None)
        gen = hidden_generator(hidden, x.device)
        q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
                   for t in self.qkv(x))
        attn = self_attention(q, k, v, causal=False,
                              use_flash=cfg.use_flash_attention,
                              dropout=attn_drop)
        attn = dropout(self.o_proj(attn.reshape(b, s, -1)),
                       cfg.hidden_dropout, gen)
        x = self.ln_attn(x + attn)
        h = dropout(self.down(F.gelu(self.up(x))), cfg.hidden_dropout, gen)
        return self.ln_mlp(x + h)


class BertForPreTraining(FamilyModel):
    """Encoder and MLM head; :meth:`loss` averages over the labels that are
    not -100. Parameters are allocated uninitialised in ``cfg.param_dtype``
    on ``device`` (None: the card)."""

    def __init__(self, cfg: BertConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        pdt = cfg.param_dtype
        self.cfg = cfg
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                       dtype=cfg.dtype, device=dev,
                                       param_dtype=pdt)
        self.position_embedding = nn.Parameter(torch.empty(
            (cfg.max_seq_len, cfg.hidden_size), dtype=pdt, device=dev))
        self.type_embedding = nn.Parameter(torch.empty(
            (cfg.type_vocab_size, cfg.hidden_size), dtype=pdt, device=dev))
        self.embed_norm = layer_norm(cfg, dev)
        self.layers = nn.ModuleList([BertLayer(cfg, dev)
                                     for _ in range(cfg.num_layers)])
        if cfg.mlm_transform:
            self.mlm_transform = linear(cfg, cfg.hidden_size,
                                        cfg.hidden_size, dev)
            self.mlm_norm = layer_norm(cfg, dev)
            self.mlm_bias = nn.Parameter(torch.empty(
                (cfg.vocab_size,), dtype=pdt, device=dev))
        else:
            self.mlm_head = linear(cfg, cfg.hidden_size, cfg.vocab_size,
                                   dev, use_bias=False)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """MLM logits ``[B, S, V]`` in ``cfg.dtype`` of ``input_ids [B,
        S]``."""
        cfg = self.cfg
        x = self.embed(input_ids)
        x = x + self.position_embedding[None, :x.shape[1]].to(cfg.dtype)
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids.long(),
                                self.type_embedding).to(cfg.dtype)
        x = self.embed_dropout(self.embed_norm(x), dropout_generator)
        x = self.run_layers(x, dropout_generator=dropout_generator)
        if cfg.mlm_transform:
            h = self.mlm_norm(F.gelu(self.mlm_transform(x)))
            logits = embedding_attend(self.embed.embedding, h, cfg.dtype)
            return logits + self.mlm_bias.to(cfg.dtype)
        return self.mlm_head(x)

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -100,
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Mean cross entropy of the masked positions (labels other than
        ``ignore_index``)."""
        return causal_lm_loss(self(input_ids,
                                   dropout_generator=dropout_generator),
                              labels, ignore_index=ignore_index)


def init_state_dict(cfg: BertConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights (:func:`.common.random_state_dict`)."""
    return random_state_dict(BertForPreTraining, cfg, seed, std, device)


def build_model(cfg: BertConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None) -> BertForPreTraining:
    """A frozen model holding ``state_dict`` in ``cfg.dtype``."""
    return build_serving_model(BertForPreTraining, cfg, state_dict, device)
