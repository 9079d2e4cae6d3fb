"""GPT-NeoX (counterpart of ``neuronx_distributed_tpu/models/gpt_neox.py``
at tp=1): parallel residual (``x + attn(ln1(x)) + mlp(ln2(x))``, or the
sequential form), LayerNorm with bias, partial rotary (``rotary_pct`` of
each head), biased projections, causal attention.

GPT-NeoX-20B's heads are 96 wide (6144 / 64): the flash path pads them to
the kernels' 128 (:func:`..ops.flash_attention.flash_attention`). The
state dict keeps the JAX names and layouts (:mod:`.common`). The JAX
config's ``sequence_parallel``, ``scan_layers`` and ``tp_size`` are not
fields here: the port runs one device and unrolls its layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..modules.attention import (apply_partial_rotary, precompute_rope,
                                 self_attention)
from ..parallel.layers import GQAQKVColumnParallelLinear, ParallelEmbedding
from ..parallel.loss_functions import causal_lm_loss
from .common import (FamilyModel, LayerDropout, build_serving_model,
                     layer_norm, linear, random_state_dict)


@dataclass(frozen=True)
class GPTNeoXConfig:
    """The JAX ``GPTNeoXConfig``'s fields that one device honours.
    ``attention_dropout`` is active only when the caller passes a
    ``dropout_generator``; ``remat`` recomputes each layer whole."""

    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_layers: int = 44
    num_heads: int = 64
    max_seq_len: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layernorm_eps: float = 1e-5
    use_parallel_residual: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    use_flash_attention: bool = False
    attention_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        """Rotated slice of each head (even; 0 disables rotary)."""
        return (int(self.head_dim * self.rotary_pct) // 2) * 2


GPT_NEOX_20B = GPTNeoXConfig()


def tiny_neox_config(**kw) -> GPTNeoXConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=256,
                num_layers=2, num_heads=4, max_seq_len=128)
    base.update(kw)
    return GPTNeoXConfig(**base)


class NeoXAttention(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_heads, cfg.head_dim,
            dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype,
            use_bias=True)
        self.o_proj = linear(cfg, cfg.num_heads * cfg.head_dim,
                             cfg.hidden_size, device)

    def forward(self, x, cos, sin, positions, dropout) -> torch.Tensor:
        cfg = self.cfg
        b, s = x.shape[:2]
        q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
                   for t in self.qkv(x))
        q = apply_partial_rotary(q, cos, sin, cfg.rotary_dim, positions)
        k = apply_partial_rotary(k, cos, sin, cfg.rotary_dim, positions)
        out = self_attention(q, k, v, causal=True,
                             use_flash=cfg.use_flash_attention,
                             dropout=dropout)
        return self.o_proj(out.reshape(b, s, -1))


class NeoXMLP(nn.Module):
    """``down(gelu(up(x)))`` with the erf GELU, both projections biased."""

    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.up = linear(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.down = linear(cfg, cfg.intermediate_size, cfg.hidden_size,
                           device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x)))


class NeoXLayer(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layer_norm(cfg, device)
        self.attn = NeoXAttention(cfg, device)
        self.ln2 = layer_norm(cfg, device)
        self.mlp = NeoXMLP(cfg, device)

    def forward(self, x, cos, sin, positions,
                dropout: Optional[LayerDropout] = None) -> torch.Tensor:
        attn_out = self.attn(self.ln1(x), cos, sin, positions,
                             dropout[0] if dropout else None)
        if self.cfg.use_parallel_residual:
            return x + attn_out + self.mlp(self.ln2(x))
        x = x + attn_out
        return x + self.mlp(self.ln2(x))


class GPTNeoXForCausalLM(FamilyModel):
    """Embedding, the layers, the final LayerNorm and an unbiased LM head.
    Parameters are allocated uninitialised in ``cfg.param_dtype`` on
    ``device`` (None: the card): load a state dict or make one
    (:func:`init_state_dict`)."""

    def __init__(self, cfg: GPTNeoXConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                       dtype=cfg.dtype, device=dev,
                                       param_dtype=cfg.param_dtype)
        self.layers = nn.ModuleList([NeoXLayer(cfg, dev)
                                     for _ in range(cfg.num_layers)])
        self.final_norm = layer_norm(cfg, dev)
        self.lm_head = linear(cfg, cfg.hidden_size, cfg.vocab_size, dev,
                              use_bias=False)
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def rope_tables(self, device: torch.device):
        """fp32 cos/sin ``[max_seq_len, max(2, rotary_dim) / 2]``, made once
        per device."""
        if self._rope is None or self._rope[0].device != device:
            cfg = self.cfg
            self._rope = precompute_rope(max(2, cfg.rotary_dim),
                                         cfg.max_seq_len, cfg.rope_theta,
                                         device=device)
        return self._rope

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in ``cfg.dtype`` of ``input_ids [B, S]``;
        rotary positions default to ``arange(S)``."""
        x = self.embed(input_ids)
        cos, sin = self.rope_tables(input_ids.device)
        x = self.run_layers(x, cos, sin, positions,
                            dropout_generator=dropout_generator)
        return self.lm_head(self.final_norm(x))

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -100,
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Mean causal-LM cross entropy over the labels (already shifted)
        that are not ``ignore_index``."""
        return causal_lm_loss(self(input_ids,
                                   dropout_generator=dropout_generator),
                              labels, ignore_index=ignore_index)


def init_state_dict(cfg: GPTNeoXConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights (:func:`.common.random_state_dict`)."""
    return random_state_dict(GPTNeoXForCausalLM, cfg, seed, std, device)


def build_model(cfg: GPTNeoXConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None) -> GPTNeoXForCausalLM:
    """A frozen model holding ``state_dict`` in ``cfg.dtype``."""
    return build_serving_model(GPTNeoXForCausalLM, cfg, state_dict, device)
