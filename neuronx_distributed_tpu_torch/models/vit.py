"""ViT image classification (counterpart of
``neuronx_distributed_tpu/models/vit.py`` at tp=1): patch embedding as one
dense projection of the patches (``patchify``, the math of a stride-``p``
convolution), a CLS token and learned positions, pre-LN blocks of
bidirectional attention and an erf-GELU MLP, and a classifier on the CLS
row in fp32.

ViT-Base/16 runs S = 197 at head_dim 64; ViT-Huge/14 S = 257 at head_dim 80,
which the flash path pads to the kernels' 128
(:func:`..ops.flash_attention.flash_attention`). The state dict keeps the
JAX names and layouts (:mod:`.common`). ``scan_layers`` and ``tp_size`` are
not fields here. Serving goes through ``inference.model_builder``'s
``image_encoder`` bundle function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..modules.attention import self_attention
from ..parallel.layers import GQAQKVColumnParallelLinear, dropout
from .common import (FamilyModel, LayerDropout, build_serving_model,
                     hidden_generator, layer_norm, linear,
                     random_state_dict)


@dataclass(frozen=True)
class ViTConfig:
    """The JAX ``ViTConfig``'s fields that one device honours. Dropout is
    active only when the caller passes a ``dropout_generator``."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_labels: int = 1000
    layernorm_eps: float = 1e-12
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    use_flash_attention: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def __post_init__(self) -> None:
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} must be divisible by "
                f"patch_size {self.patch_size}")


# the reference example's three documented targets
VIT_BASE = ViTConfig()
VIT_LARGE = ViTConfig(hidden_size=1024, intermediate_size=4096,
                      num_layers=24, num_heads=16)
VIT_HUGE = ViTConfig(hidden_size=1280, intermediate_size=5120,
                     num_layers=32, num_heads=16, patch_size=14)


def tiny_vit_config(**kw) -> ViTConfig:
    base = dict(image_size=16, patch_size=8, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=4,
                num_labels=8)
    base.update(kw)
    return ViTConfig(**base)


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, N, C*p*p]`` patch vectors in row-major
    patch order, each in (c, i, j) order (a flattened Conv2d kernel ``[H,
    C, p, p]``)."""
    b, c, h, w = pixel_values.shape
    x = pixel_values.reshape(b, c, h // patch, patch, w // patch, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // patch) * (w // patch), c * patch * patch)


class ViTLayer(nn.Module):
    """Pre-LN: ``x + drop(o_proj(attn(ln_before(x))))``, then ``x +
    drop(down(gelu(up(ln_after(x)))))``."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_before = layer_norm(cfg, device)
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_heads, cfg.head_dim,
            dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype,
            use_bias=True)
        self.o_proj = linear(cfg, cfg.hidden_size, cfg.hidden_size, device)
        self.ln_after = layer_norm(cfg, device)
        self.up = linear(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.down = linear(cfg, cfg.intermediate_size, cfg.hidden_size,
                           device)

    def forward(self, x: torch.Tensor,
                seeds: Optional[LayerDropout] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s = x.shape[:2]
        attn_drop, hidden = seeds or (None, None)
        gen = hidden_generator(hidden, x.device)
        q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
                   for t in self.qkv(self.ln_before(x)))
        attn = self_attention(q, k, v, causal=False,
                              use_flash=cfg.use_flash_attention,
                              dropout=attn_drop)
        x = x + dropout(self.o_proj(attn.reshape(b, s, -1)),
                        cfg.hidden_dropout, gen)
        h = self.down(F.gelu(self.up(self.ln_after(x))))
        return x + dropout(h, cfg.hidden_dropout, gen)


class ViTForImageClassification(FamilyModel):
    """Patch embedding, CLS token, the encoder and a classifier on the CLS
    row. Parameters are allocated uninitialised in ``cfg.param_dtype`` on
    ``device`` (None: the card)."""

    def __init__(self, cfg: ViTConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        pdt = cfg.param_dtype
        self.cfg = cfg
        self.patch_proj = linear(
            cfg, cfg.num_channels * cfg.patch_size ** 2, cfg.hidden_size, dev)
        self.cls_token = nn.Parameter(torch.empty(
            (1, 1, cfg.hidden_size), dtype=pdt, device=dev))
        self.position_embedding = nn.Parameter(torch.empty(
            (cfg.num_patches + 1, cfg.hidden_size), dtype=pdt, device=dev))
        self.layers = nn.ModuleList([ViTLayer(cfg, dev)
                                     for _ in range(cfg.num_layers)])
        self.final_norm = layer_norm(cfg, dev)
        self.classifier = linear(cfg, cfg.hidden_size, cfg.num_labels, dev)

    def encode(self, pixel_values: torch.Tensor,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """``[B, C, H, W]`` -> final hidden states ``[B, N + 1, hidden]``
        in ``cfg.dtype``."""
        cfg = self.cfg
        x = self.patch_proj(patchify(pixel_values.to(cfg.dtype),
                                     cfg.patch_size))
        cls = self.cls_token.to(cfg.dtype).expand(x.shape[0], 1,
                                                  cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding[None].to(cfg.dtype)
        x = self.embed_dropout(x, dropout_generator)
        x = self.run_layers(x, dropout_generator=dropout_generator)
        return self.final_norm(x)

    def forward(self, pixel_values: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """fp32 logits ``[B, num_labels]`` of the CLS row."""
        x = self.encode(pixel_values, dropout_generator)
        return self.classifier(x[:, 0]).float()

    def loss(self, pixel_values: torch.Tensor, labels: torch.Tensor,
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Mean softmax cross entropy over ``[B]`` integer labels."""
        logp = torch.log_softmax(self(pixel_values, dropout_generator), -1)
        return -torch.mean(torch.take_along_dim(
            logp, labels.long()[:, None], dim=-1))


def init_state_dict(cfg: ViTConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights (:func:`.common.random_state_dict`)."""
    return random_state_dict(ViTForImageClassification, cfg, seed, std,
                             device)


def build_model(cfg: ViTConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None) -> ViTForImageClassification:
    """A frozen model holding ``state_dict`` in ``cfg.dtype``."""
    return build_serving_model(ViTForImageClassification, cfg, state_dict,
                               device)
