"""What the GPT-NeoX, BERT and ViT families share: the layer loop with
remat and dropout seeds, hidden dropout, random and served weights.

The JAX package builds each of these families from the same parallel
layers and the same scan over layers; the port's modules keep the JAX
names and layouts (``layers.{i}.<JAX path under layers/layer>``), so
:func:`.convert.params_from_jax` crosses their trees by unstacking the
layer dim.

Dropout is on when the caller passes a ``dropout_generator`` (training),
as flax's is when a ``"dropout"`` rng is given. Each layer draws two seeds
from it before it runs, so that a rematerialised layer draws the same
masks again: one for attention dropout (the flash kernels' counter hash,
the JAX package's mask for the same seed) and one for hidden dropout,
whose masks come from a ``torch.Generator`` seeded with it (flax draws
them from its rng: the masks differ from JAX's, their keep rate and
``1 / (1 - p)`` scaling do not).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..modules.attention import attention_dropout_seed
from ..modules.norms import LayerNorm
from ..parallel.layers import Linear, dropout
from ..utils.remat import remat_call

#: ``(p, seed)`` of one dropout site, as ``attention_dropout_seed`` draws it
Dropout = Tuple[float, Optional[int]]
#: a layer's ``(attention dropout, hidden dropout)``
LayerDropout = Tuple[Dropout, Dropout]


def linear(cfg, n_in: int, n_out: int, device, use_bias: bool = True
           ) -> Linear:
    """A family's projection: biased unless told otherwise, weights in
    ``cfg.param_dtype``, computed in ``cfg.dtype``."""
    return Linear(n_in, n_out, dtype=cfg.dtype, device=device,
                  param_dtype=cfg.param_dtype, use_bias=use_bias)


def layer_norm(cfg, device) -> LayerNorm:
    """A family's LayerNorm over ``cfg.hidden_size`` with its epsilon."""
    return LayerNorm(cfg.hidden_size, cfg.layernorm_eps, dtype=cfg.dtype,
                     device=device, param_dtype=cfg.param_dtype)


def hidden_generator(dropout: Optional[Dropout], device: torch.device
                     ) -> Optional[torch.Generator]:
    """The generator of a layer's hidden-dropout masks, seeded with the
    seed drawn for it (None when that dropout is off)."""
    if dropout is None or dropout[0] <= 0.0:
        return None
    return torch.Generator(device=device).manual_seed(dropout[1])


class FamilyModel(nn.Module):
    """Base of the three families' top modules: ``self.cfg`` and
    ``self.layers`` (an ``nn.ModuleList`` whose layers take ``(x, *args,
    seeds)``, the layer's two dropout seeds)."""

    cfg = None
    layers: nn.ModuleList

    def run_layers(self, x: torch.Tensor, *args,
                   dropout_generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Every layer in turn, each rematerialised whole with
        ``cfg.remat`` (the ``"nothing"`` policy: JAX's
        ``nothing_saveable``). The layer's two dropout seeds are drawn
        before it runs."""
        cfg = self.cfg
        for layer in self.layers:
            seeds = (attention_dropout_seed(cfg.attention_dropout,
                                            dropout_generator),
                     attention_dropout_seed(
                         getattr(cfg, "hidden_dropout", 0.0),
                         dropout_generator))
            if cfg.remat:
                x = remat_call(layer, x, *args, seeds, policy="nothing")
            else:
                x = layer(x, *args, seeds)
        return x

    def embed_dropout(self, x: torch.Tensor,
                      dropout_generator: Optional[torch.Generator]
                      ) -> torch.Tensor:
        """The hidden dropout after the embeddings (BERT, ViT)."""
        d = attention_dropout_seed(self.cfg.hidden_dropout, dropout_generator)
        return dropout(x, d[0], hidden_generator(d, x.device))


def random_state_dict(model_cls, cfg, seed: int = 0, std: float = 0.02,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights of ``model_cls(cfg)`` from a ``torch.Generator``
    seeded with ``seed``, made on ``device`` in each parameter's dtype:
    normal(0, ``std``) kernels and embeddings, ones for LayerNorm scales,
    zeros for biases and the CLS token."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    for name, t in model_cls(cfg, device="meta").state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            sd[name] = torch.ones(t.shape, dtype=t.dtype, device=dev)
        elif leaf.endswith("bias") or leaf == "cls_token":
            sd[name] = torch.zeros(t.shape, dtype=t.dtype, device=dev)
        else:
            sd[name] = torch.randn(t.shape, generator=gen, dtype=t.dtype,
                                   device=dev).mul_(std)
    return sd


def build_serving_model(model_cls, cfg, state_dict: Dict[str, torch.Tensor],
                        device: DeviceLike = None) -> nn.Module:
    """A frozen model whose parameters are ``state_dict``'s tensors moved
    to ``device`` and ``cfg.dtype`` (no copy where they already are):
    serving holds its weights in the compute dtype."""
    dev = resolve_device(device)
    model = model_cls(replace(cfg, param_dtype=cfg.dtype), device="meta")
    model.load_state_dict({k: v.to(device=dev, dtype=cfg.dtype)
                           for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model.requires_grad_(False)
