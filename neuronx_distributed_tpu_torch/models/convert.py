"""Weight bridge from the JAX package's Llama param tree.

The JAX ``LlamaForCausalLM`` tree (``scan_layers=True``) stacks every
decoder layer on a leading dim under ``params/model/layers/layer``, with
``q/k/v_kernel`` ``[L, H, *]``, ``o_proj/kernel``, ``mlp/gate_up_kernel
[L, H, 2, I]`` and ``mlp/down/kernel``. The port keeps the names and
layouts per layer, so the bridge only unstacks and renames. A Mixtral tree
has ``moe/router/kernel [L, H, E]``, ``moe/experts/gate_up [L, E, H, 2, I]``
and ``moe/experts/down [L, E, I, H]`` in place of the MLP. A tied config
(``tie_embeddings``) has no ``lm_head`` in either tree. It reads numpy
arrays and imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .llama import LlamaConfig, LlamaForCausalLM
from .mixtral import MixtralConfig

# port name within layer i -> path under the JAX "layers/layer" subtree
_LAYER_KEYS = {
    "input_norm.scale": ("input_norm", "scale"),
    "attn.qkv.q_kernel": ("attn", "qkv", "q_kernel"),
    "attn.qkv.k_kernel": ("attn", "qkv", "k_kernel"),
    "attn.qkv.v_kernel": ("attn", "qkv", "v_kernel"),
    "attn.o_proj.kernel": ("attn", "o_proj", "kernel"),
    "post_norm.scale": ("post_norm", "scale"),
}
_MLP_KEYS = {
    "mlp.gate_up_kernel": ("mlp", "gate_up_kernel"),
    "mlp.down.kernel": ("mlp", "down", "kernel"),
}
_MOE_KEYS = {
    "moe.router.kernel": ("moe", "router", "kernel"),
    "moe.experts.gate_up": ("moe", "experts", "gate_up"),
    "moe.experts.down": ("moe", "experts", "down"),
}


def _get(tree: Mapping[str, Any], path) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def params_from_jax(cfg: LlamaConfig,
                    tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LlamaForCausalLM`` or ``MixtralForCausalLM`` params (numpy
    arrays, with or without the outer ``"params"`` key) -> the port's state
    dict, in the tree's own dtype."""
    p = tree.get("params", tree)
    if ("lm_head" in p) == cfg.tie_embeddings:
        raise ValueError(
            f"the tree {'has' if 'lm_head' in p else 'has no'} lm_head but "
            f"the config has tie_embeddings={cfg.tie_embeddings}")
    model, layers = p["model"], p["model"]["layers"]["layer"]

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a))   # a writable copy

    sd = {"embed.embedding": tensor(_get(model, ("embed", "embedding"))),
          "norm.scale": tensor(_get(model, ("norm", "scale")))}
    if not cfg.tie_embeddings:
        sd["lm_head.kernel"] = tensor(_get(p, ("lm_head", "kernel")))
    ffn = _MOE_KEYS if isinstance(cfg, MixtralConfig) else _MLP_KEYS
    for name, path in {**_LAYER_KEYS, **ffn}.items():
        stacked = _get(layers, path)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"{'/'.join(path)} stacks {stacked.shape[0]} "
                             f"layers, config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            sd[f"layers.{i}.{name}"] = tensor(stacked[i])
    return sd


def load_jax_params(model: LlamaForCausalLM,
                    tree: Mapping[str, Any]) -> LlamaForCausalLM:
    """Copy a JAX param tree into ``model`` (cast to its dtype and
    device)."""
    model.load_state_dict(params_from_jax(model.cfg, tree), strict=True)
    return model
