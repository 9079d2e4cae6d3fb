"""Weight bridge from the JAX package's param trees: Llama and Mixtral,
and the GPT-NeoX, BERT and ViT families.

The JAX ``LlamaForCausalLM`` tree (``scan_layers=True``) stacks every
decoder layer on a leading dim under ``params/model/layers/layer``. The
port keeps the names and layouts per layer, and a port name is the JAX path
under the layer joined by dots (``attn/qkv/q_kernel`` is
``layers.{i}.attn.qkv.q_kernel``, ``moe/experts/gate_up`` is
``layers.{i}.moe.experts.gate_up``), so the bridge only unstacks and
renames, whatever the layer holds: the MLP or the MoE (router, experts,
shared experts), float or quantized (``*_q``, ``*_packed`` and ``*_scale``
leaves cross by name), with or without LoRA adapters (``*lora_a``,
``*lora_b``, in the layers, the embedding and the LM head). A tied config (``tie_embeddings``) has no
``lm_head`` in either tree. A draft model crosses like any model;
:func:`medusa_params_from_jax` carries Medusa heads across.

The GPT-NeoX, BERT and ViT trees stack their layers under
``params/layers/layer`` beside leaves of their own (``embed``,
``position_embedding``, ``type_embedding``, ``mlm_bias``, ``cls_token``,
``patch_proj``, ``classifier``, the norms and heads), which keep their JAX
path joined by dots.

It reads numpy arrays and imports nothing of JAX nor ``ml_dtypes``: an
fp8 or bf16 array (an ``ml_dtypes`` type) crosses as its bits, viewed as
the torch type of the same name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from .bert import BertConfig
from .gpt_neox import GPTNeoXConfig
from .llama import LlamaConfig, LlamaForCausalLM
from .vit import ViTConfig

#: the configs whose trees stack their layers under ``params/layers/layer``
FAMILY_CONFIGS = (GPTNeoXConfig, BertConfig, ViTConfig)

# numpy dtype name of an ml_dtypes array -> (the numpy integer type of its
# bits, the torch dtype)
_ML_DTYPES = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "float8_e5m2": (np.uint8, torch.float8_e5m2),
              "bfloat16": (np.uint16, torch.bfloat16)}


def _tensor(a: Any) -> torch.Tensor:
    """A writable torch copy of a numpy (or JAX) array."""
    a = np.asarray(a)
    bits = _ML_DTYPES.get(a.dtype.name)
    if bits is not None:
        return torch.from_numpy(np.array(a.view(bits[0]))).view(bits[1])
    return torch.from_numpy(np.array(a))


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unstack(cfg, path: Tuple[str, ...], stacked: Any
             ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(layers.{i}.<path>, tensor)`` of one leaf stacked over the layers."""
    stacked = np.asarray(stacked)
    if stacked.shape[0] != cfg.num_layers:
        raise ValueError(f"{'/'.join(path)} stacks {stacked.shape[0]} "
                         f"layers, config has {cfg.num_layers}")
    name = ".".join(path)
    for i in range(cfg.num_layers):
        yield f"layers.{i}.{name}", _tensor(stacked[i])


def _family_params_from_jax(cfg, p: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """A GPT-NeoX, BERT or ViT tree (``scan_layers=True``). A BERT tree
    made without token types has no ``type_embedding``: it gets zeros,
    which a forward without ``token_type_ids`` never reads."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _leaves(p):
        if path[:2] == ("layers", "layer"):
            sd.update(_unstack(cfg, path[2:], a))
        else:
            sd[".".join(path)] = _tensor(a)
    if isinstance(cfg, BertConfig) and "type_embedding" not in sd:
        table = sd["embed.embedding"]
        sd["type_embedding"] = torch.zeros(
            (cfg.type_vocab_size, table.shape[1]), dtype=table.dtype)
    return sd


def params_from_jax(cfg: LlamaConfig,
                    tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LlamaForCausalLM``, ``MixtralForCausalLM``,
    ``GPTNeoXForCausalLM``, ``BertForPreTraining`` or
    ``ViTForImageClassification`` params (numpy arrays, with or without the
    outer ``"params"`` key) -> the port's state dict, in the tree's own
    dtypes. ``cfg`` names the family."""
    p = tree.get("params", tree)
    if isinstance(cfg, FAMILY_CONFIGS):
        return _family_params_from_jax(cfg, p)
    if ("lm_head" in p) == cfg.tie_embeddings:
        raise ValueError(
            f"the tree {'has' if 'lm_head' in p else 'has no'} lm_head but "
            f"the config has tie_embeddings={cfg.tie_embeddings}")
    model = p["model"]
    sd = {"norm.scale": _tensor(model["norm"]["scale"])}
    # the embedding table, and a LoRA config's adapters beside it and the
    # LM head's kernel
    for sub, tree in (("embed", model["embed"]),
                      ("lm_head", p.get("lm_head", {}))):
        for path, a in _leaves(tree, (sub,)):
            sd[".".join(path)] = _tensor(a)
    for path, stacked in _leaves(model["layers"]["layer"]):
        sd.update(_unstack(cfg, path, stacked))
    return sd


def load_jax_params(model: LlamaForCausalLM,
                    tree: Mapping[str, Any]) -> LlamaForCausalLM:
    """Copy a JAX param tree into ``model`` (cast to its dtype and
    device)."""
    model.load_state_dict(params_from_jax(model.cfg, tree), strict=True)
    return model


def medusa_params_from_jax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``MedusaHeads`` params (with or without the outer ``"params"``
    key: ``res_{k}/{kernel,bias}``, ``head_{k}/kernel``) -> the state dict
    of the port's :class:`..inference.speculative.MedusaHeads` (the same
    names joined by dots, the same layouts)."""
    return {".".join(path): _tensor(a)
            for path, a in _leaves(tree.get("params", tree))}
