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

Tensor and expert parallelism: :func:`param_specs` is the reference's
partition-spec table of a Llama or a Mixtral (which dim of each parameter
shards over tp, and over ep: Mixtral's experts over their intermediate
width and, at ``ep_size > 1``, their expert dim; its router whole),
:func:`shard_state_dict` takes a rank's shards of a whole state dict by
its coords and :func:`gather_state_dict` puts the ranks' shards back
together;
:func:`params_from_jax` given ``coords`` hands a rank its shards of JAX's
tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from dataclasses import replace

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


TP = "tp"
EP = "ep"
Spec = Tuple[Optional[str], ...]


def _ep_size(cfg: LlamaConfig) -> int:
    return getattr(cfg, "ep_size", 1)


def _llama_spec(cfg: LlamaConfig, name: str, ndim: int) -> Spec:
    """The partition spec of one Llama or Mixtral parameter at ``cfg``'s
    tp and ep (JAX ``nn.get_partition_spec`` of the same model, per layer;
    the expert bank's ``ep`` dim is whole, None, at ep = 1)."""
    leaf = name.split(".")[-1]
    owner = name.split(".")[-2] if "." in name else ""
    ep = EP if _ep_size(cfg) > 1 else None
    if name == "embed.embedding":
        return (TP, None)
    if owner == "router" and leaf == "kernel":
        return (None, None)
    if owner == "experts" and leaf == "gate_up":
        return (ep, None, None, TP)
    if owner == "experts" and leaf == "down":
        return (ep, TP, None)
    if leaf == "scale":
        return (None,)
    if owner == "qkv" and leaf == "q_kernel":
        return (None, TP)
    if owner == "qkv" and leaf in ("k_kernel", "v_kernel"):
        # the kv kernels stay whole when tp exceeds the kv heads (JAX
        # GQAQKVColumnParallelLinear: kv_size_multiplier > 1)
        return (None, None) if cfg.tp > cfg.num_kv_heads else (None, TP)
    if leaf == "gate_up_kernel":
        return (None, None, TP)
    if name.endswith(("o_proj.kernel", "down.kernel")):
        return (TP, None)
    if name == "lm_head.kernel":
        return (None, TP)
    raise ValueError(f"no partition spec for {name!r} (rank {ndim}) at "
                     f"tp_size={cfg.tp}: the sharded Llama and Mixtral "
                     "have no such parameter")


def param_specs(cfg: LlamaConfig,
                names: Optional[List[Tuple[str, int]]] = None
                ) -> Dict[str, Spec]:
    """``{name: spec}`` for every parameter of a Llama or Mixtral ``cfg``
    (or the ``(name, ndim)`` pairs given): per dim None, ``"tp"`` or
    ``"ep"`` (the expert banks' expert dim at ``ep_size > 1``), the
    reference's ``nn.get_partition_spec`` of the same model (its scanned
    leaves without the layer dim). LoRA and the quantized tiers are not
    sharded by the port and raise."""
    from .mixtral import MixtralConfig, MixtralForCausalLM

    if type(cfg) not in (LlamaConfig, MixtralConfig) \
            or cfg.lora is not None or cfg.weight_quant is not None:
        raise ValueError("the port shards plain Llama and Mixtral configs "
                         "only (no LoRA or weight_quant)")
    if names is None:
        full = replace(cfg, tp_size=None, sequence_parallel=False,
                       **({"ep_size": 1} if _ep_size(cfg) > 1 else {}))
        cls = (MixtralForCausalLM if isinstance(cfg, MixtralConfig)
               else LlamaForCausalLM)
        names = [(n, t.dim()) for n, t in cls(
            full, device="meta").state_dict().items()]
    return {n: _llama_spec(cfg, n, nd) for n, nd in names}


def sequence_parallel_names(cfg: LlamaConfig,
                            names: List[str]) -> List[str]:
    """The parameters replicated over tp whose layers see
    sequence-sharded activations under ``cfg.sequence_parallel`` (the
    norms; not Mixtral's router, which sees the gathered sequence): their
    gradients are summed over tp
    (:func:`..parallel.grads.allreduce_gradients`)."""
    if not cfg.sp:
        return []
    return [n for n in names if n.endswith("norm.scale")]


def _sizes(cfg: LlamaConfig) -> Dict[str, int]:
    return {TP: cfg.tp, EP: _ep_size(cfg)}


def shard_state_dict(cfg: LlamaConfig, sd: Mapping[str, torch.Tensor],
                     coords: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """The shards (copies, so the whole tensors can be freed) of the whole
    state dict ``sd`` that the rank at ``coords`` (``{"tp": i, "ep": j}``,
    a missing axis 0) holds, by :func:`param_specs` at ``cfg.tp`` and
    ``cfg.ep_size``; replicated tensors are copied whole."""
    specs = param_specs(cfg, [(n, t.dim()) for n, t in sd.items()])
    return {name: shard_tensor(name, t, specs[name], _sizes(cfg), coords)
            for name, t in sd.items()}


def shard_tensor(name: str, t: torch.Tensor, spec: Spec,
                 sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> torch.Tensor:
    """The shard (a copy) of the whole tensor ``t`` that the rank at
    ``coords`` holds under ``spec`` over axes of ``sizes`` (each a
    mapping by axis name); the whole of it where the spec shards no dim
    over an axis above 1."""
    for d, a in enumerate(spec):
        n = sizes.get(a, 1) if isinstance(a, str) else 1
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"{name} dim {d} ({t.shape[d]}) not divisible "
                             f"by {a} {n}")
        m = t.shape[d] // n
        t = t.narrow(d, int(coords.get(a, 0)) * m, m)
    return t.clone()


def gather_state_dict(cfg: LlamaConfig,
                      shards: List[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict`: ``shards[ep_rank * tp +
    tp_rank]`` is the dict of the rank at those coords (``shards[r]`` the
    tp rank ``r``'s at ep = 1); sharded tensors are concatenated along
    their sharded dims, replicated ones taken from the first rank."""
    sizes = _sizes(cfg)
    tp, ep = sizes[TP], sizes[EP]
    if len(shards) != tp * ep:
        raise ValueError(f"{len(shards)} shards for tp_size {tp} x ep_size "
                         f"{ep}")
    specs = param_specs(cfg, [(n, t.dim()) for n, t in shards[0].items()])
    out = {}
    for name, t in shards[0].items():
        spec = specs[name]
        dims = {a: d for d, a in enumerate(spec) if sizes.get(a, 1) > 1}
        if not dims:
            out[name] = t.clone()
            continue

        def whole_tp(e):
            if TP not in dims:
                return shards[e * tp][name]
            return torch.cat([shards[e * tp + r][name] for r in range(tp)],
                             dim=dims[TP])
        out[name] = (torch.cat([whole_tp(e) for e in range(ep)],
                               dim=dims[EP]) if EP in dims
                     else whole_tp(0).clone())
    return out


def params_from_jax(cfg: LlamaConfig, tree: Mapping[str, Any],
                    coords: Optional[Mapping[str, int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``LlamaForCausalLM``, ``MixtralForCausalLM``,
    ``GPTNeoXForCausalLM``, ``BertForPreTraining`` or
    ``ViTForImageClassification`` params (numpy arrays, with or without the
    outer ``"params"`` key) -> the port's state dict, in the tree's own
    dtypes. ``cfg`` names the family. With ``coords`` (a rank's ``{"tp":
    i, "ep": j}``) the whole tree gives that rank's shards at ``cfg.tp``
    and ``cfg.ep_size``."""
    if coords is not None:
        return shard_state_dict(cfg, params_from_jax(cfg, tree), coords)
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
