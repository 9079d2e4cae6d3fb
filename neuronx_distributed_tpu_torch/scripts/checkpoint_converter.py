"""HuggingFace <-> port checkpoint conversion (counterpart of
``neuronx_distributed_tpu/scripts/checkpoint_converter.py``) for Llama,
Mixtral, GPT-NeoX, BERT and ViT, in both directions.

The port's checkpoint is its flat state dict: the JAX package's names
joined by dots, one entry per layer (``layers.{i}.attn.qkv.q_kernel``)
where the JAX tree stacks the layers, and the JAX layouts (kernels ``[in,
out]``, Llama's fused ``gate_up_kernel [H, 2, I]``, Mixtral's expert banks
``gate_up [E, H, 2, I]`` and ``down [E, I, H]``). HF's linears are ``[out,
in]``, so every kernel is transposed; GPT-NeoX's head-major
``query_key_value`` is split and fused again; ViT's conv patch projection
flattens to the dense ``[C*p*p, hidden]`` kernel.

The converters work on torch tensors on any device and keep their dtype
(the reference's Llama converter reads fp32), so the card converts an 8B
checkpoint without a host copy. A transposed or fused entry is a new
tensor; an entry taken as it is (a norm scale, a bias, an embedding table)
is the input's own tensor.

    python -m neuronx_distributed_tpu_torch.scripts.checkpoint_converter \\
        --input model.safetensors --output model.pt --family llama \\
        --num-layers 32 --vocab-size 128256 --num-kv-heads 8 \\
        --intermediate-size 14336

The CLI reads ``.safetensors`` (through a lazy import) or a file written
by ``torch.save``, loaded with ``torch.load(weights_only=True)``, and
writes ``torch.save``; it loads and converts on the CUDA card unless
``--device cpu`` is given. It never unpickles: the reference's CLI does
(``pickle.load``), which runs any code the file names.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Mapping, Tuple

import torch

from ..device import DeviceLike, resolve_device

StateDict = Dict[str, torch.Tensor]
# (port name, HF name, whether the entry is a kernel to transpose)
Entry = Tuple[str, str, bool]


def _t(w: torch.Tensor) -> torch.Tensor:
    """``[out, in]`` <-> ``[in, out]``, as a new contiguous tensor."""
    return w.t().contiguous()


def _apply(entries: List[Entry], src: Mapping[str, torch.Tensor],
           to_port: bool) -> StateDict:
    out = {}
    for port, hf, kernel in entries:
        w = src[hf if to_port else port]
        out[port if to_port else hf] = _t(w) if kernel else w
    return out


def _llama_entries(cfg, moe: bool) -> List[Entry]:
    """The entries of a Llama or Mixtral checkpoint that map one to one;
    the lm_head is not among them."""
    entries = [("embed.embedding", "model.embed_tokens.weight", False),
               ("norm.scale", "model.norm.weight", False)]
    for i in range(cfg.num_layers):
        hf, port = f"model.layers.{i}.", f"layers.{i}."
        entries += [(f"{port}attn.qkv.{j}_kernel",
                     f"{hf}self_attn.{j}_proj.weight", True) for j in "qkv"]
        entries += [
            (f"{port}attn.o_proj.kernel", f"{hf}self_attn.o_proj.weight",
             True),
            (f"{port}input_norm.scale", f"{hf}input_layernorm.weight", False),
            (f"{port}post_norm.scale", f"{hf}post_attention_layernorm.weight",
             False)]
        if moe:
            entries.append((f"{port}moe.router.kernel",
                            f"{hf}block_sparse_moe.gate.weight", True))
        else:
            entries.append((f"{port}mlp.down.kernel",
                            f"{hf}mlp.down_proj.weight", True))
    return entries


def convert_hf_llama_to_nxd(state_dict: Mapping[str, torch.Tensor],
                            cfg) -> StateDict:
    """An HF Llama state dict -> the port's ``LlamaForCausalLM`` state
    dict (gate and up fused into ``gate_up_kernel [H, 2, I]``, index 0 the
    gate). A tied config gets no ``lm_head``; an untied one takes
    ``lm_head.weight``, or the embedding when the checkpoint omits it."""
    sd = _apply(_llama_entries(cfg, moe=False), state_dict, to_port=True)
    for i in range(cfg.num_layers):
        hf = f"model.layers.{i}.mlp."
        sd[f"layers.{i}.mlp.gate_up_kernel"] = torch.stack(
            [state_dict[hf + "gate_proj.weight"].t(),
             state_dict[hf + "up_proj.weight"].t()], dim=1)
    if not getattr(cfg, "tie_embeddings", False):
        sd["lm_head.kernel"] = _t(state_dict.get(
            "lm_head.weight", state_dict["model.embed_tokens.weight"]))
    return sd


def convert_nxd_to_hf_llama(state_dict: Mapping[str, torch.Tensor],
                            cfg) -> StateDict:
    """Inverse of :func:`convert_hf_llama_to_nxd`; a tied model exports no
    ``lm_head.weight`` (HF's ``tie_word_embeddings`` convention). Entries
    the converter does not know (LoRA adapters) are left out."""
    out = _apply(_llama_entries(cfg, moe=False), state_dict, to_port=False)
    for i in range(cfg.num_layers):
        gu = state_dict[f"layers.{i}.mlp.gate_up_kernel"]
        hf = f"model.layers.{i}.mlp."
        out[hf + "gate_proj.weight"] = _t(gu[:, 0])
        out[hf + "up_proj.weight"] = _t(gu[:, 1])
    if "lm_head.kernel" in state_dict:
        out["lm_head.weight"] = _t(state_dict["lm_head.kernel"])
    return out


def convert_hf_mixtral_to_nxd(state_dict: Mapping[str, torch.Tensor],
                              cfg) -> StateDict:
    """An HF Mixtral state dict -> the port's ``MixtralForCausalLM`` state
    dict: each expert's ``w1`` (gate) and ``w3`` (up) fused into
    ``gate_up [E, H, 2, I]``, ``w2`` stacked into ``down [E, I, H]``; the
    lm_head always (from the embedding when the checkpoint omits it)."""
    sd = _apply(_llama_entries(cfg, moe=True), state_dict, to_port=True)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}.block_sparse_moe.experts."
        experts = range(cfg.num_experts)
        sd[f"layers.{i}.moe.experts.gate_up"] = torch.stack([torch.stack(
            [state_dict[f"{pre}{e}.w1.weight"].t(),
             state_dict[f"{pre}{e}.w3.weight"].t()], dim=1)
            for e in experts])
        sd[f"layers.{i}.moe.experts.down"] = torch.stack(
            [state_dict[f"{pre}{e}.w2.weight"].t() for e in experts])
    sd["lm_head.kernel"] = _t(state_dict.get(
        "lm_head.weight", state_dict["model.embed_tokens.weight"]))
    return sd


def convert_nxd_to_hf_mixtral(state_dict: Mapping[str, torch.Tensor],
                              cfg) -> StateDict:
    """Inverse of :func:`convert_hf_mixtral_to_nxd`."""
    out = _apply(_llama_entries(cfg, moe=True), state_dict, to_port=False)
    out["lm_head.weight"] = _t(state_dict["lm_head.kernel"])
    for i in range(cfg.num_layers):
        gu = state_dict[f"layers.{i}.moe.experts.gate_up"]
        dn = state_dict[f"layers.{i}.moe.experts.down"]
        pre = f"model.layers.{i}.block_sparse_moe.experts."
        for e in range(cfg.num_experts):
            out[f"{pre}{e}.w1.weight"] = _t(gu[e, :, 0])
            out[f"{pre}{e}.w3.weight"] = _t(gu[e, :, 1])
            out[f"{pre}{e}.w2.weight"] = _t(dn[e])
    return out


def _neox_entries(cfg) -> List[Entry]:
    entries = [("embed.embedding", "gpt_neox.embed_in.weight", False),
               ("final_norm.scale", "gpt_neox.final_layer_norm.weight",
                False),
               ("final_norm.bias", "gpt_neox.final_layer_norm.bias", False),
               ("lm_head.kernel", "embed_out.weight", True)]
    for i in range(cfg.num_layers):
        hf, port = f"gpt_neox.layers.{i}.", f"layers.{i}."
        for ours, theirs in (("attn.o_proj", "attention.dense"),
                             ("mlp.up", "mlp.dense_h_to_4h"),
                             ("mlp.down", "mlp.dense_4h_to_h")):
            entries += [(f"{port}{ours}.kernel", f"{hf}{theirs}.weight", True),
                        (f"{port}{ours}.bias", f"{hf}{theirs}.bias", False)]
        for ours, theirs in (("ln1", "input_layernorm"),
                             ("ln2", "post_attention_layernorm")):
            entries += [(f"{port}{ours}.scale", f"{hf}{theirs}.weight", False),
                        (f"{port}{ours}.bias", f"{hf}{theirs}.bias", False)]
    return entries


def convert_hf_neox_to_nxd(state_dict: Mapping[str, torch.Tensor],
                           cfg) -> StateDict:
    """An HF GPT-NeoX state dict -> the port's ``GPTNeoXForCausalLM``
    state dict; the fused ``query_key_value`` is head-major ``[heads, 3,
    head_dim]`` on its output dim and splits into q, k and v."""
    sd = _apply(_neox_entries(cfg), state_dict, to_port=True)
    n, hd, h = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    for i in range(cfg.num_layers):
        pre = f"gpt_neox.layers.{i}.attention.query_key_value."
        w = state_dict[pre + "weight"].reshape(n, 3, hd, h)
        b = state_dict[pre + "bias"].reshape(n, 3, hd)
        for j, name in enumerate("qkv"):
            sd[f"layers.{i}.attn.qkv.{name}_kernel"] = _t(
                w[:, j].reshape(n * hd, h))
            sd[f"layers.{i}.attn.qkv.{name}_bias"] = b[:, j].reshape(n * hd)
    return sd


def convert_nxd_to_hf_neox(state_dict: Mapping[str, torch.Tensor],
                           cfg) -> StateDict:
    """Inverse of :func:`convert_hf_neox_to_nxd` (q, k and v fused again
    into the head-major ``query_key_value``)."""
    out = _apply(_neox_entries(cfg), state_dict, to_port=False)
    n, hd, h = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    for i in range(cfg.num_layers):
        qkv = f"layers.{i}.attn.qkv."
        pre = f"gpt_neox.layers.{i}.attention.query_key_value."
        out[pre + "weight"] = torch.stack(
            [state_dict[f"{qkv}{j}_kernel"].t().reshape(n, hd, h)
             for j in "qkv"], dim=1).reshape(3 * n * hd, h)
        out[pre + "bias"] = torch.stack(
            [state_dict[f"{qkv}{j}_bias"].reshape(n, hd) for j in "qkv"],
            dim=1).reshape(3 * n * hd)
    return out


def _encoder_entries(cfg, pre: str, attn: str, norms: Tuple[Tuple[str, str],
                                                            ...]
                     ) -> List[Entry]:
    """The per-layer entries BERT and ViT share: q/k/v (under ``attn``),
    the attention output, the MLP, and the layer's two LayerNorms."""
    entries = []
    for i in range(cfg.num_layers):
        hf, port = pre.format(i), f"layers.{i}."
        for j, part in (("q", "query"), ("k", "key"), ("v", "value")):
            entries += [(f"{port}qkv.{j}_kernel", f"{hf}{attn}.{part}.weight",
                         True),
                        (f"{port}qkv.{j}_bias", f"{hf}{attn}.{part}.bias",
                         False)]
        for ours, theirs in (("o_proj", "attention.output.dense"),
                             ("up", "intermediate.dense"),
                             ("down", "output.dense")):
            entries += [(f"{port}{ours}.kernel", f"{hf}{theirs}.weight", True),
                        (f"{port}{ours}.bias", f"{hf}{theirs}.bias", False)]
        for ours, theirs in norms:
            entries += [(f"{port}{ours}.scale", f"{hf}{theirs}.weight", False),
                        (f"{port}{ours}.bias", f"{hf}{theirs}.bias", False)]
    return entries


def _bert_entries(cfg) -> List[Entry]:
    emb = "bert.embeddings."
    cls = "cls.predictions."
    return [
        ("embed.embedding", emb + "word_embeddings.weight", False),
        ("position_embedding", emb + "position_embeddings.weight", False),
        ("type_embedding", emb + "token_type_embeddings.weight", False),
        ("embed_norm.scale", emb + "LayerNorm.weight", False),
        ("embed_norm.bias", emb + "LayerNorm.bias", False),
        ("mlm_transform.kernel", cls + "transform.dense.weight", True),
        ("mlm_transform.bias", cls + "transform.dense.bias", False),
        ("mlm_norm.scale", cls + "transform.LayerNorm.weight", False),
        ("mlm_norm.bias", cls + "transform.LayerNorm.bias", False),
        ("mlm_bias", cls + "bias", False),
    ] + _encoder_entries(cfg, "bert.encoder.layer.{}.", "attention.self",
                         (("ln_attn", "attention.output.LayerNorm"),
                          ("ln_mlp", "output.LayerNorm")))


def convert_hf_bert_to_nxd(state_dict: Mapping[str, torch.Tensor],
                           cfg) -> StateDict:
    """An HF ``BertForMaskedLM`` state dict -> the port's
    ``BertForPreTraining`` state dict with ``mlm_transform=True``."""
    return _apply(_bert_entries(cfg), state_dict, to_port=True)


def convert_nxd_to_hf_bert(state_dict: Mapping[str, torch.Tensor],
                           cfg) -> StateDict:
    """Inverse of :func:`convert_hf_bert_to_nxd`, with the tied
    ``cls.predictions.decoder.*`` aliases HF checkpoints carry."""
    out = _apply(_bert_entries(cfg), state_dict, to_port=False)
    out["cls.predictions.decoder.weight"] = state_dict["embed.embedding"]
    out["cls.predictions.decoder.bias"] = state_dict["mlm_bias"]
    return out


def _vit_entries(cfg) -> List[Entry]:
    return [
        ("cls_token", "vit.embeddings.cls_token", False),
        ("patch_proj.bias", "vit.embeddings.patch_embeddings.projection.bias",
         False),
        ("final_norm.scale", "vit.layernorm.weight", False),
        ("final_norm.bias", "vit.layernorm.bias", False),
        ("classifier.kernel", "classifier.weight", True),
        ("classifier.bias", "classifier.bias", False),
    ] + _encoder_entries(cfg, "vit.encoder.layer.{}.", "attention.attention",
                         (("ln_before", "layernorm_before"),
                          ("ln_after", "layernorm_after")))


_PATCH = "vit.embeddings.patch_embeddings.projection.weight"
_POSITIONS = "vit.embeddings.position_embeddings"


def convert_hf_vit_to_nxd(state_dict: Mapping[str, torch.Tensor],
                          cfg) -> StateDict:
    """An HF ``ViTForImageClassification`` state dict -> the port's: the
    stride-``p`` conv patch projection ``[hidden, C, p, p]`` flattens to
    the dense ``[C*p*p, hidden]`` kernel in (c, i, j) order
    (:func:`..models.vit.patchify`)."""
    sd = _apply(_vit_entries(cfg), state_dict, to_port=True)
    proj = state_dict[_PATCH]
    sd["patch_proj.kernel"] = _t(proj.reshape(proj.shape[0], -1))
    sd["position_embedding"] = state_dict[_POSITIONS][0]
    return sd


def convert_nxd_to_hf_vit(state_dict: Mapping[str, torch.Tensor],
                          cfg) -> StateDict:
    """Inverse of :func:`convert_hf_vit_to_nxd`."""
    out = _apply(_vit_entries(cfg), state_dict, to_port=False)
    c, p = cfg.num_channels, cfg.patch_size
    out[_PATCH] = _t(state_dict["patch_proj.kernel"]).reshape(
        cfg.hidden_size, c, p, p)
    out[_POSITIONS] = state_dict["position_embedding"][None]
    return out


_HF2NXD: Dict[str, Callable] = {"llama": convert_hf_llama_to_nxd,
                                "mixtral": convert_hf_mixtral_to_nxd,
                                "neox": convert_hf_neox_to_nxd,
                                "bert": convert_hf_bert_to_nxd,
                                "vit": convert_hf_vit_to_nxd}
_NXD2HF: Dict[str, Callable] = {"llama": convert_nxd_to_hf_llama,
                                "mixtral": convert_nxd_to_hf_mixtral,
                                "neox": convert_nxd_to_hf_neox,
                                "bert": convert_nxd_to_hf_bert,
                                "vit": convert_nxd_to_hf_vit}


def _cli_config(family: str, **overrides):
    """The family's config with the CLI's shape overrides (None dropped);
    an override the family has no field for exits with an error."""
    from ..models import bert, gpt_neox, llama, mixtral, vit

    cls, extra = {
        "llama": (llama.LlamaConfig, {}),
        "mixtral": (mixtral.MixtralConfig, {}),
        "neox": (gpt_neox.GPTNeoXConfig, {}),
        "bert": (bert.BertConfig, {"mlm_transform": True}),
        "vit": (vit.ViTConfig, {}),
    }.get(family, (None, None))
    if cls is None:
        raise ValueError(f"unknown family {family!r}")
    kw = {k: v for k, v in overrides.items() if v is not None}
    unknown = sorted(set(kw) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise SystemExit(
            f"--family {family} has no config field(s) {unknown}")
    return cls(**extra, **kw)


def load_state_dict(path: str, device: DeviceLike = None) -> StateDict:
    """A ``.safetensors`` file, or one written by ``torch.save`` (loaded
    with ``weights_only=True``: tensors and plain containers only), onto
    ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path, device=str(dev))
    return torch.load(path, map_location=dev, weights_only=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert HF checkpoints to and from the port's state "
                    "dict")
    ap.add_argument("--input", required=True,
                    help=".safetensors, or a torch.save file")
    ap.add_argument("--output", required=True, help="torch.save file")
    ap.add_argument("--family", choices=sorted(_HF2NXD), default="llama")
    ap.add_argument("--direction", choices=["hf2nxd", "nxd2hf"],
                    default="hf2nxd")
    ap.add_argument("--num-layers", type=int, required=True)
    for flag in ("hidden-size", "intermediate-size", "num-heads",
                 "num-kv-heads", "num-experts", "vocab-size", "image-size",
                 "patch-size", "num-channels", "num-labels"):
        ap.add_argument(f"--{flag}", type=int)
    ap.add_argument("--device", default=None,
                    help="where the tensors are loaded and converted "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    fields = ("num_layers", "hidden_size", "intermediate_size", "num_heads",
              "num_kv_heads", "num_experts", "vocab_size", "image_size",
              "patch_size", "num_channels", "num_labels")
    cfg = _cli_config(args.family,
                      **{f: getattr(args, f) for f in fields})
    sd = load_state_dict(args.input, args.device)
    out = (_HF2NXD if args.direction == "hf2nxd"
           else _NXD2HF)[args.family](sd, cfg)
    torch.save(out, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":  # pragma: no cover
    main()
