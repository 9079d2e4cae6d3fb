"""Llama (counterpart of ``neuronx_distributed_tpu/models/llama.py``): the
cached serving forward over a paged pool or a contiguous cache at tp=1,
and the training forward at any tensor-parallel degree.

At ``tp_size > 1`` (the reference's explicit ``shard_map`` form) every
rank holds its shards, built from :mod:`..parallel.layers`' sharded
linears: q/k/v and gate_up column-parallel, o_proj and down
row-parallel, a vocab-parallel embedding and LM head, and the loss over
vocab-sharded logits. Attention runs on the rank's local heads through
:func:`..ops.flash_attention.flash_attention`. With ``sequence_parallel``
the embedding's output is split along the sequence, the norms and
residuals run on each rank's sequence shard, every TP block enters by the
sequence all-gather and leaves by the reduce-scatter, and the LM head
gathers the final hidden states.

The state dict keeps the JAX parameter names and layouts (kernels ``[in,
out]``, the fused MLP kernel ``[H, 2, I]``), so :mod:`.convert` maps a JAX
param tree across by renaming and unstacking the scanned layer dim.

Weights are held in ``cfg.param_dtype`` and cast to ``cfg.dtype`` at use,
as flax does. The training entry point
(``trainer.initialize_parallel_model``) holds them so (fp32 by default)
with gradients on; serving (:func:`build_model`) sets ``param_dtype`` to
``cfg.dtype``, which gives the same values at every use and half the
memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..inference.kv_cache import (ContiguousCacheView, KVCache,
                                  QuantizedKVCache, dequantize_kv,
                                  quantize_kv, write_slots)
from ..inference.paging import (PagedCacheView, PagedKVCache,
                                QuantizedPagedKVCache, flat_write_indices,
                                pool_rows, scatter_pool_rows,
                                spread_dropped_rows)
from ..lora import LoraConfig, is_lora_path
from ..modules.attention import (apply_rotary, attention_dropout_seed,
                                 precompute_rope, rank_dropout_offsets,
                                 repeat_kv, sdpa_reference)
from ..modules.norms import RMSNorm
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention
from ..parallel import mappings
from ..parallel import mesh as ps
from ..parallel.layers import (ColumnParallelLinear,
                               GQAQKVColumnParallelLinear, Linear,
                               ParallelEmbedding, RowParallelLinear,
                               embedding_attend)
from ..parallel.layers import dropout as adapter_dropout
from ..parallel.loss_functions import (causal_lm_loss,
                                       fused_linear_cross_entropy)
from ..quantization import mx_layers, quantization_layers as ql
from ..quantization.microscaling import MX_BLOCK
from ..quantization.quantization_utils import QuantizedDtype, dequantize
from ..utils.remat import remat_call, validate_remat_policy
from .common import hidden_generator

#: ``(dropout_p, dropout_seed)`` of one attention call, as
#: :func:`..modules.attention.attention_dropout_seed` draws it
Dropout = Tuple[float, Optional[int]]

#: the serving weight-quantization tiers: per-out-channel symmetric w8a16
#: (``int8``, ``fp8``) or packed OCP microscaling (``mxfp4``, ``mxfp8``)
WEIGHT_QUANT_FORMATS = ("int8", "fp8", "mxfp4", "mxfp8")


def _lora_kw(cfg: "LlamaConfig", name: str) -> dict:
    """The adapter arguments of sublayer ``name`` (``qkv``, ``o_proj``,
    ``gate_up``, ``down``, ``embed``, ``lm_head``) when ``cfg.lora``
    targets it, else none (JAX ``models/llama.py:42``)."""
    if cfg.lora is not None and name in cfg.lora.target_modules:
        return {"lora_rank": cfg.lora.r, "lora_alpha": cfg.lora.alpha,
                "lora_dropout": cfg.lora.dropout}
    return {}


def weight_quant_dtype(fmt: str) -> QuantizedDtype:
    """The element type of the ``int8``/``fp8`` tiers."""
    return QuantizedDtype.INT8 if fmt == "int8" else QuantizedDtype.FP8E4M3


def quant_linear(cfg: "LlamaConfig", in_features: int, out_features: int,
                 device) -> nn.Module:
    """The linear of ``cfg.weight_quant``'s tier (``kernel_q`` or
    ``kernel_packed`` beside ``kernel_scale``): every projection of a
    quantized model, the LM head included."""
    fmt = cfg.weight_quant
    if fmt.startswith("mx"):
        return mx_layers.MXQuantizedColumnParallel(
            in_features, out_features, mx_format=fmt[2:], dtype=cfg.dtype,
            device=device)
    return ql.QuantizedColumnParallel(
        in_features, out_features, quantized_dtype=weight_quant_dtype(fmt),
        dtype=cfg.dtype, device=device)


@dataclass(frozen=True)
class LlamaConfig:
    """The fields of the JAX ``LlamaConfig`` that the paged serving path and
    the single-device training step honour. ``attention_dropout`` is active
    only when the caller passes a ``dropout_generator``.

    ``tie_embeddings``: no LM-head parameter; the logits use the embedding
    table. ``remat``: each decoder layer is rematerialised in the backward,
    keeping what ``remat_policy`` names (:mod:`..utils.remat`).
    ``loss_chunk``: the training loss streams chunks of that many tokens
    through the LM head (:func:`..parallel.loss_functions.
    fused_linear_cross_entropy`) instead of building ``[B, S, V]``
    logits; it needs the LM-head kernel, so it refuses ``tie_embeddings``,
    as the reference does (``models/llama.py:246-261``).
    ``weight_quant`` (one of :data:`WEIGHT_QUANT_FORMATS`): every
    projection kernel and the LM head are held quantized (the embedding
    stays float); convert a float state dict with
    :func:`..quantization.serving.quantize_params_for_serving`.
    ``lora`` (:class:`..lora.LoraConfig`): adapters in the sublayers it
    targets; train them with :func:`..lora.make_lora_optimizer`, serve
    them as they are or folded by :func:`..lora.merge_lora_params` into a
    config without ``lora``.
    ``tp_size`` (None: 1) is the tensor-parallel degree the model's shards
    are built for; the ranks' layout must say the same
    (:func:`..config.neuronx_distributed_config`). ``sequence_parallel``
    shards the activations between the TP blocks along the sequence (JAX
    ``models/llama.py:401-418``, ``:563-654``, ``:886``). At tp > 1 only
    training runs, and neither ``weight_quant`` nor ``lora``."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: bool = False
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash_attention: bool = False
    attention_dropout: float = 0.0
    tie_embeddings: bool = False
    remat: bool = False
    remat_policy: str = "nothing"
    loss_chunk: Optional[int] = None
    weight_quant: Optional[str] = None
    lora: Optional[LoraConfig] = None
    sequence_parallel: bool = False
    tp_size: Optional[int] = None

    def __post_init__(self) -> None:
        validate_remat_policy(self.remat_policy)
        if self.tp > 1:
            later = [name for name, on in (
                ("weight_quant", self.weight_quant is not None),
                ("lora", self.lora is not None)) if on]
            if later:
                raise ValueError(f"{', '.join(later)} at tp_size="
                                 f"{self.tp}: not in the port yet (a later "
                                 "slice); they run at tp=1")
        if self.weight_quant is not None:
            self._validate_weight_quant()
        if self.loss_chunk is not None:
            if self.loss_chunk <= 0:
                raise ValueError(
                    f"loss_chunk must be positive, got {self.loss_chunk}")
            unsupported = ("tie_embeddings=True" if self.tie_embeddings
                           else "LoRA targeting 'lm_head'"
                           if _lora_kw(self, "lm_head") else None)
            if unsupported:
                raise ValueError(
                    f"loss_chunk is incompatible with {unsupported}: the "
                    "fused chunked loss streams through a dedicated "
                    "lm_head kernel param; unset loss_chunk for this "
                    "configuration")

    def _validate_weight_quant(self) -> None:
        """The reference's checks (``models/llama.py:211-245``) for the
        fields the port has."""
        if self.weight_quant not in WEIGHT_QUANT_FORMATS:
            raise ValueError(
                f"weight_quant must be one of {WEIGHT_QUANT_FORMATS} "
                f"or None, got {self.weight_quant!r}")
        if self.sequence_parallel:
            raise ValueError(
                f"weight_quant={self.weight_quant!r} is incompatible with "
                "sequence_parallel: the quantized layers have no sequence "
                "entry or exit")
        incompatible = (
            "LoRA (adapters assume float kernels)"
            if self.lora is not None else
            "tie_embeddings=True (the embedding table stays float)"
            if self.tie_embeddings else
            "loss_chunk (the fused loss streams a float lm_head kernel)"
            if self.loss_chunk is not None else None)
        if incompatible:
            raise ValueError(
                f"weight_quant={self.weight_quant!r} is incompatible "
                f"with {incompatible}")
        if self.weight_quant.startswith("mx"):
            q_features = self.num_heads * self.head_dim_
            bad = ("hidden_size" if self.hidden_size % MX_BLOCK else
                   "intermediate_size"
                   if self.intermediate_size % MX_BLOCK else
                   "num_heads * head_dim"
                   if q_features % MX_BLOCK else None)
            if bad:
                raise ValueError(
                    f"weight_quant={self.weight_quant!r} needs {bad} "
                    f"divisible by the MX block ({MX_BLOCK}): all "
                    "contraction dims are block-scaled")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def tp(self) -> int:
        """The tensor-parallel degree (``tp_size``, 1 when None)."""
        return self.tp_size or 1

    @property
    def sp(self) -> bool:
        """Whether activations are sequence-sharded (tp > 1 only)."""
        return self.sequence_parallel and self.tp > 1


LLAMA2_7B = LlamaConfig(num_layers=32, hidden_size=4096,
                        intermediate_size=11008, num_heads=32, num_kv_heads=32)
LLAMA2_70B = LlamaConfig(num_layers=80, hidden_size=8192,
                         intermediate_size=28672, num_heads=64, num_kv_heads=8)
LLAMA3_8B = LlamaConfig(vocab_size=128256, num_layers=32, hidden_size=4096,
                        intermediate_size=14336, num_heads=32, num_kv_heads=8,
                        rope_theta=500000.0)


def tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128)
    base.update(kw)
    return LlamaConfig(**base)


CacheView = Union[PagedCacheView, ContiguousCacheView]


def _paged_cache_attend(cfg: LlamaConfig, q, k, v, positions,
                        view: PagedCacheView) -> torch.Tensor:
    """Write this step's K/V rows into the layer's pool slice (quantized
    for an int8 pool), then attend through the per-token block tables. The
    write lands before the attention reads, so each token sees its own row.
    The packed batch is ``[1, T]``."""
    k_rows, v_rows = k[0], v[0]                          # [T, KV, D]
    if view.k_scale is not None:
        qk, ks = quantize_kv(k_rows)
        qv, vs = quantize_kv(v_rows)
        scatter_pool_rows(view.rows["k"], qk, view.at)
        scatter_pool_rows(view.rows["v"], qv, view.at)
        scatter_pool_rows(view.rows["k_scale"], ks, view.at)
        scatter_pool_rows(view.rows["v_scale"], vs, view.at)
    else:
        scatter_pool_rows(view.rows["k"], k_rows, view.at)
        scatter_pool_rows(view.rows["v"], v_rows, view.at)
    out = paged_attention(q[0], view.k, view.v, view.pos, view.tables,
                          positions[0], k_scale=view.k_scale,
                          v_scale=view.v_scale,
                          scale=1.0 / math.sqrt(q.shape[-1]))[None]
    return out.to(cfg.dtype)


def _contiguous_cache_attend(cfg: LlamaConfig, q, k, v, positions,
                             view: ContiguousCacheView) -> torch.Tensor:
    """The contiguous-cache branch (JAX ``models/llama.py:441-487`` without
    flash decoding, and the int8 body ``_DecodeScanBody``): write this
    step's K/V at ``view.index``, then dense fp32 attention over every
    slot, masked by stored position with ``-1e30`` so that no row (a pad
    query attends to every real slot) turns to NaN. An int8 cache is
    dequantized to ``cfg.dtype`` for the read and only this step's slots
    are requantized, so slots already written never drift."""
    at = write_slots(view.index, q.shape[1], view.k.shape[1])
    if view.k_scale is not None:
        k_l = dequantize_kv(view.k, view.k_scale, cfg.dtype)
        v_l = dequantize_kv(view.v, view.v_scale, cfg.dtype)
    else:
        k_l, v_l = view.k, view.v
    k_l[:, at] = k.to(k_l.dtype)
    v_l[:, at] = v.to(v_l.dtype)
    n_rep = q.shape[2] // k.shape[2]
    k_full = repeat_kv(k_l.to(cfg.dtype), n_rep)
    v_full = repeat_kv(v_l.to(cfg.dtype), n_rep)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(),
                          k_full.float()) * (1.0 / math.sqrt(q.shape[-1]))
    mask = positions[:, :, None] >= view.pos[:, None, :]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v_full.float())
    if view.k_scale is not None:
        for codes, scales, rows in ((view.k, view.k_scale, k_l[:, at]),
                                    (view.v, view.v_scale, v_l[:, at])):
            codes[:, at], scales[:, at] = quantize_kv(rows)
    return out.to(cfg.dtype)


def _causal_attend(cfg: LlamaConfig, q, k, v, dropout: Optional[Dropout]):
    """The no-cache branch at cp=1 (JAX ``models/llama.py:488-540``): flash
    attention, which reads the GQA K/V heads natively, or the dense
    reference on K/V expanded by ``repeat_kv``. Across ranks the dropout
    mask is drawn at this rank's rows and heads of the global array
    (:func:`..modules.attention.rank_dropout_offsets`), as the reference's
    GSPMD step draws it over the whole array."""
    dropout_p, seed = dropout or (0.0, None)
    offsets = (rank_dropout_offsets(q.shape[0], q.shape[2], cfg.num_heads)
               if dropout_p > 0.0 else None)
    if cfg.use_flash_attention:
        return flash_attention(q, k, v, causal=True, dropout_p=dropout_p,
                               dropout_seed=seed, dropout_offsets=offsets)
    n_rep = q.shape[2] // k.shape[2]
    return sdpa_reference(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                          causal=True, dropout_p=dropout_p,
                          dropout_seed=seed, dropout_offsets=offsets)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim_
        qkv_args = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, d)
        fmt = cfg.weight_quant
        if fmt is None:
            self.qkv = GQAQKVColumnParallelLinear(
                *qkv_args, dtype=cfg.dtype, device=device,
                param_dtype=cfg.param_dtype, tp_size=cfg.tp,
                sequence_parallel=cfg.sp, **_lora_kw(cfg, "qkv"))
            self.o_proj = RowParallelLinear(
                cfg.num_heads * d, cfg.hidden_size, tp_size=cfg.tp,
                sequence_parallel=cfg.sp, dtype=cfg.dtype, device=device,
                param_dtype=cfg.param_dtype, **_lora_kw(cfg, "o_proj"))
            return
        if fmt.startswith("mx"):
            self.qkv = mx_layers.MXGQAQKVColumnParallelLinear(
                *qkv_args, mx_format=fmt[2:], dtype=cfg.dtype, device=device)
        else:
            self.qkv = ql.QuantizedGQAQKVColumnParallelLinear(
                *qkv_args, quantized_dtype=weight_quant_dtype(fmt),
                dtype=cfg.dtype, device=device)
        self.o_proj = quant_linear(cfg, cfg.num_heads * d, cfg.hidden_size,
                                   device)

    def forward(self, x, cos, sin, positions,
                view: Optional[CacheView] = None,
                dropout: Optional[Dropout] = None,
                lora_generator: Optional[torch.Generator] = None):
        """With a cache ``view`` (paged or contiguous), the serving step;
        without, causal self-attention over the sequence (training), with
        ``dropout = (p, seed)`` when given. ``lora_generator`` draws the
        adapters' dropout masks (a quantized model has no adapters)."""
        cfg = self.cfg
        d = cfg.head_dim_
        lora = {} if lora_generator is None else {
            "lora_generator": lora_generator}
        q, k, v = self.qkv(x, **lora)
        b, s = q.shape[:2]
        # this rank's heads: all of them at tp=1
        n_q, n_kv = q.shape[-1] // d, k.shape[-1] // d
        q = apply_rotary(q.reshape(b, s, n_q, d), cos, sin, positions)
        k = apply_rotary(k.reshape(b, s, n_kv, d), cos, sin, positions)
        v = v.reshape(b, s, n_kv, d)
        if isinstance(view, PagedCacheView):
            out = _paged_cache_attend(cfg, q, k, v, positions, view)
        elif view is not None:
            out = _contiguous_cache_attend(cfg, q, k, v, positions, view)
        else:
            out = _causal_attend(cfg, q, k, v, dropout)
        return self.o_proj(out.reshape(b, s, n_q * d), **lora)


class LlamaMLP(nn.Module):
    """SwiGLU with the fused ``gate_up_kernel [H, 2, I]`` (index 0 = gate,
    1 = up) and ``down``. Under ``weight_quant`` the fused kernel is held
    as ``gate_up_q [H, 2, I]`` with ``gate_up_scale [2, I]`` (int8, fp8),
    or as ``gate_up_packed [2, I, H/pack]`` with ``gate_up_scale [2, I,
    H/32]`` (MX, contraction dim last), and ``down`` is quantized too.

    A ``gate_up`` adapter is ``lora_a [H, r]`` with ``lora_b [r, 2, I]``,
    folded into the fused kernel in the parameter dtype (``hr,rki->hki``,
    JAX ``models/llama.py:596-607``), or added in activation space under
    live dropout (``:642-647``)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, i = cfg.hidden_size, cfg.intermediate_size
        fmt = cfg.weight_quant
        if fmt is None:
            pdt = cfg.param_dtype
            if i % cfg.tp:
                raise ValueError(f"intermediate_size {i} not divisible by "
                                 f"tp {cfg.tp}")
            self.gate_up_kernel = nn.Parameter(torch.empty(
                (h, 2, i // cfg.tp), dtype=pdt, device=device))
            self.down = RowParallelLinear(
                i, h, tp_size=cfg.tp, sequence_parallel=cfg.sp,
                dtype=cfg.dtype, device=device, param_dtype=pdt,
                **_lora_kw(cfg, "down"))
            r = _lora_kw(cfg, "gate_up").get("lora_rank", 0)
            self.lora_a = self.lora_b = None
            if r:
                self.lora_a = nn.Parameter(torch.empty(
                    (h, r), dtype=pdt, device=device))
                self.lora_b = nn.Parameter(torch.empty(
                    (r, 2, i), dtype=pdt, device=device))
            return
        if fmt.startswith("mx"):
            pack, store = mx_layers.mx_storage(fmt[2:])
            self.gate_up_packed = ql.frozen((2, i, h // pack), store, device)
            self.gate_up_scale = ql.frozen((2, i, h // MX_BLOCK),
                                           torch.float32, device)
        else:
            self.gate_up_q = ql.frozen(
                (h, 2, i), weight_quant_dtype(fmt).torch_dtype, device)
            self.gate_up_scale = ql.frozen((2, i), torch.float32, device)
        self.down = quant_linear(cfg, i, h, device)

    def gate_up(self, fold: bool = False) -> torch.Tensor:
        """The fused kernel as ``[H, 2 I]`` in the compute dtype; with
        ``fold``, the adapter folded in first, in the parameter dtype."""
        cfg = self.cfg
        h, i = cfg.hidden_size, cfg.intermediate_size // cfg.tp
        fmt = cfg.weight_quant
        if fmt is None:
            kernel = self.gate_up_kernel
            if fold:
                kernel = kernel + cfg.lora.scale * torch.einsum(
                    "hr,rki->hki", self.lora_a, self.lora_b)
            return kernel.reshape(h, 2 * i).to(cfg.dtype)
        if fmt.startswith("mx"):
            w = mx_layers.mx_dequant(self.gate_up_packed, self.gate_up_scale,
                                     fmt[2:], cfg.dtype)     # [2, I, H]
            return w.reshape(2 * i, h).t()
        return dequantize(self.gate_up_q, self.gate_up_scale[None],
                          cfg.dtype).reshape(h, 2 * i)

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tp > 1:
            if cfg.sp:
                x = mappings.gather_from_sequence_parallel_region(
                    x, ps.TP_AXIS, 1, to_model_parallel=True)
            else:
                x = mappings.copy_to_tensor_parallel_region(x, ps.TP_AXIS)
        x = x.to(cfg.dtype)
        adapter = getattr(self, "lora_a", None) is not None
        live = (adapter and cfg.lora.dropout > 0.0
                and lora_generator is not None)
        h = torch.matmul(x, self.gate_up(fold=adapter and not live))
        if live:
            x_l = adapter_dropout(x, cfg.lora.dropout, lora_generator)
            h = h + cfg.lora.scale * torch.matmul(
                torch.matmul(x_l, self.lora_a.to(cfg.dtype)),
                self.lora_b.to(cfg.dtype).flatten(1))
        h = h.unflatten(-1, (2, cfg.intermediate_size // cfg.tp))
        lora = {} if lora_generator is None else {
            "lora_generator": lora_generator}
        return self.down(F.silu(h[..., 0, :]) * h[..., 1, :], **lora)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                  device, cfg.param_dtype)
        self.attn = LlamaAttention(cfg, device)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                 device, cfg.param_dtype)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cos, sin, positions,
                view: Optional[CacheView] = None,
                dropout: Optional[Dropout] = None,
                lora_dropout: Optional[Dropout] = None):
        """``lora_dropout = (p, seed)``: the adapters' dropout masks come
        from a generator seeded here, so a recompute draws the same ones
        (qkv, o_proj, gate_up, down in turn)."""
        gen = hidden_generator(lora_dropout, x.device)
        x = x + self.attn(self.input_norm(x), cos, sin, positions, view,
                          dropout, gen)
        return x + self.mlp(self.post_norm(x), gen)


class LlamaForCausalLM(nn.Module):
    """Embedding, decoder stack, final norm and an LM head (none with
    ``tie_embeddings``: the logits then use the embedding table).
    Parameters are allocated uninitialised in ``cfg.param_dtype``: load a
    state dict (:func:`build_model`, :func:`.convert.load_jax_params`,
    ``initialize_parallel_model``) or make one (:func:`init_state_dict`)."""

    layer_cls = LlamaDecoderLayer

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        pdt = cfg.param_dtype
        self.cfg = cfg
        if cfg.tp > 1 and dev.type != "meta":
            _check_tp_layout(cfg)
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                       dtype=cfg.dtype, device=dev,
                                       param_dtype=pdt, tp_size=cfg.tp,
                                       **_lora_kw(cfg, "embed"))
        self.layers = nn.ModuleList(
            [self.layer_cls(cfg, dev) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, dev, pdt)
        if cfg.weight_quant is not None:
            self.lm_head = quant_linear(cfg, cfg.hidden_size,
                                        cfg.vocab_size, dev)
        elif not cfg.tie_embeddings:
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, tp_size=cfg.tp,
                sequence_parallel=cfg.sp, dtype=cfg.dtype, device=dev,
                param_dtype=pdt, **_lora_kw(cfg, "lm_head"))
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def hidden(self, input_ids: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """The JAX ``LlamaModel`` (``models/llama.py:872``): embedding, the
        decoder layers (unrolled, each rematerialised with ``cfg.remat``)
        and the final norm over ``input_ids [B, S]``; rope positions
        default to ``arange(S)``."""
        x = self.embed(input_ids)
        if self.cfg.sp:
            x = mappings.scatter_to_sequence_parallel_region(x, ps.TP_AXIS,
                                                             1)
        cos, sin = self.rope_tables(input_ids.device)
        for layer in self.layers:
            x = self.run_layer(layer, x, cos, sin, positions,
                               dropout_generator)
        # still sequence-sharded under SP: the LM head gathers it, so that
        # the gather's backward reduce-scatter pairs with the head's
        # partial input gradients
        return self.norm(x)

    def run_layer(self, layer: nn.Module, x, cos, sin, positions,
                  dropout_generator: Optional[torch.Generator]):
        """One training layer, under remat when ``cfg.remat``. The layer's
        attention-dropout seed, then its adapters' dropout seed (when
        ``cfg.lora.dropout`` is live), are drawn here, before the layer
        runs, so that a recompute sees the same seeds and the generator
        advances as often with or without remat."""
        cfg = self.cfg
        dropout = attention_dropout_seed(cfg.attention_dropout,
                                         dropout_generator)
        args = (x, cos, sin, positions, None, dropout)
        lora_d = self.lora_dropout_seed(dropout_generator)
        if lora_d is not None:
            args += (lora_d,)
        if cfg.remat:
            return remat_call(layer, *args, policy=self.layer_remat_policy)
        return layer(*args)

    def lora_dropout_seed(self, dropout_generator: Optional[torch.Generator]
                          ) -> Optional[Dropout]:
        """``(p, seed)`` for one site's adapter dropout, drawn from
        ``dropout_generator``, or None when it is not live."""
        lora = self.cfg.lora
        if lora is None or lora.dropout <= 0.0 or dropout_generator is None:
            return None
        return attention_dropout_seed(lora.dropout, dropout_generator)

    @property
    def layer_remat_policy(self) -> str:
        """The remat policy of a decoder layer: ``cfg.remat_policy``."""
        return self.cfg.remat_policy

    def logits(self, x: torch.Tensor,
               lora_dropout: Optional[Dropout] = None) -> torch.Tensor:
        """``x @ lm_head`` in ``cfg.dtype``, or with ``tie_embeddings``
        ``x @ embedding^T`` (the JAX ``embedding_attend``); the table's
        gradient then sums over both its uses. ``lora_dropout`` seeds the
        LM head's adapter dropout."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            if _lora_kw(cfg, "lm_head"):
                raise ValueError(
                    "LoRA on 'lm_head' is incompatible with "
                    "tie_embeddings=True (there is no lm_head param); "
                    "target 'embed' instead")
            return embedding_attend(self.embed.embedding, x, cfg.dtype,
                                    tp_size=cfg.tp,
                                    sequence_parallel=cfg.sp)
        gen = hidden_generator(lora_dropout, x.device)
        return self.lm_head(x) if gen is None else self.lm_head(
            x, lora_generator=gen)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                ignore_index: int = -100,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in ``cfg.dtype`` (at tp > 1 this rank's
        vocab shard ``[B, S, V / tp]``), or, given ``labels`` (the
        next-token ids, already shifted), the mean causal-LM loss over the
        labels that are not ``ignore_index`` (chunked through the LM head
        with ``cfg.loss_chunk``), the same on every rank."""
        cfg = self.cfg
        x = self.hidden(input_ids, positions, dropout_generator)
        if (labels is not None and cfg.loss_chunk
                and not _lora_kw(cfg, "lm_head")):
            if cfg.sp:
                x = mappings.gather_from_sequence_parallel_region(
                    x, ps.TP_AXIS, 1, to_model_parallel=True)
            elif cfg.tp > 1:
                x = mappings.copy_to_tensor_parallel_region(x, ps.TP_AXIS)
            return fused_linear_cross_entropy(
                x.to(cfg.dtype), self.lm_head.kernel, labels,
                ignore_index=ignore_index, chunk=cfg.loss_chunk,
                dtype=cfg.dtype)
        logits = self.logits(x, self.lora_dropout_seed(dropout_generator))
        if labels is not None:
            return causal_lm_loss(logits, labels, ignore_index=ignore_index)
        return logits

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -100,
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        return self(input_ids, labels=labels, ignore_index=ignore_index,
                    dropout_generator=dropout_generator)

    def rope_tables(self, device: torch.device):
        """fp32 cos/sin ``[max_seq_len, head_dim/2]``, made once per
        device."""
        if self._rope is None or self._rope[0].device != device:
            cfg = self.cfg
            self._rope = precompute_rope(cfg.head_dim_, cfg.max_seq_len,
                                         cfg.rope_theta,
                                         use_scaled=cfg.rope_scaling,
                                         device=device)
        return self._rope


def _check_tp_layout(cfg: LlamaConfig) -> None:
    """A model sharded ``cfg.tp`` ways needs the ranks laid out with that
    tensor-parallel size."""
    have = (ps.get_tensor_model_parallel_size()
            if ps.model_parallel_is_initialized() else 1)
    if have != cfg.tp:
        raise ValueError(
            f"the config's tp_size {cfg.tp} differs from the ranks' "
            f"tensor-parallel size {have} (neuronx_distributed_config)")


def build_model(cfg: LlamaConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None,
                model_cls=LlamaForCausalLM) -> LlamaForCausalLM:
    """A serving model, frozen, whose parameters are ``state_dict``'s
    tensors moved to ``device`` and ``cfg.dtype`` (no copy where they
    already are): serving holds its weights in the compute dtype. A
    parameter the model holds in fp32 whatever its dtypes (the MoE router's
    kernel) stays in fp32. Serving runs at tp=1."""
    if cfg.tp > 1:
        raise ValueError(f"serving at tp_size={cfg.tp}: not in the port "
                         "yet (a later slice); it serves at tp=1")
    dev = resolve_device(device)
    model = model_cls(replace(cfg, param_dtype=cfg.dtype), device="meta")
    want = model.state_dict()
    model.load_state_dict(
        {k: v.to(device=dev, dtype=want[k].dtype if k in want else cfg.dtype)
         for k, v in state_dict.items()},
        strict=True, assign=True)
    return model.requires_grad_(False)


def init_state_dict(cfg: LlamaConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None,
                    model_cls=LlamaForCausalLM) -> Dict[str, torch.Tensor]:
    """Random weights from a ``torch.Generator`` seeded with ``seed``:
    normal(0, ``std``) kernels and embeddings, unit norm scales, made on
    ``device`` in each parameter's dtype (``cfg.param_dtype``, or fp32 for
    a parameter held so). The dict is the whole model's whatever
    ``cfg.tp_size``: :func:`.convert.shard_state_dict` takes a rank's
    shards of it.

    LoRA adapters are drawn after every base weight, so the base equals
    the same config's without ``lora``: normal(0, ``std``) A (B for the
    embedding) and a zero B (A for the embedding), as the reference
    zero-initialises, so a fresh adapter changes no output.

    Under ``cfg.weight_quant`` the float weights are drawn as for the
    float model and quantized one layer at a time
    (:func:`..quantization.serving.quantize_params_for_serving`), so no
    more than one float layer exists at once: a model too large for the
    card in bf16 is made on it quantized."""
    from ..quantization.serving import quantize_params_for_serving

    sd, group, group_of = {}, {}, None

    def flush():
        sd.update(quantize_params_for_serving(cfg, group)
                  if cfg.weight_quant else group)
        group.clear()

    for name, t in draw_state_dict(cfg, seed, std, device, model_cls):
        # a layer's tensors are quantized together, the others one by one
        key = ".".join(name.split(".")[:2]) if name.startswith(
            "layers.") else name
        if key != group_of:
            flush()
            group_of = key
        group[name] = t
    flush()
    return sd


def draw_state_dict(cfg: LlamaConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None, model_cls=LlamaForCausalLM
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The whole float weights of :func:`init_state_dict` one tensor at a
    time, in its order and from the same generator, so a caller can keep
    a part of each (a rank its shards) and free the rest before the next
    is made."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = model_cls(replace(cfg, weight_quant=None, tp_size=None,
                               sequence_parallel=False),
                       device="meta").state_dict()
    for name in sorted(shapes, key=is_lora_path):
        yield name, _draw(name, shapes[name], gen, std, dev)


def _draw(name: str, t: torch.Tensor, gen: torch.Generator, std: float,
          dev: torch.device) -> torch.Tensor:
    """One tensor of :func:`init_state_dict`: ones for a norm scale, zeros
    for an adapter's zero factor, normal(0, ``std``) otherwise."""
    if name.endswith(".scale"):
        return torch.ones(t.shape, dtype=t.dtype, device=dev)
    if is_lora_path(name) and name.endswith(
            "lora_a" if name.startswith("embed.") else "lora_b"):
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)
    return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                       device=dev).mul_(std)


def init_lora_state(cfg: LlamaConfig, seed: int = 0, std: float = 0.02,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Fresh adapters of ``cfg.lora`` alone, as :func:`init_state_dict`
    makes them (a zero B, or A for the embedding), from a generator seeded
    with ``seed``: what :func:`..lora.merge_lora_state` adds to a base
    checkpoint (a converted one, say) to start LoRA training."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = LlamaForCausalLM(cfg, device="meta").state_dict()
    return {name: _draw(name, t, gen, std, dev)
            for name, t in shapes.items() if is_lora_path(name)}


def paged_forward(model: LlamaForCausalLM, input_ids: torch.Tensor,
                  positions: torch.Tensor, kv_cache: PagedKVCache,
                  slot_ids: torch.Tensor,
                  run_layer: Callable[..., torch.Tensor],
                  return_hidden: bool = False):
    """The paged plumbing shared by the model families: embedding, rope,
    each token's block table and pool write index, the stored positions,
    then ``x = run_layer(layer, x, cos, sin, rope_pos, view)`` per layer,
    the final norm and the LM head. Returns ``(logits [1, T, V],
    kv_cache)``, and the final-norm hidden states after them with
    ``return_hidden``; the pool is written in place."""
    cfg = model.cfg
    if input_ids.dim() != 2 or input_ids.shape[0] != 1:
        raise ValueError("paged decode packs requests into one row batch "
                         f"[1, T]; got {tuple(input_ids.shape)}")
    positions = positions.to(torch.int32)
    x = model.embed(input_ids)
    cos, sin = model.rope_tables(input_ids.device)
    # rope lookup needs in-table indices; sentinel pads clamp to the last
    # entry (their K values are garbage but never land or are attended).
    # As in the JAX model, the clamped positions are also the query
    # positions of the attention mask.
    rope_pos = torch.clamp(positions, max=cfg.max_seq_len - 1)
    # per-token routing: each packed token carries its slot's block table
    # row (pad slot ids clip to the last slot) and a flat pool index for
    # this step's K/V write (a spare row past the pool's blocks for rows
    # that must not land)
    slot = torch.clamp(slot_ids.long(), 0, kv_cache.max_slots - 1)
    tok_tables = kv_cache.block_tables[slot]
    at = spread_dropped_rows(
        flat_write_indices(tok_tables, positions[0], kv_cache.block_size,
                           kv_cache.capacity),
        kv_cache.capacity, kv_cache.block_size)
    scatter_pool_rows(pool_rows(kv_cache.pos, layered=False), positions[0],
                      at)
    quantized = isinstance(kv_cache, QuantizedPagedKVCache)
    pools = {"k": kv_cache.k, "v": kv_cache.v}
    if quantized:
        pools.update(k_scale=kv_cache.k_scale, v_scale=kv_cache.v_scale)
    flat = {name: pool_rows(t) for name, t in pools.items()}
    for i, layer in enumerate(model.layers):
        view = PagedCacheView(
            k=kv_cache.k[i], v=kv_cache.v[i],
            k_scale=kv_cache.k_scale[i] if quantized else None,
            v_scale=kv_cache.v_scale[i] if quantized else None,
            pos=kv_cache.pos, tables=tok_tables,
            rows={name: t[i] for name, t in flat.items()}, at=at)
        x = run_layer(layer, x, cos, sin, rope_pos, view)
    return _head(model, x, kv_cache, return_hidden)


def _head(model: LlamaForCausalLM, x: torch.Tensor, kv_cache,
          return_hidden: bool):
    """The final norm and the LM head: ``(logits, cache)``, and the
    post-norm hidden states (the Medusa heads' input) with
    ``return_hidden``."""
    x = model.norm(x)
    if return_hidden:
        return model.logits(x), kv_cache, x
    return model.logits(x), kv_cache


def contiguous_forward(model: LlamaForCausalLM, input_ids: torch.Tensor,
                       positions: torch.Tensor, kv_cache: KVCache,
                       run_layer: Callable[..., torch.Tensor],
                       return_hidden: bool = False):
    """The contiguous-cache plumbing shared by the model families (JAX
    ``models/llama.py:1146-1215``): embedding, rope, this step's positions
    recorded at ``index``, then ``x = run_layer(layer, x, cos, sin,
    rope_pos, view)`` per layer, the final norm and the LM head. Returns
    ``(logits [B, S, V], cache)``: the cache's tensors are written in
    place and the returned cache's ``index`` is ``index + S``.

    The JAX write (``dynamic_update_slice``) clamps its start so that the
    slice fits; a step that would run past ``S_max`` raises here instead
    of shifting its write."""
    if not isinstance(kv_cache, KVCache):
        raise TypeError(f"unknown cache type {type(kv_cache).__name__}")
    cfg = model.cfg
    b, s = input_ids.shape
    idx = kv_cache.index
    if not isinstance(idx, torch.Tensor) and idx + s > kv_cache.max_len:
        raise ValueError(f"a step of {s} tokens at slot {idx} overflows the "
                         f"cache's {kv_cache.max_len} slots")
    positions = positions.to(torch.int32)
    x = model.embed(input_ids)
    cos, sin = model.rope_tables(input_ids.device)
    # as in the paged path, the clamped positions are the rope positions
    # and the attention's query positions; the cache stores the true ones
    # (PAD_POSITION for pads)
    rope_pos = torch.clamp(positions, max=cfg.max_seq_len - 1)
    kv_cache.pos[:, write_slots(idx, s, kv_cache.max_len)] = positions
    quantized = isinstance(kv_cache, QuantizedKVCache)
    for i, layer in enumerate(model.layers):
        view = ContiguousCacheView(
            k=kv_cache.k[i], v=kv_cache.v[i],
            k_scale=kv_cache.k_scale[i] if quantized else None,
            v_scale=kv_cache.v_scale[i] if quantized else None,
            pos=kv_cache.pos, index=idx)
        x = run_layer(layer, x, cos, sin, rope_pos, view)
    return _head(model, x, replace(kv_cache, index=idx + s), return_hidden)


def cached_forward(model: LlamaForCausalLM, input_ids: torch.Tensor,
                   positions: torch.Tensor, kv_cache,
                   slot_ids: Optional[torch.Tensor],
                   run_layer: Callable[..., torch.Tensor],
                   return_hidden: bool = False):
    """Dispatch on the cache's type, as the JAX
    ``llama_forward_with_cache`` does: a paged pool needs ``slot_ids`` and
    a batch of one packed row; a contiguous cache takes neither."""
    if isinstance(kv_cache, PagedKVCache):
        if slot_ids is None:
            raise ValueError("paged cache forward requires slot_ids [T]")
        return paged_forward(model, input_ids, positions, kv_cache,
                             slot_ids, run_layer, return_hidden)
    return contiguous_forward(model, input_ids, positions, kv_cache,
                              run_layer, return_hidden)


@torch.no_grad()
def llama_forward_with_cache(model: LlamaForCausalLM,
                             input_ids: torch.Tensor,
                             positions: torch.Tensor, kv_cache,
                             slot_ids: Optional[torch.Tensor] = None,
                             return_hidden: bool = False):
    """KV-cached forward of one step.

    Paged pool (:class:`..inference.paging.PagedKVCache` or its int8
    variant): ``input_ids``/``positions`` ``[1, T]``, ``slot_ids [T]``
    mapping each packed token to its cache slot (pad rows carry
    ``max_slots`` and position PAD_POSITION); writes the step's positions
    and K/V into the pool **in place** and returns ``(logits [1, T, V],
    kv_cache)``.

    Contiguous cache (:class:`..inference.kv_cache.KVCache` or
    ``QuantizedKVCache``): ``input_ids``/``positions`` ``[B, S]``, no
    ``slot_ids``; writes at ``kv_cache.index`` in place and returns
    ``(logits [B, S, V], cache with index + S)``.

    ``return_hidden`` appends the final-norm hidden states ``[B, S, H]``
    (the Medusa heads' input) to either return."""
    return cached_forward(model, input_ids, positions, kv_cache, slot_ids,
                          lambda layer, *args: layer(*args), return_hidden)
