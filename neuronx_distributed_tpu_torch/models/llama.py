"""Llama (counterpart of ``neuronx_distributed_tpu/models/llama.py`` at
tp=1): the paged serving path and the training forward.

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
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..inference.kv_cache import quantize_kv
from ..inference.paging import (PagedCacheView, PagedKVCache,
                                QuantizedPagedKVCache, flat_write_indices,
                                scatter_pool_rows, valid_write_rows)
from ..modules.attention import (apply_rotary, attention_dropout_seed,
                                 precompute_rope, repeat_kv, sdpa_reference)
from ..modules.norms import RMSNorm
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention
from ..parallel.layers import (GQAQKVColumnParallelLinear, Linear,
                               ParallelEmbedding)
from ..parallel.loss_functions import causal_lm_loss


@dataclass(frozen=True)
class LlamaConfig:
    """The fields of the JAX ``LlamaConfig`` that the paged serving path and
    the single-device training step honour. ``attention_dropout`` is active
    only when the caller passes a ``dropout_generator``."""

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

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


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


def _paged_cache_attend(cfg: LlamaConfig, q, k, v, positions,
                        view: PagedCacheView) -> torch.Tensor:
    """Write this step's K/V rows into the layer's pool slice (quantized
    for an int8 pool), then attend through the per-token block tables. The
    write lands before the attention reads, so each token sees its own row.
    The packed batch is ``[1, T]``."""
    k_rows, v_rows = k[0][view.rows], v[0][view.rows]    # [W, KV, D]
    if view.k_scale is not None:
        qk, ks = quantize_kv(k_rows)
        qv, vs = quantize_kv(v_rows)
        scatter_pool_rows(view.k, qk, view.at)
        scatter_pool_rows(view.v, qv, view.at)
        scatter_pool_rows(view.k_scale, ks, view.at)
        scatter_pool_rows(view.v_scale, vs, view.at)
    else:
        scatter_pool_rows(view.k, k_rows, view.at)
        scatter_pool_rows(view.v, v_rows, view.at)
    out = paged_attention(q[0], view.k, view.v, view.pos, view.tables,
                          positions[0], k_scale=view.k_scale,
                          v_scale=view.v_scale,
                          scale=1.0 / math.sqrt(q.shape[-1]))[None]
    return out.to(cfg.dtype)


def _causal_attend(cfg: LlamaConfig, q, k, v,
                   dropout_generator: Optional[torch.Generator]):
    """The no-cache branch at cp=1 (JAX ``models/llama.py:488-540``): flash
    attention, which reads the GQA K/V heads natively, or the dense
    reference on K/V expanded by ``repeat_kv``."""
    dropout_p, seed = attention_dropout_seed(cfg.attention_dropout,
                                             dropout_generator)
    if cfg.use_flash_attention:
        return flash_attention(q, k, v, causal=True, dropout_p=dropout_p,
                               dropout_seed=seed)
    n_rep = q.shape[2] // k.shape[2]
    return sdpa_reference(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                          causal=True, dropout_p=dropout_p,
                          dropout_seed=seed)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim_
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, d,
            dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype)
        self.o_proj = Linear(cfg.num_heads * d, cfg.hidden_size,
                             dtype=cfg.dtype, device=device,
                             param_dtype=cfg.param_dtype)

    def forward(self, x, cos, sin, positions,
                view: Optional[PagedCacheView] = None,
                dropout_generator: Optional[torch.Generator] = None):
        """With a paged ``view``, the serving step; without, causal
        self-attention over the sequence (training)."""
        cfg = self.cfg
        d = cfg.head_dim_
        q, k, v = self.qkv(x)
        b, s = q.shape[:2]
        q = apply_rotary(q.reshape(b, s, cfg.num_heads, d), cos, sin,
                         positions)
        k = apply_rotary(k.reshape(b, s, cfg.num_kv_heads, d), cos, sin,
                         positions)
        v = v.reshape(b, s, cfg.num_kv_heads, d)
        if view is not None:
            out = _paged_cache_attend(cfg, q, k, v, positions, view)
        else:
            out = _causal_attend(cfg, q, k, v, dropout_generator)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * d))


class LlamaMLP(nn.Module):
    """SwiGLU with the fused ``gate_up_kernel [H, 2, I]`` (index 0 = gate,
    1 = up) and ``down``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate_up_kernel = nn.Parameter(torch.empty(
            (cfg.hidden_size, 2, cfg.intermediate_size),
            dtype=cfg.param_dtype, device=device))
        self.down = Linear(cfg.intermediate_size, cfg.hidden_size,
                           dtype=cfg.dtype, device=device,
                           param_dtype=cfg.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_dim, _, i_dim = self.gate_up_kernel.shape
        h = torch.matmul(x.to(self.cfg.dtype),
                         self.gate_up_kernel.reshape(h_dim, 2 * i_dim).to(
                             self.cfg.dtype))
        h = h.unflatten(-1, (2, i_dim))
        return self.down(F.silu(h[..., 0, :]) * h[..., 1, :])


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
                view: Optional[PagedCacheView] = None,
                dropout_generator: Optional[torch.Generator] = None):
        x = x + self.attn(self.input_norm(x), cos, sin, positions, view,
                          dropout_generator)
        return x + self.mlp(self.post_norm(x))


class LlamaForCausalLM(nn.Module):
    """Embedding, decoder stack, final norm and an untied LM head.
    Parameters are allocated uninitialised in ``cfg.param_dtype``: load a
    state dict (:func:`build_model`, :func:`.convert.load_jax_params`,
    ``initialize_parallel_model``) or make one (:func:`init_state_dict`)."""

    layer_cls = LlamaDecoderLayer

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        pdt = cfg.param_dtype
        self.cfg = cfg
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                       dtype=cfg.dtype, device=dev,
                                       param_dtype=pdt)
        self.layers = nn.ModuleList(
            [self.layer_cls(cfg, dev) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, dev, pdt)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              dtype=cfg.dtype, device=dev, param_dtype=pdt)
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def hidden(self, input_ids: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """The JAX ``LlamaModel`` (``models/llama.py:872``): embedding, the
        decoder layers (unrolled) and the final norm over ``input_ids [B,
        S]``; rope positions default to ``arange(S)``."""
        x = self.embed(input_ids)
        cos, sin = self.rope_tables(input_ids.device)
        for layer in self.layers:
            x = layer(x, cos, sin, positions, None, dropout_generator)
        return self.norm(x)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                ignore_index: int = -100,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in ``cfg.dtype``, or, given ``labels`` (the
        next-token ids, already shifted), the mean causal-LM loss over the
        labels that are not ``ignore_index``."""
        logits = self.lm_head(self.hidden(input_ids, positions,
                                          dropout_generator))
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


def build_model(cfg: LlamaConfig, state_dict: Dict[str, torch.Tensor],
                device: DeviceLike = None,
                model_cls=LlamaForCausalLM) -> LlamaForCausalLM:
    """A serving model, frozen, whose parameters are ``state_dict``'s
    tensors moved to ``device`` and ``cfg.dtype`` (no copy where they
    already are): serving holds its weights in the compute dtype. A
    parameter the model holds in fp32 whatever its dtypes (the MoE router's
    kernel) stays in fp32."""
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
    a parameter held so)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = model_cls(cfg, device="meta").state_dict()
    sd = {}
    for name, t in shapes.items():
        if name.endswith(".scale"):
            sd[name] = torch.ones(t.shape, dtype=t.dtype, device=dev)
        else:
            sd[name] = torch.randn(t.shape, generator=gen, dtype=t.dtype,
                                   device=dev).mul_(std)
    return sd


def paged_forward(model: LlamaForCausalLM, input_ids: torch.Tensor,
                  positions: torch.Tensor, kv_cache: PagedKVCache,
                  slot_ids: torch.Tensor,
                  run_layer: Callable[..., torch.Tensor]):
    """The paged plumbing shared by the model families: embedding, rope,
    each token's block table and pool write index, the stored positions,
    then ``x = run_layer(layer, x, cos, sin, rope_pos, view)`` per layer,
    the final norm and the LM head. Returns ``(logits [1, T, V],
    kv_cache)``; the pool is written in place."""
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
    # this step's K/V write (== capacity for rows that must not land)
    slot = torch.clamp(slot_ids.long(), 0, kv_cache.max_slots - 1)
    tok_tables = kv_cache.block_tables[slot]
    write_idx = flat_write_indices(tok_tables, positions[0],
                                   kv_cache.block_size, kv_cache.capacity)
    rows = valid_write_rows(write_idx, kv_cache.capacity)
    at = write_idx[rows]
    scatter_pool_rows(kv_cache.pos, positions[0][rows], at)
    quantized = isinstance(kv_cache, QuantizedPagedKVCache)
    for i, layer in enumerate(model.layers):
        view = PagedCacheView(
            k=kv_cache.k[i], v=kv_cache.v[i],
            k_scale=kv_cache.k_scale[i] if quantized else None,
            v_scale=kv_cache.v_scale[i] if quantized else None,
            pos=kv_cache.pos, tables=tok_tables, rows=rows, at=at)
        x = run_layer(layer, x, cos, sin, rope_pos, view)
    logits = model.lm_head(model.norm(x))
    return logits, kv_cache


@torch.no_grad()
def llama_forward_with_cache(model: LlamaForCausalLM,
                             input_ids: torch.Tensor,
                             positions: torch.Tensor,
                             kv_cache: PagedKVCache,
                             slot_ids: torch.Tensor):
    """Paged-pool forward of one packed step: ``input_ids``/``positions``
    ``[1, T]``, ``slot_ids [T]`` mapping each packed token to its cache
    slot (pad rows carry ``max_slots`` and position PAD_POSITION). Writes
    the step's positions and K/V into the pool **in place** and returns
    ``(logits [1, T, V], kv_cache)``."""
    return paged_forward(model, input_ids, positions, kv_cache, slot_ids,
                         lambda layer, *args: layer(*args))
