"""Rotary embeddings, GQA head expansion, the dense reference attention and
the attention-dropout seed (counterparts of
``neuronx_distributed_tpu/modules/attention.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def apply_rope_scaling(freqs: torch.Tensor, scale_factor: float = 8.0,
                       low_freq_factor: float = 1.0,
                       high_freq_factor: float = 4.0,
                       original_max_position: int = 8192) -> torch.Tensor:
    """Llama-3 style rope frequency scaling."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * math.pi / freqs
    scaled = torch.where(wavelen > low_freq_wavelen, freqs / scale_factor,
                         freqs)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    mid = (1 - smooth) * freqs / scale_factor + smooth * freqs
    is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(is_mid, mid, scaled)


def precompute_rope(head_dim: int, max_len: int, theta: float = 10000.0,
                    use_scaled: bool = False,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables ``[max_len, head_dim//2]``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    if use_scaled:
        inv_freq = apply_rope_scaling(inv_freq)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply rotary embedding. ``x: [B, S, N, D]``; cos/sin ``[L, D/2]``;
    ``positions: [B, S]`` (defaults to arange). Computes in fp32, as the
    JAX version's type promotion does, and returns ``x.dtype``."""
    b, s, n, d = x.shape
    if positions is None:
        cos_p = cos[:s][None, :, None, :]
        sin_p = sin[:s][None, :, None, :]
    else:
        idx = positions.long()
        cos_p = cos[idx][:, :, None, :]
        sin_p = sin[idx][:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p],
                    dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, K, D] -> [B, S, K*n_rep, D] (GQA head expansion: query head
    ``n`` reads kv head ``n // n_rep``)."""
    if n_rep == 1:
        return x
    b, s, k, d = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n_rep, d).reshape(
        b, s, k * n_rep, d)


def attention_dropout_seed(rate: float,
                           generator: Optional[torch.Generator]
                           ) -> Tuple[float, Optional[int]]:
    """``(dropout_p, dropout_seed)``: dropout is on iff ``rate > 0`` and the
    caller passed a generator (training); one uint32 seed is drawn from it
    per attention call. The JAX package draws it from the module's
    ``"dropout"`` rng instead, so the two give different masks."""
    if rate > 0.0 and generator is not None:
        return rate, int(torch.randint(0, 2 ** 32, (), generator=generator,
                                       device=generator.device,
                                       dtype=torch.int64))
    return 0.0, None


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, dropout_p: float = 0.0,
                   dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Plain softmax attention in fp32, the JAX model's path when
    ``use_flash_attention`` is off. ``q``/``k``/``v`` ``[B, S, N, D]`` (K/V
    already GQA-expanded); masked scores are -1e30. Dropout uses the same
    counter hash as the flash kernels, so both draw one mask per seed."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(),
                          k.float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0:
        from ..ops.flash_attention import dropout_keep_mask, flat_bh

        keep = dropout_keep_mask(
            dropout_seed, flat_bh(b, n, q.device),
            torch.arange(sq, device=q.device)[None, None, :, None],
            torch.arange(sk, device=q.device)[None, None, None, :], sk,
            dropout_p)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)), 0.0)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v.float())
    return out.to(q.dtype)
