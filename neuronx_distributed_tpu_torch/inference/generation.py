"""Greedy or sampled generation through the contiguous KV cache
(counterpart of ``neuronx_distributed_tpu/inference/generation.py``).

The prompt is right-padded to a bucketed length and prefilled in one
forward; the decode loop then runs one forward a token. Both keep the
reference's shapes: the cache is ``bucket + steps`` long, ``steps``
bucketed over ``decode_buckets``, so a later capture of each bucket's step
serves every request length within it. The loop is a Python loop in place
of ``lax.scan``: it runs ``max_new_tokens`` steps and skips the last,
unused forward (the reference computes the scan's tail and slices it
off), and it never reads a device value to stop early.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..models.llama import LlamaForCausalLM, llama_forward_with_cache
from .kv_cache import PAD_POSITION, KVCache, init_kv_cache
from .sampling import SamplingConfig, sample

#: Decode-length buckets: one decode shape per bucket, not per distinct
#: ``max_new_tokens``.
DECODE_BUCKETS = (64, 256, 1024)


def pick_bucket(length: int, buckets: Sequence[int], cp: int = 1) -> int:
    """Smallest bucket >= ``length``. ``cp > 1`` scales every bucket by
    the context-parallel degree (the table describes what one mesh's slice
    holds). Raises ``ValueError`` past the largest."""
    ordered = sorted(b * max(1, int(cp)) for b in buckets)
    for b in ordered:
        if b >= length:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{ordered[-1]}")


def prefill(model: LlamaForCausalLM, input_ids: torch.Tensor,
            prompt_len: torch.Tensor, cache: KVCache,
            forward: Callable = llama_forward_with_cache):
    """Run the right-padded prompt ``input_ids [B, S]`` (real lengths
    ``prompt_len [B]``) through the model into ``cache``; pad slots store
    PAD_POSITION and are never attended. Returns the logits at
    ``prompt_len - 1`` ``[B, V]`` and the cache. ``forward`` is the model
    family's cached forward (``mixtral_forward_with_cache`` for Mixtral)."""
    b, s = input_ids.shape
    ar = torch.arange(s, dtype=torch.int32,
                      device=input_ids.device).expand(b, s)
    positions = torch.where(ar < prompt_len[:, None], ar,
                            torch.full_like(ar, PAD_POSITION))
    logits, cache = forward(model, input_ids, positions, cache)
    rows = torch.arange(b, device=logits.device)
    return logits[rows, prompt_len.long() - 1], cache


def decode_step(model: LlamaForCausalLM, token: torch.Tensor,
                position: torch.Tensor, cache: KVCache,
                forward: Callable = llama_forward_with_cache):
    """One token a row: ``token [B]`` at ``position [B]``; returns
    ``(logits [B, V], cache)``. ``forward`` as in :func:`prefill`."""
    logits, cache = forward(model, token[:, None], position[:, None], cache)
    return logits[:, 0], cache


def generate(model: LlamaForCausalLM, input_ids, prompt_len,
             max_new_tokens: int,
             sampling: SamplingConfig = SamplingConfig(greedy=True),
             generator: Optional[torch.Generator] = None,
             buckets: Sequence[int] = (128, 512, 2048),
             kv_dtype: Optional[torch.dtype] = None,
             eos_id: Optional[int] = None,
             decode_buckets: Sequence[int] = DECODE_BUCKETS) -> torch.Tensor:
    """``[B, max_new_tokens]`` continuations of the right-padded prompts
    ``input_ids [B, S]`` with real lengths ``prompt_len [B]`` (tensors,
    arrays or lists), on the device of ``model``'s weights (built, as every
    entry point, on the CUDA card unless the caller asked for the CPU).

    Each step samples from the previous logits (``generator`` drives a
    non-greedy ``sampling``; default: seed 0 on the model's device, in
    place of the reference's ``jax.random`` key), pins rows that already
    produced ``eos_id`` to it, then feeds the token back. Greedy ids are
    the reference's; sampled ids depend on the generator."""
    dev = model.embed.embedding.device
    input_ids = torch.as_tensor(input_ids, dtype=torch.int32).to(dev)
    prompt_len = torch.as_tensor(prompt_len, dtype=torch.int32).to(dev)
    cfg = model.cfg
    b, s = input_ids.shape
    bucket = pick_bucket(s, buckets)
    if bucket > s:
        input_ids = torch.nn.functional.pad(input_ids, (0, bucket - s))
    if generator is None and not sampling.greedy:
        generator = torch.Generator(device=dev).manual_seed(0)
    steps = (pick_bucket(max_new_tokens, decode_buckets)
             if max_new_tokens <= max(decode_buckets) else max_new_tokens)
    cache = init_kv_cache(cfg.num_layers, b, bucket + steps,
                          cfg.num_kv_heads, cfg.head_dim_,
                          dtype=kv_dtype or cfg.dtype, device=dev)
    logits, cache = prefill(model, input_ids, prompt_len, cache)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pos = prompt_len
    tokens = []
    for i in range(max_new_tokens):
        tok = sample(logits, generator, sampling)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        tokens.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(model, tok, pos, cache)
            pos = pos + 1
    return torch.stack(tokens, dim=1)
