"""Token sampling: greedy, or temperature / top-k / top-p with an explicit
``torch.Generator`` (counterpart of
``neuronx_distributed_tpu/inference/sampling.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 1.0
    top_k: int = 0       # 0 = disabled
    top_p: float = 1.0   # 1.0 = disabled
    greedy: bool = False


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplingConfig = SamplingConfig()) -> torch.Tensor:
    """Sample token ids from ``[B, V]`` logits. Greedy takes the first
    maximum, as ``jnp.argmax`` does, and ignores ``generator``."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits.float()
    if cfg.temperature != 1.0:
        logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest set with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]
