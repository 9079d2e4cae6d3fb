"""MoE token shuffling (counterpart of
``neuronx_distributed_tpu/modules/moe/token_shuffling.py``) at a shuffle
axis of size 1, where the all-to-all across the expert data-parallel
shards is the identity: a random permutation of the tokens before routing,
inverted after the MoE block.

The permutation comes from an explicit ``torch.Generator``. Given a
``step``, it is drawn from a generator seeded with the given one's
``initial_seed()`` and the step, so a replayed step (resume, a rewind)
shuffles the same way and the given generator is left as it was.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# odd 64-bit multiplier that spreads the step over the seed's bits
_STEP_MIX = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def _step_generator(generator: torch.Generator,
                    step: int) -> torch.Generator:
    seed = (generator.initial_seed() + (int(step) + 1) * _STEP_MIX) & _MASK64
    return torch.Generator(device=generator.device).manual_seed(seed)


def token_shuffle(x: torch.Tensor, generator: torch.Generator,
                  step: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [T, ...]`` -> ``(x[perm], perm)``, ``perm`` a permutation of
    ``T`` drawn from ``generator`` (on its device), or with ``step`` from
    ``generator``'s seed and the step alone."""
    gen = generator if step is None else _step_generator(generator, step)
    perm = torch.randperm(x.shape[0], generator=gen, device=gen.device)
    perm = perm.to(x.device)
    return x[perm], perm


def token_unshuffle(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Invert :func:`token_shuffle`: ``x[argsort(perm)]``."""
    return x[torch.argsort(perm)]
