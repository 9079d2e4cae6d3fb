"""MoE token shuffling (counterpart of
``neuronx_distributed_tpu/modules/moe/token_shuffling.py``): a random
permutation of the tokens before routing, so that hot prompts do not load
one shard's experts, inverted after the MoE block.

Over the shuffle axis (``dp_exp``, the expert view's data axis) each shard
permutes its own tokens, with a permutation of its own, then a tiled
all-to-all exchanges equal slices between the shards (differentiable: its
backward is the inverse all-to-all); :func:`token_unshuffle` runs the
all-to-all back and inverts the local permutation. Where the axis holds
one rank the all-to-all is the identity.

The permutation comes from an explicit ``torch.Generator``, not from
JAX's key, so the bits of the two packages differ (the tests hand both
the same permutation). Given a ``step``, it is drawn from a generator
seeded with the given one's ``initial_seed()`` and the step alone, so a
replayed step (resume, a rewind) shuffles the same way and the given
generator is left as it was; without one, the given generator draws it.
Over a shuffle axis above one rank the shard's index is mixed into the
seed (the reference folds it into its key), so the shards' permutations
differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...parallel import comm, mappings
from ...parallel import mesh as ps

# odd 64-bit multipliers that spread the step and the shard over the seed
_STEP_MIX = 0x9E3779B97F4A7C15
_SHARD_MIX = 0xD1B54A32D192ED03
_MASK64 = (1 << 64) - 1


def _step_generator(generator: torch.Generator,
                    step: int) -> torch.Generator:
    seed = (generator.initial_seed() + (int(step) + 1) * _STEP_MIX) & _MASK64
    return torch.Generator(device=generator.device).manual_seed(seed)


def _shard_generator(generator: torch.Generator, shard: int
                     ) -> torch.Generator:
    """A generator for shard ``shard``: a seed drawn from ``generator``
    (the same on every shard that shares its state) with the shard mixed
    in."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    seed = (base + (int(shard) + 1) * _SHARD_MIX) & _MASK64
    return torch.Generator(device=generator.device).manual_seed(seed)


def token_shuffle(x: torch.Tensor, generator: torch.Generator,
                  step: Optional[int] = None,
                  axis: ps.Axis = ps.EXP_DP_AXIS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [T, ...]`` -> ``(shuffled, perm)``: ``x[perm]`` exchanged over
    ``axis`` (its first dim split in equal slices, slice ``j`` to shard
    ``j``), ``perm`` this shard's permutation of ``T``, drawn from
    ``generator`` (on its device), or with ``step`` from ``generator``'s
    seed and the step alone; over an axis above one rank the shard's index
    is mixed in."""
    gen = generator if step is None else _step_generator(generator, step)
    n = comm.axis_size(axis)
    if n > 1:
        gen = _shard_generator(gen, comm.combined_axis_index(axis))
    perm = torch.randperm(x.shape[0], generator=gen, device=gen.device)
    perm = perm.to(x.device)
    x = x[perm]
    if n > 1:
        x = mappings.enter_expert_parallel_region(x, axis, 0, 0)
    return x, perm


def token_unshuffle(x: torch.Tensor, perm: torch.Tensor,
                    axis: ps.Axis = ps.EXP_DP_AXIS) -> torch.Tensor:
    """Invert :func:`token_shuffle`: the all-to-all back over ``axis``, then
    ``x[argsort(perm)]`` with this shard's ``perm``."""
    if comm.axis_size(axis) > 1:
        x = mappings.enter_expert_parallel_region(x, axis, 0, 0)
    return x[torch.argsort(perm)]
