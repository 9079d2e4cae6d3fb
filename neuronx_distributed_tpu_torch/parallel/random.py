"""Per-rank random streams (counterpart of ``neuronx_distributed_tpu/
parallel/random.py``, JAX ``:25-45``).

Ranks of one tensor-parallel group need different streams for randomness
inside their shards (dropout on a head shard) and the same stream for
anything replicated. The reference folds the bound axes' indices into a
threefry key; the port seeds a ``torch.Generator`` per rank from the seed
and the rank's indices. A stated divergence: the law of the streams (equal
where the reference's are equal, independent where they differ) is the
reference's, their bits are not.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import mesh as ps

# the reference's tensor-parallel stream offset (random.py:100)
TENSOR_PARALLEL_SEED_OFFSET = 2718


def fold_in_axes(seed: int, axes: Sequence[str] = (ps.TP_AXIS,)) -> int:
    """A 63-bit seed from ``seed`` and this rank's index on each of
    ``axes`` of size above 1 (axes of size 1 leave it as it would be on
    one rank)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    if ps.model_parallel_is_initialized():
        for axis in axes:
            if ps.axis_size(axis) > 1:
                words += [len(axis), ps.axis_rank(axis)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def model_parallel_rng(seed: int, device=None) -> torch.Generator:
    """The stream for tensor-parallel randomness: one per tp rank, offset
    by 2718 from the replicated stream of ``seed``."""
    return _generator(fold_in_axes(seed + TENSOR_PARALLEL_SEED_OFFSET,
                                   (ps.TP_AXIS,)), device or "cpu")


def data_parallel_rng(seed: int, device=None) -> torch.Generator:
    """The stream that differs per dp (and cp) rank, e.g. for data
    augmentation; equal across a tp group."""
    return _generator(fold_in_axes(seed, (ps.DP_AXIS, ps.CP_AXIS)),
                      device or "cpu")
