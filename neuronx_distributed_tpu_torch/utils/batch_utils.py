"""Batch utilities (counterpart of ``neuronx_distributed_tpu/utils/
batch_utils.py``): labels are shifted before the sequence is sliced over
context-parallel ranks, so token ``t``'s label (token ``t + 1``) stays on
the same shard at slice boundaries. Both are plain tensor slicing and need
no process group.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def shift_labels(labels: Any, ignore_index: int = -100) -> torch.Tensor:
    """Shift ``labels [B, S]`` left by one for next-token prediction; the
    last position gets ``ignore_index``. Returns a new tensor on the
    labels' device."""
    shifted = torch.roll(torch.as_tensor(labels), -1, dims=1).clone()
    shifted[:, -1] = ignore_index
    return shifted


def get_batch_on_this_context_parallel_rank(batch: Mapping[str, Any],
                                            cp_rank: int, cp_size: int
                                            ) -> Dict[str, Any]:
    """Slice the sequence dim (dim 1) of every ``[B, S, ...]`` entry of
    ``batch`` for one cp rank: contiguous chunks of ``S / cp_size``.
    Entries with fewer than two dims pass through as tensors; ``cp_size ==
    1`` returns ``batch`` itself. Raises when ``S`` does not divide."""
    if cp_size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.dim() >= 2:
            if v.shape[1] % cp_size != 0:
                raise ValueError(
                    f"batch[{k!r}] sequence length {v.shape[1]} not "
                    f"divisible by cp_size {cp_size}")
            chunk = v.shape[1] // cp_size
            v = v[:, cp_rank * chunk:(cp_rank + 1) * chunk]
        out[k] = v
    return out
