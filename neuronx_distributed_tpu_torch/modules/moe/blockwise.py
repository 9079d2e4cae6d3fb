"""Routing metadata of the dropless (blockwise) MoE path (counterpart of
``neuronx_distributed_tpu/modules/moe/blockwise.py``).

Tokens are sorted by expert and laid out in fixed-size blocks, each expert's
rows padded to whole blocks; the grouped GLU (:mod:`...ops.blockwise_moe`)
then runs each block through its expert. Every shape here is fixed by ``T``,
``K``, ``E`` and the block size: the worst case is ``T·K + E·B`` padded
slots. The integer outputs equal the JAX package's bit for bit: a stable
sort, ``bincount`` with ``minlength`` and ``searchsorted(right=True)``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def compute_block_metadata(idx: torch.Tensor, num_experts: int,
                           block_size: int, sentinel_empty: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor, int, int]:
    """``idx [T, K]`` expert ids -> ``(order, src, dest_slot, block_expert,
    num_blocks, padded)``, the tensors int32:

    * ``order [T*K]``: flat pair index (token·K + choice) in stable
      sorted-by-expert order; ``src [T*K]`` the token of each sorted pair;
    * ``dest_slot [T*K]``: each sorted pair's row in the block layout;
    * ``block_expert [num_blocks]``: each block's expert. Every expert owns
      at least one block, and blocks past the last expert's rows belong to
      the last expert;
    * ``num_blocks``, ``padded``: ``(round_up(T·K, B) + E·B) / B`` blocks,
      ``padded`` rows.

    ``sentinel_empty`` (decode, forward only): blocks that hold no real row
    get the sentinel id ``num_experts``, so the grouped GLU skips them and
    reads only the experts the tokens hit.
    """
    t, k = idx.shape
    tk = t * k
    dev = idx.device
    flat = idx.reshape(tk).long()
    order = torch.sort(flat, stable=True).indices
    sorted_expert = flat[order]
    src = order // k
    counts = torch.bincount(flat, minlength=num_experts)
    padded_counts = torch.clamp(
        (counts + block_size - 1) // block_size * block_size, min=block_size)
    starts = torch.cumsum(counts, 0) - counts
    padded_starts = torch.cumsum(padded_counts, 0) - padded_counts
    pos_in_expert = torch.arange(tk, device=dev) - starts[sorted_expert]
    dest_slot = padded_starts[sorted_expert] + pos_in_expert

    padded = round_up(tk, block_size) + num_experts * block_size
    num_blocks = padded // block_size
    block_start = torch.arange(num_blocks, device=dev) * block_size
    ends = torch.cumsum(padded_counts, 0)
    owner = torch.searchsorted(ends, block_start, right=True)
    safe = torch.clamp(owner, max=num_experts - 1)
    block_expert = safe
    if sentinel_empty:
        real_end = padded_starts[safe] + counts[safe]
        has_real = (owner < num_experts) & (block_start < real_end)
        block_expert = torch.where(has_real, safe,
                                   torch.full_like(safe, num_experts))
    i32 = torch.int32
    return (order.to(i32), src.to(i32), dest_slot.to(i32),
            block_expert.to(i32), num_blocks, padded)


def scatter_to_blocks(x: torch.Tensor, src: torch.Tensor,
                      dest_slot: torch.Tensor, padded: int) -> torch.Tensor:
    """Sorted (token, choice) rows into the block layout ``[P, H]``; the
    padding rows stay zero."""
    xs = x.new_zeros((padded, x.shape[-1]))
    xs[dest_slot.long()] = x[src.long()]
    return xs


def combine_from_blocks(ys: torch.Tensor, gates: torch.Tensor,
                        order: torch.Tensor, src: torch.Tensor,
                        dest_slot: torch.Tensor,
                        num_tokens: int) -> torch.Tensor:
    """Invert the scatter and combine, ``y[t] = Σ_k gates[t, k] ·
    expert_out``, in ``ys.dtype``. With top-2 each token's row gets two
    adds onto zero, so their order cannot change the sum."""
    rows = ys[dest_slot.long()]
    pair_gate = gates.reshape(-1)[order.long()]
    out = ys.new_zeros((num_tokens, ys.shape[-1]))
    return out.index_add_(0, src.long(), rows * pair_gate[:, None].to(ys.dtype))
