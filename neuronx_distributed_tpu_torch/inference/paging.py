"""Paged KV cache: one block pool shared by every request (counterpart of
``neuronx_distributed_tpu/inference/paging.py``).

Every layer shares one pool ``[L, num_blocks, block_size, KV, D]``; a
request owns an arbitrary set of blocks, named by its row of
``block_tables``. Allocation happens on the host between steps
(:class:`BlockAllocator`); the pool, the tables and the stored positions
are fixed-shape tensors, so the serving step's shapes never change with
load.

Masking follows the contiguous cache's convention: each pool slot stores
the true token position it holds (``PAD_POSITION`` when empty), and the
causal mask is ``q_pos >= slot_pos``.

Unlike the JAX version, which is functional and donates the pool to the
step, the writes here update the pool **in place**: at Llama-3-8B's serving
size the pool is 4 GiB, and a functional update would hold a second copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from .kv_cache import PAD_POSITION


class CacheExhaustedError(RuntimeError):
    """The block pool has no free block for a required allocation."""


@dataclass
class PagedKVCache:
    """Shared-pool paged cache.

    ``k``/``v`` ``[L, num_blocks, block_size, KV, D]``; ``pos``
    ``[num_blocks, block_size]`` int32 true token position per pool slot
    (PAD_POSITION when empty; shared by all layers); ``block_tables``
    ``[max_slots, max_blocks_per_seq]`` int32, entry ``-1`` = unmapped;
    ``lengths`` ``[max_slots]`` int32 tokens resident per slot
    (host-maintained bookkeeping, not read by the step).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    block_size: int = 16

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def capacity(self) -> int:
        return self.k.shape[1] * self.k.shape[2]

    @property
    def max_slots(self) -> int:
        return self.block_tables.shape[0]

    @property
    def max_blocks_per_seq(self) -> int:
        return self.block_tables.shape[1]


@dataclass
class QuantizedPagedKVCache(PagedKVCache):
    """Int8 pool variant: K/V int8 with one fp32 scale per pool vector
    (``k_scale``/``v_scale`` ``[L, num_blocks, block_size, KV]``), the
    symmetric per-vector scheme of :func:`.kv_cache.quantize_kv`."""

    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class PagedCacheView:
    """One layer's pool slice plus this step's routing, handed to
    ``LlamaAttention``: ``tables [T, max_blocks_per_seq]`` is the per-token
    block table (each packed token carries its slot's row), ``rows`` the
    packed rows whose K/V land this step and ``at`` their flat pool
    indices (pad rows are not in ``rows``)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    pos: torch.Tensor
    tables: torch.Tensor
    rows: torch.Tensor
    at: torch.Tensor


def _routing(num_blocks, block_size, max_slots, max_blocks_per_seq, dev):
    return dict(
        pos=torch.full((num_blocks, block_size), PAD_POSITION,
                       dtype=torch.int32, device=dev),
        block_tables=torch.full((max_slots, max_blocks_per_seq), -1,
                                dtype=torch.int32, device=dev),
        lengths=torch.zeros((max_slots,), dtype=torch.int32, device=dev),
        block_size=block_size)


def init_paged_kv_cache(num_layers: int, num_blocks: int, block_size: int,
                        num_kv_heads: int, head_dim: int, max_slots: int,
                        max_blocks_per_seq: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device: DeviceLike = None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        **_routing(num_blocks, block_size, max_slots, max_blocks_per_seq,
                   dev))


def init_quantized_paged_kv_cache(num_layers: int, num_blocks: int,
                                  block_size: int, num_kv_heads: int,
                                  head_dim: int, max_slots: int,
                                  max_blocks_per_seq: int,
                                  device: DeviceLike = None
                                  ) -> QuantizedPagedKVCache:
    dev = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return QuantizedPagedKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=dev),
        v=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
        **_routing(num_blocks, block_size, max_slots, max_blocks_per_seq,
                   dev))


# ---------------------------------------------------------------------------
# Host-side block allocation. Runs between steps; the device only ever sees
# the resulting (fixed-shape) block tables.
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted free-list over the shared pool's ``num_blocks`` block
    ids. ``alloc`` hands out blocks with refcount 1; :meth:`ref` lets a
    second owner pin the same block; :meth:`free` is an *unref* — a block
    returns to the free list only when its last reference drops, and
    :meth:`free` reports exactly which blocks did.

    ``cp_size > 1`` splits the id space into ``cp_size`` contiguous rank
    slices (rank ``r`` owns ``[r * num_blocks/cp, (r+1) * num_blocks/cp)``).
    ``alloc(rank=r)`` places strictly on one slice; ``alloc(rank=None)``
    takes from whichever slice has the most free blocks and raises
    :class:`CacheExhaustedError` only when the whole pool cannot cover the
    demand. The state after any sequence of calls is the JAX allocator's.
    """

    def __init__(self, num_blocks: int, cp_size: int = 1):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        if cp_size < 1:
            raise ValueError(f"cp_size must be >= 1, got {cp_size}")
        if num_blocks % cp_size != 0:
            raise ValueError(
                f"num_blocks ({num_blocks}) must divide evenly over "
                f"cp_size ({cp_size}) rank slices")
        self.num_blocks = num_blocks
        self.cp_size = cp_size
        self.blocks_per_rank = num_blocks // cp_size
        self.reset()

    def rank_of(self, block: int) -> int:
        """cp rank whose pool slice holds ``block``."""
        return block // self.blocks_per_rank

    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._free)

    def free_per_rank(self) -> List[int]:
        """Free-block count per cp rank slice (``[num_free]`` at cp=1)."""
        return [len(f) for f in self._free]

    @property
    def num_allocated(self) -> int:
        return self.num_blocks - self.num_free

    @property
    def num_shared(self) -> int:
        """Blocks currently held by more than one reference."""
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int = 1, rank: Optional[int] = None) -> List[int]:
        """Take ``n`` blocks off the free list (refcount 1 each); raises
        :class:`CacheExhaustedError` (allocating nothing) when fewer than
        ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if rank is not None:
            if not 0 <= rank < self.cp_size:
                raise ValueError(
                    f"rank {rank} out of range for cp_size {self.cp_size}")
            pool = self._free[rank]
            if n > len(pool):
                raise CacheExhaustedError(
                    f"requested {n} block(s) on cp rank {rank} but only "
                    f"{len(pool)} of {self.blocks_per_rank} are free")
            out = [pool.pop() for _ in range(n)]
        else:
            if n > self.num_free:
                raise CacheExhaustedError(
                    f"requested {n} block(s) but only {self.num_free} of "
                    f"{self.num_blocks} are free")
            out = [max(self._free, key=len).pop() for _ in range(n)]
        self._allocated.update(out)
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, block: int) -> None:
        """Add a reference to an already-allocated block."""
        if block not in self._allocated:
            raise ValueError(f"cannot ref unallocated block {block}")
        self._refs[block] += 1

    def free(self, blocks: Sequence[int]) -> List[int]:
        """Drop one reference per listed block; returns the blocks whose
        refcount hit zero and were actually returned to the free list."""
        freed: List[int] = []
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(
                    f"block {b} is not allocated (double free?)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._allocated.discard(b)
                self._free[self.rank_of(b)].append(b)
                freed.append(b)
        return freed

    def reset(self) -> None:
        # lowest block ids pop first (per rank slice)
        self._free = [
            list(range((r + 1) * self.blocks_per_rank - 1,
                       r * self.blocks_per_rank - 1, -1))
            for r in range(self.cp_size)]
        self._allocated: set = set()
        self._refs: dict = {}


# ---------------------------------------------------------------------------
# Pool writes. A row whose flat index is == capacity must not land (the JAX
# scatters use mode="drop"); on CUDA an out-of-range index_put_ faults, so
# the rows are filtered first.
# ---------------------------------------------------------------------------

def flat_write_indices(tok_tables: torch.Tensor, positions: torch.Tensor,
                       block_size: int, capacity: int) -> torch.Tensor:
    """``[T, max_blocks_per_seq]`` per-token block tables + ``[T]`` true
    positions -> ``[T]`` int32 flat pool indices. Rows whose position is
    padding (PAD_POSITION), beyond the table, or mapped to ``-1`` get index
    == ``capacity``."""
    positions = positions.to(torch.int32)
    blk_of_pos = torch.div(positions, block_size, rounding_mode="floor")
    maxb = tok_tables.shape[1]
    safe = torch.clamp(blk_of_pos, 0, maxb - 1).long()
    blk = torch.gather(tok_tables, 1, safe[:, None])[:, 0]
    flat = blk * block_size + torch.remainder(positions, block_size)
    valid = (positions < PAD_POSITION) & (blk_of_pos < maxb) & (blk >= 0)
    return torch.where(valid, flat, torch.full_like(flat, capacity)
                       ).to(torch.int32)


def valid_write_rows(flat_idx: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row numbers (int64) whose write lands; computed once per step and
    reused by every layer's scatter."""
    return torch.nonzero(flat_idx < capacity).squeeze(1)


def scatter_pool_rows(pool: torch.Tensor, rows: torch.Tensor,
                      flat_idx: torch.Tensor) -> torch.Tensor:
    """In place: ``pool`` viewed as ``[num_blocks * block_size, ...]``
    takes ``rows[i]`` at ``flat_idx[i]``. Every index must be in range."""
    nb, bs = pool.shape[:2]
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    flat.index_copy_(0, flat_idx.long(), rows.to(pool.dtype))
    return pool


def write_pool_rows(pool: torch.Tensor, rows: torch.Tensor,
                    flat_idx: torch.Tensor) -> torch.Tensor:
    """Scatter ``rows [T, ...]`` into ``pool [num_blocks, block_size,
    ...]`` in place at the flat indices from :func:`flat_write_indices`,
    dropping rows whose index is the capacity sentinel."""
    keep = valid_write_rows(flat_idx, pool.shape[0] * pool.shape[1])
    return scatter_pool_rows(pool, rows[keep], flat_idx[keep])


def write_pool_positions(pos: torch.Tensor, positions: torch.Tensor,
                         flat_idx: torch.Tensor) -> torch.Tensor:
    """Record this step's true token positions in the ``[num_blocks,
    block_size]`` slot-position table in place (shared by all layers,
    written once per step)."""
    return write_pool_rows(pos, positions, flat_idx)
