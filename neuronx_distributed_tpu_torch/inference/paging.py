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
The pool tensors' storage holds one spare block past each layer's last, so
that a row the reference drops (JAX ``mode="drop"``) lands in a row nobody
reads: each write is one fixed-shape scatter with no host sync, and the
serving step can be captured in a CUDA graph.

Prefix sharing (:class:`PrefixCache`, :func:`cow_copy_blocks`) lets later
requests map the pool blocks of an earlier prompt's full blocks instead of
prefilling them again; a block that several owners map is cloned before a
divergent write. :func:`mask_pool_positions` un-publishes rows (the
speculation rollback), and :func:`extract_blocks` / :func:`inject_blocks`
carry blocks between pools as host arrays (session migration, prefix
shipping).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.bfloat16 import to_host, to_torch
from .kv_cache import PAD_POSITION


class CacheExhaustedError(RuntimeError):
    """The block pool has no free block for a required allocation."""


@dataclass
class PagedKVCache:
    """Shared-pool paged cache.

    ``k``/``v`` ``[L, num_blocks, block_size, KV, D]``; ``pos``
    ``[num_blocks, block_size]`` int32 true token position per pool slot
    (PAD_POSITION when empty; shared by all layers); ``block_tables``
    ``[rows, max_blocks_per_seq]`` int32, entry ``-1`` = unmapped, one row
    per table row of the engine (its slots, then the speculation lanes;
    ``max_slots`` below names that row count, as in the JAX cache);
    ``lengths`` ``[rows]`` int32 tokens resident per row (host-maintained
    bookkeeping, not read by the step).
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


def _pool_tensors(cache: PagedKVCache) -> Dict[str, torch.Tensor]:
    """The pool's per-layer tensors by name: k, v, and an int8 pool's
    scales."""
    out = {"k": cache.k, "v": cache.v}
    if isinstance(cache, QuantizedPagedKVCache):
        out.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    return out


@dataclass
class PagedCacheView:
    """One layer's pool slice plus this step's routing, handed to
    ``LlamaAttention``: ``tables [T, max_blocks_per_seq]`` is the per-token
    block table (each packed token carries its slot's row), ``at [T]`` each
    packed row's flat pool index (a spare row from ``capacity`` on for a
    row that must not land, a pad row: :func:`spread_dropped_rows`) and
    ``rows`` the layer's flat row views of k, v and the scales with their
    spare block's rows (:func:`pool_rows`), which the step's K/V rows are
    scattered into."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    pos: torch.Tensor
    tables: torch.Tensor
    rows: Dict[str, torch.Tensor]
    at: torch.Tensor


def _with_spare(shape, fill, dtype, dev, block_dim: int) -> torch.Tensor:
    """A pool tensor of ``shape`` (blocks at ``block_dim``) over storage
    that holds one spare block past the last one of each layer; the spare
    block's first row takes the writes the reference drops (see
    :func:`pool_rows`)."""
    backing = list(shape)
    backing[block_dim] += 1
    t = torch.full(backing, fill, dtype=dtype, device=dev)
    return t.narrow(block_dim, 0, shape[block_dim])


def _routing(num_blocks, block_size, table_rows, max_blocks_per_seq, dev):
    """The stored positions and the routing tensors, sized by the table's
    rows (the serving engine's slots plus its speculation lanes)."""
    return dict(
        pos=_with_spare((num_blocks, block_size), PAD_POSITION, torch.int32,
                        dev, 0),
        block_tables=torch.full((table_rows, max_blocks_per_seq), -1,
                                dtype=torch.int32, device=dev),
        lengths=torch.zeros((table_rows,), dtype=torch.int32, device=dev),
        block_size=block_size)


def init_paged_kv_cache(num_layers: int, num_blocks: int, block_size: int,
                        num_kv_heads: int, head_dim: int, max_slots: int,
                        max_blocks_per_seq: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device: DeviceLike = None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return PagedKVCache(
        k=_with_spare(shape, 0, dtype, dev, 1),
        v=_with_spare(shape, 0, dtype, dev, 1),
        **_routing(num_blocks, block_size, max_slots, max_blocks_per_seq,
                   dev))


def pool_accounting(num_layers: int, num_blocks: int, block_size: int,
                    num_kv_heads: int, head_dim: int, *,
                    kv_bytes: int = 2, quantized: bool = False,
                    tp_size: int = 1, cp_size: int = 1) -> float:
    """Bytes per device of the K+V pool tensors the two init functions
    allocate (K and V ``[L, num_blocks, block_size, KV, D]``; the int8
    variant stores one byte a value plus one fp32 scale a pool vector).
    The KV-head dimension shards over ``tp_size`` and the block dimension
    over ``cp_size``, as the reference's planner charges them."""
    if cp_size < 1:
        raise ValueError(f"cp_size must be >= 1, got {cp_size}")
    elems = num_layers * num_blocks * block_size * num_kv_heads * head_dim
    if quantized:
        per_pool = elems * 1 + (elems // max(1, head_dim)) * 4
    else:
        per_pool = elems * kv_bytes
    return 2.0 * per_pool / max(1, tp_size) / cp_size


def init_quantized_paged_kv_cache(num_layers: int, num_blocks: int,
                                  block_size: int, num_kv_heads: int,
                                  head_dim: int, max_slots: int,
                                  max_blocks_per_seq: int,
                                  device: DeviceLike = None
                                  ) -> QuantizedPagedKVCache:
    dev = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return QuantizedPagedKVCache(
        k=_with_spare(shape, 0, torch.int8, dev, 1),
        v=_with_spare(shape, 0, torch.int8, dev, 1),
        k_scale=_with_spare(shape[:-1], 1, torch.float32, dev, 1),
        v_scale=_with_spare(shape[:-1], 1, torch.float32, dev, 1),
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
# scatters use mode="drop"). The pools of the init functions hold one spare
# block past each layer's last, so such a row lands in one of its rows:
# every write is one fixed-shape scatter with no host sync, and nothing
# reads the spare block.
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


def spread_dropped_rows(flat_idx: torch.Tensor, capacity: int,
                        block_size: int) -> torch.Tensor:
    """``flat_idx`` from :func:`flat_write_indices` with dropped row ``i``
    (index == ``capacity``) sent to spare row ``capacity + i %
    block_size``: the spare block's rows share a step's pad rows, so that
    no one row takes hundreds of writes (on an H100 that contention cost
    0.24 ms a decode step at Llama-3-8B's 504 pad rows, PERF.md)."""
    spare = torch.remainder(torch.arange(flat_idx.shape[0],
                                         device=flat_idx.device,
                                         dtype=flat_idx.dtype), block_size)
    return torch.where(flat_idx == capacity, flat_idx + spare, flat_idx)


def pool_rows(pool: torch.Tensor, layered: bool = True) -> torch.Tensor:
    """The flat row view of a pool tensor made by the init functions, with
    the spare block's rows after each layer's last: ``[L, (NB + 1)*BS,
    ...]`` for a ``layered`` ``[L, NB, BS, ...]`` tensor (k, v and the
    scales), ``[(NB + 1)*BS]`` for ``pos [NB, BS]``. Raises for a tensor
    whose storage holds no spare block past its blocks."""
    lead = 1 if layered else 0
    nb, bs = pool.shape[lead:lead + 2]
    rest = tuple(pool.shape[lead + 2:])
    rest_strides = tuple(pool.stride()[lead + 2:])
    row = pool.stride(lead + 1)
    dense = torch.empty(rest, device="meta").stride() if rest else ()
    ok = (rest_strides == tuple(dense)
          and row == max(1, int(np.prod(rest, dtype=np.int64)))
          and pool.stride(lead) == bs * row)
    last = pool.storage_offset() + (nb + 1) * bs * row
    if layered:
        ok = ok and pool.stride(0) == (nb + 1) * bs * row
        last += (pool.shape[0] - 1) * pool.stride(0)
    if not ok or last > (pool.untyped_storage().nbytes()
                         // pool.element_size()):
        raise ValueError(
            "pool tensor has no spare block past its blocks: make paged pools "
            "with init_paged_kv_cache / init_quantized_paged_kv_cache")
    size = ((pool.shape[0],) if layered else ()) + ((nb + 1) * bs,) + rest
    stride = ((pool.stride(0),) if layered else ()) + (row,) + rest_strides
    return pool.as_strided(size, stride, pool.storage_offset())


def scatter_pool_rows(flat_rows: torch.Tensor, rows: torch.Tensor,
                      flat_idx: torch.Tensor) -> torch.Tensor:
    """In place: ``flat_rows [capacity + block_size, ...]`` (a pool's rows
    and the spare block's after them, :func:`pool_rows`) takes ``rows[i]``
    at ``flat_idx[i]``. Indices from ``capacity`` on are spare rows
    (:func:`spread_dropped_rows`), which nothing reads, so which of the
    rows sent to one of them it keeps does not matter (the reference drops
    them)."""
    flat_rows.index_copy_(0, flat_idx.long(), rows.to(flat_rows.dtype))
    return flat_rows


def write_pool_rows(pool: torch.Tensor, rows: torch.Tensor,
                    flat_idx: torch.Tensor) -> torch.Tensor:
    """Scatter ``rows [T, ...]`` into any ``pool [num_blocks, block_size,
    ...]`` in place at the flat indices from :func:`flat_write_indices`,
    dropping rows whose index is the capacity sentinel. The kept rows are
    picked with a mask, a host sync on CUDA: the serving path scatters into
    its pools' spare rows instead (:func:`pool_rows`,
    :func:`scatter_pool_rows`)."""
    nb, bs = pool.shape[:2]
    keep = flat_idx < nb * bs
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    flat.index_copy_(0, flat_idx[keep].long(), rows[keep].to(pool.dtype))
    return pool


def write_pool_positions(pos: torch.Tensor, positions: torch.Tensor,
                         flat_idx: torch.Tensor) -> torch.Tensor:
    """Record this step's true token positions in the ``[num_blocks,
    block_size]`` slot-position table in place (shared by all layers,
    written once per step)."""
    return write_pool_rows(pos, positions, flat_idx)


def mask_pool_positions(pos: torch.Tensor, flat_idx: torch.Tensor,
                        reject: torch.Tensor) -> torch.Tensor:
    """In place: set the stored position of every ``flat_idx[i]`` with
    ``reject[i]`` to PAD_POSITION, so that those K/V rows never pass the
    causal mask again (the speculation rollback). Indices outside the pool
    (pad rows carry ``capacity``) drop.

    One fixed-shape scatter with no host sync: an ``amax`` scatter of
    PAD_POSITION at the rejected rows and of -1 (below every stored
    position) elsewhere, which leaves those rows as they were."""
    nb, bs = pos.shape
    flat_idx = flat_idx.long()
    hit = reject & (flat_idx >= 0) & (flat_idx < nb * bs)
    vals = torch.where(hit, torch.full_like(flat_idx, PAD_POSITION),
                       torch.full_like(flat_idx, -1)).to(pos.dtype)
    pos.view(-1).scatter_reduce_(0, torch.where(hit, flat_idx, 0), vals,
                                 "amax")
    return pos


# ---------------------------------------------------------------------------
# Prefix sharing: a host-side trie over full prompt blocks. KV for a token
# depends only on (token, position, params), so two prompts with a common
# prefix produce the same pool rows for it; the trie lets later requests
# map those rows instead of prefilling them again.
# ---------------------------------------------------------------------------

class _PrefixNode:
    """One cached full block: ``tokens`` (``block_size`` of them, starting
    at position ``depth * block_size``), the pool block holding its KV, and
    the chain hash addressing it (a hash of the whole token path from the
    root, so equal block content at different depths is a different
    node)."""

    __slots__ = ("chain", "parent", "tokens", "block", "tick")

    def __init__(self, chain: int, parent: Optional[int],
                 tokens: Tuple[int, ...], block: int, tick: int):
        self.chain = chain
        self.parent = parent
        self.tokens = tokens
        self.block = block
        self.tick = tick


class PrefixCache:
    """Trie of full prompt blocks -> pool block ids.

    The cache holds one allocator reference per inserted block, so a
    cached block outlives the request that wrote it; a later request's
    :meth:`match` maps the longest cached prefix into its own table (the
    caller takes its own refs). Cached blocks are never written: a request
    that diverges mid-block copies first (:func:`cow_copy_blocks`). Under
    pool pressure :meth:`evict` drops least-recently-matched leaf nodes
    until enough blocks return to the free list. Chain hashes are Python
    ``hash`` values, so they hold for one process only."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._nodes: Dict[int, _PrefixNode] = {}
        self._children: Dict[Optional[int], Set[int]] = {None: set()}
        self._tick = 0

    @property
    def size(self) -> int:
        return len(self._nodes)

    @staticmethod
    def _hash(parent: Optional[int], tokens: Tuple[int, ...]) -> int:
        return hash((parent, tokens))

    def _touch(self, node: _PrefixNode) -> None:
        self._tick += 1
        node.tick = self._tick

    def _walk(self, prompt: Sequence[int], max_tokens: int, touch: bool):
        """Follow full blocks of ``prompt`` down from the root while they
        are cached and fit in ``max_tokens``: ``(blocks, matched,
        chain)``."""
        bs = self.block_size
        full: List[int] = []
        chain: Optional[int] = None
        matched = 0
        while matched + bs <= max_tokens:
            tokens = tuple(prompt[matched:matched + bs])
            child = self._hash(chain, tokens)
            node = self._nodes.get(child)
            if node is None or node.tokens != tokens:
                break
            if touch:
                self._touch(node)
            full.append(node.block)
            chain = child
            matched += bs
        return full, matched, chain

    def _best_tail(self, chain: Optional[int], tail: Tuple[int, ...]):
        """The child of ``chain`` whose tokens share the longest head with
        ``tail`` (the first such on a tie): ``(m, node)``, ``(0, None)``
        when none shares a token."""
        best, best_node = 0, None
        if tail:
            for child in self._children.get(chain, ()):
                node = self._nodes[child]
                m = 0
                for a, b in zip(node.tokens, tail):
                    if a != b:
                        break
                    m += 1
                if m > best:
                    best, best_node = m, node
        return best, best_node

    def match(self, prompt: Sequence[int], max_tokens: int
              ) -> Tuple[List[int], int, Optional[Tuple[int, int]],
                         Optional[int]]:
        """Longest cached prefix of ``prompt``, capped at ``max_tokens``.

        Returns ``(full_blocks, matched, partial, chain)``: pool ids of the
        fully matched blocks, the token count they cover, an optional
        ``(block, m)`` partial-tail match (a cached block whose first ``m <
        block_size`` tokens extend the prefix: the case that later forces a
        copy-on-write, since the mapper writes its own rows mid-block), and
        the chain hash of the last full node (``None`` at the root) for
        continued insertion. Touches every node it returns."""
        full, matched, chain = self._walk(prompt, max_tokens, touch=True)
        best, node = self._best_tail(chain,
                                     tuple(prompt[matched:max_tokens]))
        partial = None
        if node is not None:
            self._touch(node)
            partial = (node.block, best)
        return full, matched, partial, chain

    def lookup(self, prompt: Sequence[int], max_tokens: int) -> int:
        """How many tokens of ``prompt`` the cache covers now (full blocks
        and a partial tail), without touching recency."""
        _, matched, chain = self._walk(prompt, max_tokens, touch=False)
        best, _ = self._best_tail(chain, tuple(prompt[matched:max_tokens]))
        return matched + best

    def insert(self, parent: Optional[int], tokens: Sequence[int],
               block: int) -> Tuple[Optional[int], bool]:
        """Register ``block`` as holding the full block ``tokens`` under
        ``parent`` (a chain hash from :meth:`match` or an earlier insert).

        Returns ``(chain, inserted)``. An existing node with the same
        tokens just advances the chain (``inserted`` False; the caller
        keeps its own block). ``(None, False)`` means the chain is unusable
        (a hash collision, or the parent was evicted) and the caller stops
        inserting for this request."""
        tokens = tuple(tokens)
        if len(tokens) != self.block_size:
            raise ValueError(
                f"prefix nodes cache full blocks only: got {len(tokens)} "
                f"tokens for block_size {self.block_size}")
        if parent is not None and parent not in self._nodes:
            return None, False
        chain = self._hash(parent, tokens)
        node = self._nodes.get(chain)
        if node is not None:
            if node.tokens != tokens:     # hash collision: leave the trie
                return None, False        # alone, stop this chain
            self._touch(node)
            return chain, False
        self.allocator.ref(block)
        node = _PrefixNode(chain, parent, tokens, block, 0)
        self._touch(node)
        self._nodes[chain] = node
        self._children.setdefault(parent, set()).add(chain)
        self._children.setdefault(chain, set())
        return chain, True

    def snapshot(self, max_nodes: Optional[int] = None
                 ) -> List[Dict[str, Any]]:
        """Portable dump of (up to ``max_nodes``) trie nodes for another
        replica, hottest subtrees first.

        Chain hashes are per process, so an entry names its parent by index
        into this list: ``{"parent": index | None, "tokens": tuple,
        "block": local block id}``, parents before their children (the
        importer replays the list in order through :meth:`insert`). When
        truncating, whole root-to-leaf paths survive, ranked by the
        subtree's most recent match."""
        # a node's heat is the newest tick anywhere below it, so that a hot
        # leaf keeps its whole ancestor path ahead of cold siblings
        hot: Dict[int, int] = {}

        def heat(chain: int) -> int:
            got = hot.get(chain)
            if got is None:
                node = self._nodes[chain]
                got = max([node.tick] + [heat(c) for c in
                                         self._children.get(chain, ())])
                hot[chain] = got
            return got

        out: List[Dict[str, Any]] = []
        index: Dict[int, int] = {}

        def walk(parent: Optional[int]) -> None:
            kids = sorted(self._children.get(parent, ()),
                          key=heat, reverse=True)
            for chain in kids:
                if max_nodes is not None and len(out) >= max_nodes:
                    return
                node = self._nodes[chain]
                index[chain] = len(out)
                out.append({"parent": index.get(parent),
                            "tokens": node.tokens, "block": node.block})
                walk(chain)

        walk(None)
        return out

    def chain_of(self, parent: Optional[int],
                 tokens: Sequence[int]) -> Optional[int]:
        """Chain hash of the live node for ``tokens`` under ``parent``, or
        None (resolves local chains without inserting)."""
        chain = self._hash(parent, tuple(tokens))
        node = self._nodes.get(chain)
        if node is None or node.tokens != tuple(tokens):
            return None
        return chain

    def evict(self, want_free: int) -> List[int]:
        """Drop least-recently-matched *leaf* nodes until ``want_free``
        blocks have returned to the pool (a dropped node whose block other
        slots still map frees nothing, so it keeps going). Returns the
        blocks that did free, for the engine's stale-position wipe."""
        freed: List[int] = []
        while len(freed) < want_free:
            leaves = [n for n in self._nodes.values()
                      if not self._children.get(n.chain)]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.tick)
            freed.extend(self._remove(victim))
        return freed

    def clear(self) -> List[int]:
        """Drop every node; returns the blocks that returned to the free
        list."""
        freed: List[int] = []
        for node in list(self._nodes.values()):
            if node.chain in self._nodes:
                freed.extend(self._remove(node))
        return freed

    def _remove(self, node: _PrefixNode) -> List[int]:
        del self._nodes[node.chain]
        self._children.pop(node.chain, None)
        self._children.get(node.parent, set()).discard(node.chain)
        return self.allocator.free([node.block])


def cow_copy_blocks(cache: PagedKVCache, src, dst, keep_upto
                    ) -> PagedKVCache:
    """In place: clone pool blocks ``src[i] -> dst[i]`` (k, v, and the
    scales of an int8 pool, every layer) before a writer lands in a shared
    block. Rows whose stored position is ``>= keep_upto[i]`` (the writer's
    first divergent position) become PAD_POSITION in the clone: the writer
    owns them from here on.

    Every entry is live. The JAX version pads its batch with ``dst ==
    num_blocks`` entries that its scatter drops; indexing here does not
    drop (it raises on the CPU and is undefined on CUDA), so the caller,
    which knows how many entries are live, passes only those. All rows are
    read before any is written, as in the functional version."""
    dev = cache.pos.device
    src, dst, keep = (torch.as_tensor(a, dtype=torch.long).to(dev)
                      for a in (src, dst, keep_upto))
    for pool in _pool_tensors(cache).values():
        pool[:, dst] = pool[:, src]
    rows = cache.pos[src]
    cache.pos[dst] = rows.masked_fill(rows >= keep[:, None], PAD_POSITION)
    return cache


# ---------------------------------------------------------------------------
# Block transport: lift a block set out of one engine's pool and land it in
# another's (session migration, prefix-trie shipping). Host code at step
# boundaries; the payload is host numpy (bf16 as its raw words,
# :class:`..utils.bfloat16.BF16Words`), so it can cross a process.
# ---------------------------------------------------------------------------

#: block axis of each :func:`extract_blocks` payload tensor: ``k``/``v``
#: and their scales are pool-shaped ``[layers, blocks, ...]``, ``pos`` is
#: ``[blocks, block_size]`` (the per-block integrity fingerprints read it)
PAYLOAD_BLOCK_AXES = {"k": 1, "v": 1, "pos": 0, "k_scale": 1, "v_scale": 1}


def extract_blocks(cache: PagedKVCache, blocks: Sequence[int],
                   keep_upto: int) -> Dict[str, np.ndarray]:
    """Lift ``blocks`` out of the pool as host arrays, ordered like
    ``blocks``. Rows with stored position ``>= keep_upto`` are PAD_POSITION
    in the extracted ``pos`` (a migrating session carries only its own
    ``n_cached`` tokens, never a donor's stale rows); ``keep_upto=
    PAD_POSITION`` keeps every real row (prefix shipments)."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long,
                          device=cache.pos.device)
    pos = cache.pos[idx]
    pos = torch.where(pos < keep_upto, pos, torch.full_like(pos,
                                                            PAD_POSITION))
    pools = _pool_tensors(cache)
    # the reference's key order (k, v, pos, scales): the per-block
    # fingerprints and a ticket's header list them in it
    payload = {"k": pools.pop("k")[:, idx], "v": pools.pop("v")[:, idx],
               "pos": pos}
    payload.update((name, t[:, idx]) for name, t in pools.items())
    return {name: to_host(t) for name, t in payload.items()}


def inject_blocks(cache: PagedKVCache, blocks: Sequence[int],
                  payload: Dict[str, Any]) -> PagedKVCache:
    """In place: land an :func:`extract_blocks` payload at ``blocks`` (the
    same order; freshly allocated by the destination). Every row of the
    target blocks — K, V, scales and positions — is overwritten, so they
    need no freed-position wipe."""
    if len(blocks) != payload["pos"].shape[0]:
        raise ValueError(
            f"payload carries {payload['pos'].shape[0]} block(s) but "
            f"{len(blocks)} destination ids were given")
    dev = cache.pos.device
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=dev)
    for name, pool in _pool_tensors(cache).items():
        pool[:, idx] = to_torch(payload[name]).to(device=dev,
                                                  dtype=pool.dtype)
    cache.pos[idx] = to_torch(payload["pos"]).to(device=dev,
                                                 dtype=torch.int32)
    return cache
