"""Continuous-batching serving engine over the paged KV pool (counterpart
of the packed mode of ``neuronx_distributed_tpu/inference/engine.py``).

Each step the host scheduler packs, into a single ``[1, token_budget]``
token batch,

* one decode token for every slot that is actively generating, and
* chunked prefill rows for newly admitted requests (a prompt may take
  several steps, ``token_budget`` tokens at a time),

then runs the model family's paged forward on the pool
(:func:`..models.llama.llama_forward_with_cache`, or
:func:`..models.mixtral.mixtral_forward_with_cache` for a
``MixtralConfig``) and samples one token per row. Every tensor the step
sees — tokens, positions, slot ids, block tables, the pool — has a fixed
shape, so the step's shapes never change with load
(:meth:`ServingEngine.compile_count` counts the distinct shape signatures
and stays 1).

With ``EngineConfig(disaggregated=True)`` prefill and decode run as two
workers of their own fixed widths (prefill ``prefill_budget or
token_budget``, decode ``max_slots``), prefill first, each step; the KV
handoff between them is the shared pool itself. A narrow decode worker is
what sends a Mixtral step to the decode grouped GLU (K6).

Block allocation is lazy and host-side: a slot gets pool blocks as its
positions first touch them. When the pool runs dry the youngest running
request is preempted (blocks freed, restarted from its prompt later);
admission control rejects requests that could never fit. Finished slots
(EOS / max tokens) free their blocks at the same step boundary, so new
requests are admitted mid-flight.

With ``EngineConfig(prefix_sharing=True)`` full prompt blocks are
published to a trie (:class:`.paging.PrefixCache`); a later request maps
the longest cached prefix of its prompt (refcounted) instead of prefilling
it, and a write into a block that other owners map clones it first
(copy-on-write, :func:`.paging.cow_copy_blocks`, run at the next step
boundary). Under pool pressure the trie's least-recently-matched leaves are
evicted before a request is preempted.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import llama, mixtral
from ..models.llama import LlamaConfig
from ..quantization.serving import quantize_params_for_serving
from .kv_cache import PAD_POSITION
from .paging import (BlockAllocator, CacheExhaustedError, PrefixCache,
                     cow_copy_blocks, init_paged_kv_cache,
                     init_quantized_paged_kv_cache)
from .sampling import SamplingConfig, sample


def _clear_freed_positions(pos: torch.Tensor,
                           freed_mask: torch.Tensor) -> torch.Tensor:
    """Reset freed blocks' stored positions to the pad sentinel, in place.

    A freed block keeps its old per-entry positions; if it is later
    remapped at a *different* block index of another sequence, those
    stale small positions pass the ``q_pos >= stored_pos`` causal mask and
    leak the previous owner's K/V into attention."""
    return pos.masked_fill_(freed_mask[:, None], PAD_POSITION)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-side knobs (the model config stays in ``LlamaConfig``).

    ``token_budget`` is the packed step width: decode rows (one per
    running slot) plus prefill chunk rows, padded up to this fixed size.
    ``max_slots`` bounds concurrent requests; the pool is ``num_blocks *
    block_size`` KV slots shared by all of them. ``disaggregated`` runs
    prefill and decode as two workers, decode ``max_slots`` wide and prefill
    ``prefill_budget`` (default ``token_budget``) wide. ``prefix_sharing``
    maps cached prompt prefixes instead of prefilling them; it is off by
    default because the trie keeps blocks allocated past a request's
    retirement (:meth:`ServingEngine.release_prefix_cache` drops them).
    ``weight_quant`` serves every projection kernel quantized (``"int8"``,
    ``"fp8"``, ``"mxfp4"``, ``"mxfp8"``): the engine stamps the format onto
    the model config and converts a float state dict at construction
    (:func:`..quantization.serving.quantize_params_for_serving`, where the
    tensors lie); a quantized one passes through. It is independent of
    ``quantized`` (the pool's int8 blocks)."""

    block_size: int = 16
    num_blocks: int = 64
    max_slots: int = 8
    max_blocks_per_seq: int = 16
    token_budget: int = 32
    quantized: bool = False
    kv_dtype: Optional[torch.dtype] = None   # None -> model dtype
    weight_quant: Optional[str] = None
    eos_id: Optional[int] = None
    sampling: SamplingConfig = SamplingConfig(greedy=True)
    prefix_sharing: bool = False
    disaggregated: bool = False
    prefill_budget: Optional[int] = None


class RequestRejected(RuntimeError):
    """Typed admission rejection raised at ``submit`` time. ``reason`` is
    machine-readable; ``never_fits``: the request could not fit the pool /
    block table / model context even running alone."""

    REASONS = ("never_fits",)

    def __init__(self, reason: str, detail: str = ""):
        if reason not in self.REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}")
        super().__init__(f"request rejected ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


@dataclasses.dataclass
class _RequestState:
    uid: str
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    n_cached: int = 0               # tokens whose K/V are in the pool
    first_token_time: Optional[float] = None
    admit_seq: int = -1             # admission order, for preemption choice
    shared_tokens: int = 0          # prompt tokens mapped from the trie
    chain: Optional[int] = None     # trie chain hash for continued insert
    trie_blocks: int = 0            # prompt blocks walked/inserted so far
    trie_dead: bool = False         # stop inserting (collision/eviction)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def tokens(self) -> List[int]:
        return self.prompt + self.generated

    @property
    def decoding(self) -> bool:
        # prefill done and one sampled token waits to be fed back
        return self.n_cached >= self.prompt_len

    def restart(self) -> None:
        self.generated = []
        self.slot = None
        self.n_cached = 0
        self.first_token_time = None
        self.shared_tokens = 0
        self.chain = None
        self.trie_blocks = 0
        self.trie_dead = False


@dataclasses.dataclass
class RequestResult:
    uid: str
    prompt_len: int
    tokens: List[int]
    status: str                     # "completed" | "rejected"
    ttft_s: Optional[float] = None
    finish_s: Optional[float] = None
    tpot_s: Optional[float] = None  # mean time per token after the first


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    completed: int = 0
    rejected: int = 0
    preempted: int = 0
    tokens_generated: int = 0
    cow_copies: int = 0             # shared blocks cloned before a write
    prefix_hit_tokens: int = 0      # prompt tokens mapped from the trie
    prefill_tokens: int = 0         # prompt tokens actually computed
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    step_latency_s: List[float] = dataclasses.field(default_factory=list)
    occupancy: List[float] = dataclasses.field(default_factory=list)
    first_step_t: Optional[float] = None
    last_step_t: Optional[float] = None

    def report(self) -> Dict[str, float]:
        span = ((self.last_step_t - self.first_step_t)
                if self.steps and self.last_step_t > self.first_step_t
                else 0.0)
        lat = np.asarray(self.step_latency_s or [0.0])
        ttft = np.asarray(self.ttft_s or [0.0])
        return {
            "steps": self.steps,
            "completed": self.completed,
            "rejected": self.rejected,
            "preempted": self.preempted,
            "tokens_generated": self.tokens_generated,
            "prefill_tokens": self.prefill_tokens,
            "tokens_per_s": (self.tokens_generated / span) if span else 0.0,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
            "step_latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "step_latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "pool_occupancy_mean": (float(np.mean(self.occupancy))
                                    if self.occupancy else 0.0),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (
                self.prefix_hit_tokens
                / max(1, self.prefix_hit_tokens + self.prefill_tokens)),
            "cow_copies": self.cow_copies,
        }


class ServingEngine:
    """Request queue + slot map + token-budget scheduler over one
    fixed-shape step.

    ``params`` is the model's state dict (:func:`..models.llama.
    init_state_dict`, :func:`..models.mixtral.init_state_dict`,
    :func:`..models.convert.params_from_jax`); its tensors become the
    model's weights on ``device`` in the model dtype. The model family
    follows the config's type: a ``MixtralConfig`` serves Mixtral.
    ``device=None`` means CUDA and raises when there is none. ``generator``
    drives non-greedy sampling; ``clock`` returns seconds (default
    ``time.monotonic``)."""

    def __init__(self, model_cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                 engine_cfg: EngineConfig = EngineConfig(),
                 generator: Optional[torch.Generator] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        wq = engine_cfg.weight_quant
        if wq is not None:
            if wq not in llama.WEIGHT_QUANT_FORMATS:
                raise ValueError(
                    f"EngineConfig.weight_quant must be one of "
                    f"{llama.WEIGHT_QUANT_FORMATS} or None, got {wq!r}")
            if model_cfg.weight_quant != wq:
                model_cfg = dataclasses.replace(model_cfg, weight_quant=wq)
            params = quantize_params_for_serving(model_cfg, params)
        self.model_cfg = model_cfg
        self.ecfg = engine_cfg
        family = (mixtral if isinstance(model_cfg, mixtral.MixtralConfig)
                  else llama)
        self.model = family.build_model(model_cfg, params, self.device)
        self._forward = (mixtral.mixtral_forward_with_cache
                         if family is mixtral
                         else llama.llama_forward_with_cache)
        self.allocator = BlockAllocator(engine_cfg.num_blocks)
        self.stats = EngineStats()
        self.results: Dict[str, RequestResult] = {}
        self._queue: Deque[_RequestState] = deque()
        self._slots: List[Optional[_RequestState]] = (
            [None] * engine_cfg.max_slots)
        self._tables = np.full(
            (engine_cfg.max_slots, engine_cfg.max_blocks_per_seq), -1,
            np.int32)
        self._slot_blocks: List[List[int]] = (
            [[] for _ in range(engine_cfg.max_slots)])
        self._generator = generator
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._admit_counter = 0
        self._uid_counter = 0
        self._freed_dirty: set = set()  # freed blocks with stale positions
        self._pending_cow: List[Tuple[int, int, int]] = []  # (src, dst, keep)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, engine_cfg.block_size)
            if engine_cfg.prefix_sharing else None)
        # per worker: the distinct step input shapes seen, and the runs
        workers = (("prefill", "decode") if engine_cfg.disaggregated
                   else ("packed",))
        self._signatures: Dict[str, set] = {w: set() for w in workers}
        self.worker_runs: Dict[str, int] = {w: 0 for w in workers}
        self.cache = self._init_cache()

    # -- construction -----------------------------------------------------

    def _init_cache(self):
        e, m = self.ecfg, self.model_cfg
        if e.quantized:
            return init_quantized_paged_kv_cache(
                m.num_layers, e.num_blocks, e.block_size, m.num_kv_heads,
                m.head_dim_, e.max_slots, e.max_blocks_per_seq,
                device=self.device)
        return init_paged_kv_cache(
            m.num_layers, e.num_blocks, e.block_size, m.num_kv_heads,
            m.head_dim_, e.max_slots, e.max_blocks_per_seq,
            dtype=e.kv_dtype or m.dtype, device=self.device)

    def worker_compile_counts(self) -> Dict[str, int]:
        """Distinct input-shape signatures per worker: ``{"packed": n}``
        or, disaggregated, ``{"prefill": n, "decode": n}``."""
        return {w: len(s) for w, s in self._signatures.items()}

    def compile_count(self) -> int:
        """Most distinct input-shape signatures any worker has seen (the
        fixed-shape invariant: stays 1 as the live-request mix varies)."""
        return max(self.worker_compile_counts().values())

    # -- public API -------------------------------------------------------

    def _now(self) -> float:
        return self._clock() - self._t0

    def max_model_len(self) -> int:
        """Longest request (prompt + new tokens) this engine can ever
        serve: the model's rope/context bound, the block-table width, and
        the pool."""
        e = self.ecfg
        return min(self.model_cfg.max_seq_len,
                   e.max_blocks_per_seq * e.block_size,
                   e.num_blocks * e.block_size)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether a request of this size could ever run on this engine
        (alone, with the whole pool to itself)."""
        total = int(prompt_len) + int(max_new_tokens)
        return prompt_len > 0 and total <= self.max_model_len()

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               uid: Optional[str] = None,
               arrival_time: Optional[float] = None) -> str:
        """Enqueue a request. Raises :class:`RequestRejected` with
        ``reason="never_fits"`` for over-capacity requests, after recording
        the rejection in ``results``/``stats``."""
        if uid is None:
            uid = f"req{self._uid_counter}"
            self._uid_counter += 1
        req = _RequestState(
            uid=uid, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            arrival_time=(self._now() if arrival_time is None
                          else float(arrival_time)))
        if not self.fits(req.prompt_len, req.max_new_tokens):
            self.stats.rejected += 1
            self.results[uid] = RequestResult(
                uid=uid, prompt_len=req.prompt_len, tokens=[],
                status="rejected")
            raise RequestRejected(
                "never_fits", f"{uid}: prompt_len={req.prompt_len} "
                f"max_new={req.max_new_tokens} cannot fit this engine")
        self._queue.append(req)
        return uid

    def prefix_lookup(self, prompt: Sequence[int]) -> int:
        """How many tokens of ``prompt`` the prefix cache holds now (0
        without ``prefix_sharing``), capped at ``len(prompt) - 1``: the
        last prompt row always runs so that the request gets logits."""
        if self.prefix_cache is None or len(prompt) <= 1:
            return 0
        return self.prefix_cache.lookup([int(t) for t in prompt],
                                        len(prompt) - 1)

    def release_prefix_cache(self) -> None:
        """Drop the trie's own block references (blocks that live slots
        still map stay allocated); blocks that free get their stored
        positions wiped at the next step."""
        if self.prefix_cache is not None:
            self._freed_dirty.update(self.prefix_cache.clear())

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def run(self) -> Dict[str, RequestResult]:
        """Drive :meth:`step` until queue and slots drain. With the real
        clock, waits out gaps before future ``arrival_time``s; an injected
        clock is fast-forwarded instead."""
        while self.has_work():
            if not any(s is not None for s in self._slots):
                pending = [r.arrival_time for r in self._queue]
                gap = min(pending) - self._now() if pending else 0.0
                if gap > 0:
                    if self._clock is not time.monotonic:
                        self._t0 -= gap  # fake clock: fast-forward
                    else:
                        time.sleep(min(gap, 0.05))
                        continue
            self.step()
        return self.results

    # -- scheduling -------------------------------------------------------

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        now = self._now()
        while free and self._queue and self._queue[0].arrival_time <= now:
            req = self._queue.popleft()
            slot = free.pop(0)
            req.slot = slot
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._slots[slot] = req
            self._apply_prefix(req)

    def _apply_prefix(self, req: _RequestState) -> None:
        """Map the longest cached prefix of the prompt into the slot's
        table (one allocator ref per mapped block, no prefill work), capped
        at ``prompt_len - 1`` so that at least one prompt row runs. A
        partial-tail match maps a donor block whose first ``m`` tokens are
        shared; the first divergent write into it copies it
        (:meth:`_ensure_block`)."""
        req.chain = None
        req.trie_blocks = 0
        req.trie_dead = False
        if self.prefix_cache is None or req.n_cached:
            return
        full, matched, partial, chain = self.prefix_cache.match(
            req.prompt, req.prompt_len - 1)
        for i, blk in enumerate(full):
            self.allocator.ref(blk)
            self._tables[req.slot, i] = blk
            self._slot_blocks[req.slot].append(blk)
        req.chain = chain
        req.trie_blocks = len(full)
        req.n_cached = matched
        if partial is not None:
            blk, m = partial
            self.allocator.ref(blk)
            self._tables[req.slot, len(full)] = blk
            self._slot_blocks[req.slot].append(blk)
            req.n_cached += m
        req.shared_tokens = req.n_cached
        self.stats.prefix_hit_tokens += req.n_cached

    def _alloc_blocks(self, n: int) -> List[int]:
        """Pool allocation that, before giving up, evicts the trie's
        least-recently-matched prefixes until enough blocks free (the
        caller's preemption handles the rest)."""
        try:
            return self.allocator.alloc(n)
        except CacheExhaustedError:
            if self.prefix_cache is None or self.prefix_cache.size == 0:
                raise
            self._freed_dirty.update(
                self.prefix_cache.evict(n - self.allocator.num_free))
            return self.allocator.alloc(n)

    def _ensure_block(self, req: _RequestState, position: int) -> None:
        """Map the block covering ``position`` into the slot's table,
        allocating from the pool (raises CacheExhaustedError when dry). A
        write into a block that other owners also map clones it first
        (copy-on-write): the clone replaces the shared block in this slot's
        table, and the copy runs at the next step boundary."""
        blk_i = position // self.ecfg.block_size
        cur = int(self._tables[req.slot, blk_i])
        if cur >= 0:
            if self.allocator.refcount(cur) <= 1:
                return
            dst = self._alloc_blocks(1)[0]
            self._pending_cow.append((cur, dst, position))
            # the copy overwrites dst's stale positions; the freed-position
            # wipe, which runs after the copy, must leave them
            self._freed_dirty.discard(dst)
            self._tables[req.slot, blk_i] = dst
            sb = self._slot_blocks[req.slot]
            sb[sb.index(cur)] = dst
            self._freed_dirty.update(self.allocator.free([cur]))
            self.stats.cow_copies += 1
            return
        blk = self._alloc_blocks(1)[0]
        self._tables[req.slot, blk_i] = blk
        self._slot_blocks[req.slot].append(blk)

    def _release(self, req: _RequestState) -> None:
        slot = req.slot
        # only blocks whose last reference dropped get their positions
        # wiped: clearing a still-shared block would blind its sharers
        self._freed_dirty.update(
            self.allocator.free(self._slot_blocks[slot]))
        self._slot_blocks[slot] = []
        self._tables[slot, :] = -1
        self._slots[slot] = None

    def _preempt_youngest(self, keep: _RequestState) -> None:
        """Evict the most recently admitted running request — possibly
        ``keep`` itself — back to the queue front; its generated tokens
        are discarded and it restarts from the prompt. Always taking the
        true youngest means the oldest running request is never evicted,
        so it advances and the schedule cannot livelock."""
        candidates = [s for s in self._slots if s is not None]
        if not candidates:
            raise CacheExhaustedError(
                "pool exhausted with no running request to preempt")
        victim = max(candidates, key=lambda r: r.admit_seq)
        self._release(victim)
        victim.restart()
        self._queue.appendleft(victim)
        self.stats.preempted += 1

    def _build_schedule(self):
        """Pack this step's rows: (req, token, position, produce) — one
        decode row per decoding slot, then prefill chunks. Preempts
        (youngest first) when a decode row can't get its next block;
        prefill chunks merely truncate. Packed mode shares one
        ``token_budget`` across both lists; disaggregated mode gives each
        worker its own width."""
        e = self.ecfg
        if e.disaggregated:
            decode_budget = e.max_slots
            prefill_budget = e.prefill_budget or e.token_budget
        else:
            decode_budget = prefill_budget = e.token_budget
        while True:
            try:
                decode_rows = []
                for req in sorted(
                        (s for s in self._slots
                         if s is not None and s.decoding),
                        key=lambda r: r.admit_seq):
                    if len(decode_rows) >= decode_budget:
                        break
                    pos = req.n_cached
                    self._ensure_block(req, pos)
                    decode_rows.append((req, req.tokens[pos], pos, True))
                break
            except CacheExhaustedError:
                self._preempt_youngest(req)
        prefill_rows = []
        used = 0 if e.disaggregated else len(decode_rows)
        for req in sorted((s for s in self._slots
                           if s is not None and not s.decoding),
                          key=lambda r: r.admit_seq):
            room = prefill_budget - used - len(prefill_rows)
            if room <= 0:
                break
            chunk = min(room, req.prompt_len - req.n_cached)
            for i in range(chunk):
                pos = req.n_cached + i
                try:
                    self._ensure_block(req, pos)
                except CacheExhaustedError:
                    chunk = i  # defer the rest of this prompt
                    break
                produce = (pos == req.prompt_len - 1)
                prefill_rows.append((req, req.prompt[pos], pos, produce))
            req.n_cached += chunk
            self.stats.prefill_tokens += chunk
        return decode_rows, prefill_rows

    def _apply_pending_cow(self) -> None:
        """Run the copy-on-write clones registered while scheduling, all in
        one call (the reference chunks them only to keep one compiled
        shape). Runs before the freed-position wipe: a source freed in the
        same pass still needs its positions for the clone."""
        if not self._pending_cow:
            return
        # a clone whose slot was preempted in the same pass may have had its
        # dst handed out again: the later clone owns it, and one scatter
        # with a repeated dst would leave either on CUDA
        live = {d: (s, k) for s, d, k in self._pending_cow}
        src, keep = zip(*live.values())
        cow_copy_blocks(self.cache, src, list(live), keep)
        self._pending_cow.clear()

    def _maybe_insert_prefix(self, req: _RequestState) -> None:
        """Publish this request's fully written prompt blocks into the
        trie (after the step, when their pool rows exist). Stops for good
        on a hash collision or an evicted parent chain."""
        if self.prefix_cache is None or req.trie_dead:
            return
        bs = self.ecfg.block_size
        target = min(req.n_cached, req.prompt_len) // bs
        while req.trie_blocks < target:
            i = req.trie_blocks
            chain, _ = self.prefix_cache.insert(
                req.chain, req.prompt[i * bs:(i + 1) * bs],
                int(self._tables[req.slot, i]))
            if chain is None:
                req.trie_dead = True
                return
            req.chain = chain
            req.trie_blocks += 1

    def _run_worker(self, worker: str, rows, width: int) -> np.ndarray:
        """Pack ``rows`` into a fixed ``width`` batch and run one step of
        ``worker``; returns per-row sampled tokens (aligned with
        ``rows``)."""
        tokens = np.zeros((1, width), np.int32)
        positions = np.full((1, width), PAD_POSITION, np.int32)
        slot_ids = np.full((width,), self.ecfg.max_slots, np.int32)
        for i, (req, tok, pos, _) in enumerate(rows):
            tokens[0, i] = tok
            positions[0, i] = pos
            slot_ids[i] = req.slot
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (tokens, positions, slot_ids)]
        self._signatures[worker].add(tuple(
            (tuple(a.shape), a.dtype) for a in
            args + [self.cache.block_tables, self.cache.pos]))
        self.worker_runs[worker] += 1
        logits, self.cache = self._forward(
            self.model, args[0], args[1], self.cache, slot_ids=args[2])
        return sample(logits[0], self._generator,
                      self.ecfg.sampling).cpu().numpy()

    def step(self) -> int:
        """One serving step. Returns the number of live rows packed (0 =
        nothing was runnable). Disaggregated, the prefill worker runs
        first, so its new KV lands before the decode worker reads."""
        self._admit()
        decode_rows, prefill_rows = self._build_schedule()
        rows = decode_rows + prefill_rows
        if not rows:
            return 0
        t_start = self._now()
        if self.stats.first_step_t is None:
            self.stats.first_step_t = t_start
        self._apply_pending_cow()
        if self._freed_dirty:
            mask = np.zeros((self.ecfg.num_blocks,), np.bool_)
            mask[list(self._freed_dirty)] = True
            self._freed_dirty.clear()
            _clear_freed_positions(self.cache.pos,
                                   torch.from_numpy(mask).to(self.device))
        lengths = np.zeros((self.ecfg.max_slots,), np.int32)
        for i, s in enumerate(self._slots):
            if s is not None:
                lengths[i] = s.n_cached
        self.cache.block_tables.copy_(torch.from_numpy(self._tables))
        self.cache.lengths.copy_(torch.from_numpy(lengths))
        e = self.ecfg
        if e.disaggregated:
            sampled = np.zeros((len(rows),), np.int32)
            if prefill_rows:
                sampled[len(decode_rows):] = self._run_worker(
                    "prefill", prefill_rows,
                    e.prefill_budget or e.token_budget)[:len(prefill_rows)]
            if decode_rows:
                sampled[:len(decode_rows)] = self._run_worker(
                    "decode", decode_rows, e.max_slots)[:len(decode_rows)]
        else:
            sampled = self._run_worker("packed", rows, e.token_budget)
        if self.prefix_cache is not None:
            for req in {id(r[0]): r[0] for r in prefill_rows}.values():
                self._maybe_insert_prefix(req)

        now = self._now()
        for i, (req, _, pos, produce) in enumerate(rows):
            if req.decoding and pos == req.n_cached:
                req.n_cached += 1  # this decode row cached its token
            if not produce:
                continue
            tok = int(sampled[i])
            req.generated.append(tok)
            self.stats.tokens_generated += 1
            if req.first_token_time is None:
                req.first_token_time = now
                self.stats.ttft_s.append(now - req.arrival_time)
            if (len(req.generated) >= req.max_new_tokens
                    or (self.ecfg.eos_id is not None
                        and tok == self.ecfg.eos_id)):
                self._retire(req, now)
        self.stats.steps += 1
        self.stats.step_latency_s.append(now - t_start)
        self.stats.last_step_t = now
        self.stats.occupancy.append(
            self.allocator.num_allocated / self.allocator.num_blocks)
        return len(rows)

    def _retire(self, req: _RequestState, now: float) -> None:
        self._release(req)
        self.stats.completed += 1
        ttft = (req.first_token_time - req.arrival_time
                if req.first_token_time is not None else None)
        n_gen = len(req.generated)
        tpot = ((now - req.first_token_time) / (n_gen - 1)
                if req.first_token_time is not None and n_gen > 1
                else None)
        self.results[req.uid] = RequestResult(
            uid=req.uid, prompt_len=req.prompt_len,
            tokens=list(req.generated), status="completed",
            ttft_s=ttft, finish_s=now, tpot_s=tpot)
