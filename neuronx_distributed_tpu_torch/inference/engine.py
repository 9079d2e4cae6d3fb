"""Continuous-batching serving engine over the paged KV pool (counterpart
of ``neuronx_distributed_tpu/inference/engine.py``).

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

With ``EngineConfig(speculation=SpeculationConfig(...))`` decoding slots
speculate: each round a draft worker proposes ``k`` tokens on each of ``B``
branches of each speculating slot, each branch writing into its own lane
(a block-table row past ``max_slots`` whose write window is a
copy-on-write clone of the slot's blocks), and one verify worker runs the
target over every lane's ``k + 1`` rows, accepts the deepest path that
matches the target's greedy choices, and rolls the rejected rows back by
their stored positions in both pools. The draft model has a pool of its
own with the target pool's block geometry, kept warm by the packed step,
which runs the draft over the same rows. Each worker keeps one fixed
shape, whatever the accept rate.

Sessions migrate between engines: :meth:`ServingEngine.export_session`
lifts a live request with its KV blocks into a :class:`SessionTicket`
(serialisable, fingerprinted per block with ``integrity``) and
:meth:`ServingEngine.import_session` lands it elsewhere all or nothing,
with no prefill; :meth:`ServingEngine.export_prefixes` ships the prefix
trie's hottest blocks to a fresh engine. :meth:`ServingEngine.drain` stops
admission and :meth:`ServingEngine.evict` hands a request back for
resubmission.

With ``aot_cache=`` (an :class:`.aot_cache.AotExecutableCache`) each
fixed-shape worker (the packed one, or prefill and decode) is a step
captured in a CUDA graph over the engine's input buffers and KV pool
(:class:`.aot_cache.AotWorker`), leased from the cache when an entry of the
same key is free (a revived replica, a scale-up after a scale-down) and
captured and published otherwise. The sampler runs outside the graph on
its logits; every host-to-device copy before a step goes from pinned
staging memory into a buffer that keeps its address, and the sampled ids
come back through one event, so a step makes no hidden host sync.
"""

from __future__ import annotations

import dataclasses
import json
import time
import weakref
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import llama, mixtral
from ..models.llama import LlamaConfig
from ..obs.accounting import CompileTracker
from ..obs.events import emit_event
from ..obs.metrics import HISTOGRAM_RESERVOIR, get_registry
from ..obs.tracing import get_tracer
from ..quantization.serving import quantize_params_for_serving
from ..resilience.integrity import (IntegrityError, fingerprint_array_np,
                                    kv_payload_fingerprints)
from ..utils.bfloat16 import dtype_name, from_buffer, to_torch
from .aot_cache import (AotExecutableCache, AotWorker, CapturedStep,
                        source_fingerprint)
from .kv_cache import PAD_POSITION
from .paging import (PAYLOAD_BLOCK_AXES, BlockAllocator, CacheExhaustedError,
                     PrefixCache, cow_copy_blocks, extract_blocks,
                     flat_write_indices, init_paged_kv_cache,
                     init_quantized_paged_kv_cache, inject_blocks,
                     mask_pool_positions)
from .sampling import SamplingConfig, sample
from .speculative import (SpeculationConfig, branch_of_nodes,
                          build_medusa_tree, medusa_accept_longest,
                          top_k_indices)


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
    tensors lie); a quantized one passes through, and with speculation a
    separate draft model is served in the same format. It is independent
    of ``quantized`` (the pool's int8 blocks).

    ``speculation`` turns on speculative decoding (greedy sampling only,
    not with ``disaggregated``). ``integrity``: :meth:`ServingEngine.
    export_session` fingerprints the shipped KV blocks per block and
    ``import_session`` checks them before touching the pool; with it on, a
    ticket that ships KV without fingerprints is refused."""

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
    speculation: Optional[SpeculationConfig] = None
    integrity: bool = True


class RequestRejected(RuntimeError):
    """Typed admission rejection. ``reason`` is machine-readable:

    * ``never_fits`` — the request could not fit the pool / block table /
      model context even running alone;
    * ``over_budget`` — a router's global token budget is exhausted;
    * ``draining`` — the engine is draining and admits nothing new;
    * ``tenant_throttled`` — a router's tenant bucket is empty.

    ``trace_id`` names the request's trace when tracing is on."""

    REASONS = ("never_fits", "over_budget", "draining", "tenant_throttled")

    def __init__(self, reason: str, detail: str = "",
                 trace_id: Optional[str] = None):
        if reason not in self.REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}")
        super().__init__(f"request rejected ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason
        self.trace_id = trace_id


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
    admit_time: Optional[float] = None  # when the request got its slot
    admit_seq: int = -1             # admission order, for preemption choice
    shared_tokens: int = 0          # prompt tokens mapped from the trie
    chain: Optional[int] = None     # trie chain hash for continued insert
    trie_blocks: int = 0            # prompt blocks walked/inserted so far
    trie_dead: bool = False         # stop inserting (collision/eviction)
    spec_rounds: int = 0            # speculation rounds this request ran
    spec_accepted: int = 0          # draft tokens accepted across rounds
    spec_ok: bool = True            # False: draft KV cold (imported KV)

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
        self.admit_time = None
        self.shared_tokens = 0
        self.chain = None
        self.trie_blocks = 0
        self.trie_dead = False
        self.spec_rounds = 0
        self.spec_accepted = 0
        # a restart prefills again, which warms the draft pool too
        self.spec_ok = True


#: SessionTicket wire format magic: ASCII magic, format version, newline
TICKET_MAGIC = b"NXDTKT1\n"


class TicketWireError(RuntimeError):
    """A serialized :class:`SessionTicket` failed to parse: wrong magic,
    version skew, truncation, or payload corruption."""


@dataclasses.dataclass
class SessionTicket:
    """A live request lifted off one engine to land on another
    (:meth:`ServingEngine.export_session` -> ``import_session``).

    It carries the scheduler state and the session's KV blocks as an
    :func:`.paging.extract_blocks` payload (``kv``/``n_blocks`` are
    ``None``/0 for a request that was still queued). ``age_s``/``ttft_s``
    are relative, so the destination rebuilds arrival and first-token
    times against its own clock. ``kv_fp`` (when the exporter runs with
    ``EngineConfig.integrity``) maps each payload tensor to its per-block
    fingerprints over the bytes extracted; ``trace`` is the exported
    request trace (None with tracing off).

    The wire format (:meth:`to_bytes`) is the reference's, byte for byte:
    the magic line, one JSON header line (scheduler state, ``kv_fp``,
    ``trace``, the arrays' name/dtype/shape/nbytes in payload order and a
    whole-payload fingerprint), then the arrays' raw bytes. A bf16 array is
    its raw 16-bit words under the dtype name ``bfloat16``."""

    uid: str
    prompt: List[int]
    generated: List[int]
    max_new_tokens: int
    n_cached: int
    age_s: float
    ttft_s: Optional[float]
    n_blocks: int = 0
    kv: Optional[Dict[str, Any]] = None
    kv_fp: Optional[Dict[str, List[int]]] = None
    trace: Optional[Dict[str, Any]] = None

    def to_bytes(self) -> bytes:
        """Serialize into the versioned ``NXDTKT1`` wire format."""
        manifest, chunks = [], []
        for name in sorted(self.kv or {}):
            arr = self.kv[name]
            raw = np.ascontiguousarray(arr)
            manifest.append({"name": name, "dtype": dtype_name(arr),
                             "shape": list(raw.shape),
                             "nbytes": int(raw.nbytes)})
            chunks.append(raw.tobytes())
        payload = b"".join(chunks)
        header = {
            "uid": self.uid, "prompt": list(self.prompt),
            "generated": list(self.generated),
            "max_new_tokens": int(self.max_new_tokens),
            "n_cached": int(self.n_cached), "age_s": float(self.age_s),
            "ttft_s": (None if self.ttft_s is None
                       else float(self.ttft_s)),
            "n_blocks": int(self.n_blocks), "kv_fp": self.kv_fp,
            "trace": self.trace, "arrays": manifest,
            "payload_fp": int(fingerprint_array_np(
                np.frombuffer(payload, np.uint8))[0]),
        }
        return (TICKET_MAGIC + json.dumps(header).encode("utf-8")
                + b"\n" + payload)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SessionTicket":
        """Parse :meth:`to_bytes` output; raises :class:`TicketWireError`
        on bad magic, version skew, truncation, or a payload that does not
        fingerprint to what the header promised."""
        if len(data) < len(TICKET_MAGIC) or data[:6] != TICKET_MAGIC[:6]:
            raise TicketWireError("not a session ticket (bad magic)")
        if data[:len(TICKET_MAGIC)] != TICKET_MAGIC:
            got = data[:len(TICKET_MAGIC)].rstrip(b"\n").decode(
                "ascii", "replace")
            raise TicketWireError(
                f"ticket version skew: got {got!r}, this reader speaks "
                f"{TICKET_MAGIC.rstrip().decode('ascii')!r} — refusing "
                "to guess at a foreign layout")
        nl = data.find(b"\n", len(TICKET_MAGIC))
        if nl < 0:
            raise TicketWireError("truncated ticket: no header line")
        try:
            header = json.loads(data[len(TICKET_MAGIC):nl])
        except ValueError as e:
            raise TicketWireError(f"corrupt ticket header: {e}") from e
        payload = data[nl + 1:]
        want = sum(a["nbytes"] for a in header.get("arrays", []))
        if len(payload) != want:
            raise TicketWireError(
                f"truncated ticket payload: header promises {want} "
                f"byte(s), {len(payload)} arrived")
        got_fp = int(fingerprint_array_np(
            np.frombuffer(payload, np.uint8))[0])
        if got_fp != int(header.get("payload_fp", got_fp)):
            raise TicketWireError(
                "ticket payload failed its integrity fingerprint — the "
                "bytes that arrived are not the bytes that were sent")
        kv: Optional[Dict[str, Any]] = None
        off = 0
        for a in header.get("arrays", []):
            kv = kv or {}
            kv[a["name"]] = from_buffer(payload[off:off + a["nbytes"]],
                                        a["dtype"], a["shape"])
            off += a["nbytes"]
        kv_fp = header.get("kv_fp")
        if kv_fp is not None:
            kv_fp = {k: [int(x) for x in v] for k, v in kv_fp.items()}
        return cls(
            uid=header["uid"], prompt=list(header["prompt"]),
            generated=list(header["generated"]),
            max_new_tokens=int(header["max_new_tokens"]),
            n_cached=int(header["n_cached"]),
            age_s=float(header["age_s"]),
            ttft_s=(None if header["ttft_s"] is None
                    else float(header["ttft_s"])),
            n_blocks=int(header["n_blocks"]), kv=kv, kv_fp=kv_fp,
            trace=header.get("trace"))


#: label set shared by the four per-request histograms
_REQUEST_LABELS = ("tenant", "replica", "outcome")


def observe_request_metrics(outcome: str, *, tenant: str = "-",
                            replica: str = "-",
                            ttft_s: Optional[float] = None,
                            tpot_s: Optional[float] = None,
                            queue_s: Optional[float] = None,
                            e2e_s: Optional[float] = None,
                            registry=None) -> None:
    """Record one retired request into the per-request histograms
    (``nxd_request_{ttft,tpot,queue,e2e}_seconds``), labelled by tenant,
    replica and outcome; once per request, at retirement."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return

    def _observe(name: str, help: str, value: Optional[float]) -> None:
        if value is None:
            return
        reg.histogram(name, help, labels=_REQUEST_LABELS).labels(
            tenant=tenant, replica=replica,
            outcome=outcome).observe(max(0.0, float(value)))

    _observe("nxd_request_ttft_seconds",
             "Per-request time to first token.", ttft_s)
    _observe("nxd_request_tpot_seconds",
             "Per-request mean time per output token after the first.",
             tpot_s)
    _observe("nxd_request_queue_seconds",
             "Per-request wait from arrival to slot admission.", queue_s)
    _observe("nxd_request_e2e_seconds",
             "Per-request end-to-end latency, arrival to retirement.",
             e2e_s)


@dataclasses.dataclass
class RequestResult:
    uid: str
    prompt_len: int
    tokens: List[int]
    status: str                     # "completed" | "rejected"
    ttft_s: Optional[float] = None
    finish_s: Optional[float] = None
    tpot_s: Optional[float] = None  # mean time per token after the first
    accept_rate: Optional[float] = None  # accepted/offered draft tokens
                                         # (None: never speculated)


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    completed: int = 0
    rejected: int = 0
    preempted: int = 0
    resubmitted: int = 0            # evicted for resubmission elsewhere
    queue_depth: int = 0            # gauge: live requests right now
    tokens_generated: int = 0
    cow_copies: int = 0             # shared blocks cloned before a write
    prefix_hit_tokens: int = 0      # prompt tokens mapped from the trie
    prefill_tokens: int = 0         # prompt tokens actually computed
    migrated_in: int = 0            # sessions landed via import_session
    migrated_out: int = 0           # sessions shipped via export_session
    migrated_tokens: int = 0        # cached tokens landed without prefill
    integrity_rejects: int = 0      # tickets refused: KV fingerprint bad
    spec_rounds: int = 0            # (slot, round) speculation attempts
    spec_accepted_tokens: int = 0   # draft tokens accepted by the target
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    step_latency_s: List[float] = dataclasses.field(default_factory=list)
    occupancy: List[float] = dataclasses.field(default_factory=list)
    shared_fraction: List[float] = dataclasses.field(default_factory=list)
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
            "shared_block_fraction": (float(np.mean(self.shared_fraction))
                                      if self.shared_fraction else 0.0),
            "cow_copies": self.cow_copies,
            "spec_rounds": self.spec_rounds,
            "spec_accept_mean": (self.spec_accepted_tokens
                                 / max(1, self.spec_rounds)),
        }

    def to_dict(self) -> Dict[str, float]:
        """:meth:`report` plus the counters a router folds into its own
        stats."""
        d = self.report()
        d["rejected"] = self.rejected
        d["resubmitted"] = self.resubmitted
        d["queue_depth"] = self.queue_depth
        d["migrated_in"] = self.migrated_in
        d["migrated_out"] = self.migrated_out
        d["migrated_tokens"] = self.migrated_tokens
        d["spec_accepted_tokens"] = self.spec_accepted_tokens
        return d


def _family(cfg: LlamaConfig):
    """The model module serving ``cfg`` and its cached forward."""
    if isinstance(cfg, mixtral.MixtralConfig):
        return mixtral, mixtral.mixtral_forward_with_cache
    return llama, llama.llama_forward_with_cache


class ServingEngine:
    """Request queue + slot map + token-budget scheduler over fixed-shape
    workers.

    ``params`` is the model's state dict (:func:`..models.llama.
    init_state_dict`, :func:`..models.mixtral.init_state_dict`,
    :func:`..models.convert.params_from_jax`); its tensors become the
    model's weights on ``device`` in the model dtype. The model family
    follows the config's type: a ``MixtralConfig`` serves Mixtral.
    ``device=None`` means CUDA and raises when there is none. ``generator``
    drives non-greedy sampling; ``clock`` returns seconds (default
    ``time.monotonic``); ``name`` scopes the engine's compile-tracker
    sites and its request traces. With ``EngineConfig.speculation``,
    ``draft_cfg``/``draft_params`` give the draft model (default: the
    target itself, a self-draft)."""

    def __init__(self, model_cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                 engine_cfg: EngineConfig = EngineConfig(),
                 generator: Optional[torch.Generator] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None, name: Optional[str] = None,
                 draft_cfg: Optional[LlamaConfig] = None,
                 draft_params: Optional[Dict[str, torch.Tensor]] = None,
                 aot_cache: Optional[AotExecutableCache] = None):
        if aot_cache is not None and engine_cfg.speculation is not None:
            raise NotImplementedError(
                "aot_cache with EngineConfig.speculation: the speculation "
                "workers run eagerly in the PyTorch port; pass aot_cache="
                "None to speculate, or drop speculation to serve captured "
                "workers")
        self.device = resolve_device(device)
        self.name = name
        self._aot = aot_cache
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
        family, self._forward = _family(model_cfg)
        self.model = family.build_model(model_cfg, params, self.device)
        self.allocator = BlockAllocator(engine_cfg.num_blocks)
        self.stats = EngineStats()
        self.results: Dict[str, RequestResult] = {}
        self._queue: Deque[_RequestState] = deque()
        self._slots: List[Optional[_RequestState]] = (
            [None] * engine_cfg.max_slots)
        # speculation: S speculating slots x B branches each get a lane, a
        # block-table row of their own past max_slots, so that draft and
        # verify rows write into per-branch clones while every other slot
        # is untouched
        spec = engine_cfg.speculation
        self._spec = spec
        self._spec_on = bool(spec.start_on) if spec else False
        self.draft_model = None
        if spec is not None:
            self._init_draft(spec, params, draft_cfg, draft_params)
        else:
            self._draft_cfg = None
            self._spec_slots = 0
            self._table_rows = engine_cfg.max_slots
        self._tables = np.full(
            (self._table_rows, engine_cfg.max_blocks_per_seq), -1,
            np.int32)
        self._slot_blocks: List[List[int]] = (
            [[] for _ in range(engine_cfg.max_slots)])
        self._generator = generator
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._admit_counter = 0
        self._uid_counter = 0
        self._draining = False
        self._freed_dirty: set = set()  # freed blocks with stale positions
        self._pending_cow: List[Tuple[int, int, int]] = []  # (src, dst, keep)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, engine_cfg.block_size)
            if engine_cfg.prefix_sharing else None)
        # per worker: the distinct step input shapes seen, and the runs
        workers = (("prefill", "decode") if engine_cfg.disaggregated
                   else ("packed",))
        if spec is not None:
            workers += ("spec_draft", "spec_verify")
        self._signatures: Dict[str, set] = {w: set() for w in workers}
        self.worker_runs: Dict[str, int] = {w: 0 for w in workers}
        self._aot_workers: Optional[Dict[str, AotWorker]] = None
        if aot_cache is None:
            self.cache = self._init_cache()
        else:
            self._build_aot_workers()
        self.dcache = self._init_draft_cache()
        self._spec_draft_fn = self._spec_verify_fn = None
        if spec is not None:
            self._spec_draft_fn = self._build_spec_draft()
            self._spec_verify_fn = self._build_spec_verify()
        # observability: one compile tracker per worker (a shape beyond a
        # worker's first alerts through the event channel), and spans in
        # step(); all host-side
        site = f"engine/{name}" if name else "engine"
        # each tracker reads its worker's set of shapes, not the engine: a
        # reference to the engine would be a cycle, and ``del`` alone must
        # free its model and pools
        self._compile_trackers = {
            w: CompileTracker(f"{site}/{w}",
                              lambda shapes=self._signatures[w]: len(shapes))
            for w in workers}
        self._obs_cache = None  # (registry, generation, handles...)
        # a fleet router retires request traces and histograms itself; it
        # clears this flag on the engines it manages
        self._standalone_obs = True

    # -- construction -----------------------------------------------------

    def _init_draft(self, spec: SpeculationConfig, params,
                    draft_cfg: Optional[LlamaConfig], draft_params) -> None:
        e = self.ecfg
        if not e.sampling.greedy:
            raise ValueError(
                "speculation requires greedy sampling (the accept "
                "rule compares the target's greedy choice)")
        if e.disaggregated:
            raise ValueError(
                "speculation runs inside the packed worker; "
                "disaggregated prefill/decode is not supported")
        wq = e.weight_quant
        if wq is not None and draft_cfg is not None:
            # under a weight-quantization tier the draft serves quantized
            # too: its forwards are most of a round's steps
            if draft_cfg.weight_quant != wq:
                draft_cfg = dataclasses.replace(draft_cfg, weight_quant=wq)
            if draft_params is not None:
                draft_params = quantize_params_for_serving(draft_cfg,
                                                           draft_params)
        self._draft_cfg = draft_cfg or self.model_cfg
        if draft_cfg is None and draft_params is None:
            self.draft_model, self._draft_forward = self.model, self._forward
        else:
            family, self._draft_forward = _family(self._draft_cfg)
            self.draft_model = family.build_model(
                self._draft_cfg,
                draft_params if draft_params is not None else params,
                self.device)
        k, nb = spec.speculation_length, spec.num_branches
        self._spec_slots = spec.max_spec_slots or min(
            e.max_slots, max(1, e.token_budget // (nb * (k + 1))))
        self._table_rows = e.max_slots + self._spec_slots * nb
        self._spec_buffers = build_medusa_tree(spec.tree_choices()).to(
            self.device)
        self._spec_branch_of = branch_of_nodes(spec).to(self.device)

    def _init_cache(self):
        # speculation widens the table with lane rows; the pool itself
        # (num_blocks) is unchanged: lanes borrow blocks for a round
        e, m = self.ecfg, self.model_cfg
        return self._pool(m, e.kv_dtype or m.dtype)

    def _init_draft_cache(self):
        """The draft model's own pool, with the target pool's block
        geometry (same num_blocks, block_size and tables): block ids,
        clones, frees and the stale-position wipe apply to both pools in
        step, so one host allocator governs both."""
        if self._spec is None:
            return None
        d = self._draft_cfg
        return self._pool(d, self.ecfg.kv_dtype or d.dtype)

    def _pool(self, m: LlamaConfig, dtype: torch.dtype):
        e = self.ecfg
        if e.quantized:
            return init_quantized_paged_kv_cache(
                m.num_layers, e.num_blocks, e.block_size, m.num_kv_heads,
                m.head_dim_, self._table_rows, e.max_blocks_per_seq,
                device=self.device)
        return init_paged_kv_cache(
            m.num_layers, e.num_blocks, e.block_size, m.num_kv_heads,
            m.head_dim_, self._table_rows, e.max_blocks_per_seq,
            dtype=dtype, device=self.device)

    # -- captured workers (aot_cache) --------------------------------------

    def _worker_fingerprint(self) -> Tuple[Any, ...]:
        """Everything besides the width that changes a captured worker
        (the reference's parts: model config, the engine knobs the step
        reads, the source of the forward and the sampler, the weights'
        names, shapes and dtypes), plus what a graph binds by address: the
        device and the weights' identity (their storage addresses)."""
        e = self.ecfg
        sd = self.model.state_dict()
        params_spec = tuple((name, tuple(t.shape), str(t.dtype))
                            for name, t in sd.items())
        weights = tuple(t.data_ptr() for t in sd.values())
        return (repr(self.model_cfg), e.block_size, e.num_blocks,
                e.max_slots, e.max_blocks_per_seq, e.quantized,
                str(e.kv_dtype), repr(e.sampling),
                source_fingerprint(self._forward, sample), params_spec,
                str(self.device), weights)

    def _capture_worker(self, width: int, pool=None) -> CapturedStep:
        """The ``width``-wide step over ``pool`` (a fresh pool when None)
        as a :class:`CapturedStep`: its inputs are the token, position and
        slot-id buffers, captured (and warmed up) as an all-pad batch,
        which writes only the pool's spare rows."""
        dev = self.device
        pool = pool if pool is not None else self._init_cache()
        tokens = torch.zeros((1, width), dtype=torch.int32, device=dev)
        positions = torch.full((1, width), PAD_POSITION, dtype=torch.int32,
                               device=dev)
        slot_ids = torch.full((width,), self.ecfg.max_slots,
                              dtype=torch.int32, device=dev)
        model, forward = self.model, self._forward

        def step(tokens, positions, slot_ids):
            return forward(model, tokens, positions, pool,
                           slot_ids=slot_ids)[0]

        return CapturedStep(step, (tokens, positions, slot_ids),
                            holds={"model": model, "cache": pool})

    def _build_aot_workers(self) -> None:
        """Lease (or capture and publish) one executable per worker. The
        workers of one engine share its pool: after the first, a lookup
        accepts only entries captured over the same pool. A leased pool is
        reset, so the engine starts exactly like a fresh one; the leases
        return to the cache when the engine is freed."""
        e = self.ecfg
        widths = ([("prefill", e.prefill_budget or e.token_budget),
                   ("decode", e.max_slots)] if e.disaggregated
                  else [("packed", e.token_budget)])
        fp = self._worker_fingerprint()
        pool, workers = None, {}
        for worker, width in widths:
            key = self._aot.key_for("engine-step", worker, width, *fp)
            match = (None if pool is None
                     else (lambda ex, p=pool: ex.holds["cache"] is p))
            ex, from_cache = self._aot.compile_or_load(
                key, self._capture_worker, (width, pool), match=match)
            if pool is None:
                pool = ex.holds["cache"]
                if from_cache:
                    self._reset_pool(pool)
            workers[worker] = AotWorker(ex, from_cache)
        # the graphs read the weights of the model they were captured with;
        # the key holds its weights' addresses, so they are this engine's
        self.model = next(iter(workers.values())).executable.holds["model"]
        self.cache = pool
        self._aot_workers = workers
        self._pinned: Dict[str, torch.Tensor] = {}
        self._freed_buf = torch.zeros((e.num_blocks,), dtype=torch.bool,
                                      device=self.device)
        weakref.finalize(self, self._aot.release,
                         *(w.executable for w in workers.values()))

    def _reset_pool(self, pool) -> None:
        """A leased pool back to a fresh engine's: zero K/V, unit scales,
        every stored position the pad sentinel, unmapped tables."""
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(pool, name, None)
            if t is not None:
                t.fill_(1 if name.endswith("scale") else 0)
        pool.pos.fill_(PAD_POSITION)
        pool.block_tables.fill_(-1)
        pool.lengths.zero_()

    def _upload(self, name: str, dst: torch.Tensor, src: np.ndarray) -> None:
        """``dst.copy_(src)`` with no host sync: on CUDA from a pinned
        staging buffer kept per ``name`` (its last copy finished at the
        previous step's readback)."""
        if dst.device.type != "cuda":
            dst.copy_(torch.from_numpy(src))
            return
        stage = self._pinned.get(name)
        if stage is None:
            stage = self._pinned[name] = torch.empty(
                src.shape, dtype=dst.dtype, pin_memory=True)
        stage.numpy()[...] = src
        dst.copy_(stage, non_blocking=True)

    def _readback(self, t: torch.Tensor) -> np.ndarray:
        """``t`` on the host, through pinned memory and one CUDA event (no
        synchronizing copy)."""
        if t.device.type != "cuda":
            return t.cpu().numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy().copy()

    def worker_replays(self) -> Dict[str, int]:
        """Graph replays per captured worker (empty without a cache)."""
        return {w: aw.replays for w, aw in (self._aot_workers or {}).items()}

    def worker_compile_counts(self) -> Dict[str, int]:
        """Distinct input-shape signatures per worker: ``{"packed": n}``
        or, disaggregated, ``{"prefill": n, "decode": n}``; with
        speculation also ``spec_draft`` and ``spec_verify``."""
        return {w: len(s) for w, s in self._signatures.items()}

    def compile_count(self) -> int:
        """Most distinct input-shape signatures any worker has seen (the
        fixed-shape invariant: stays 1 as the live-request mix, the accept
        rate and the speculation toggle vary)."""
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
        """Enqueue a request. Raises :class:`RequestRejected` —
        ``reason="never_fits"`` for over-capacity requests,
        ``reason="draining"`` after :meth:`drain` — after recording the
        rejection in ``results``/``stats``."""
        if uid is None:
            uid = f"req{self._uid_counter}"
            self._uid_counter += 1
        req = _RequestState(
            uid=uid, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            arrival_time=(self._now() if arrival_time is None
                          else float(arrival_time)))
        tracer = get_tracer()
        if tracer.enabled:
            # idempotent: adopts a router's trace, or opens one; before
            # the admission checks, so that a rejection closes a span too
            tracer.request_begin(uid, replica=self.name or "engine")
            tracer.request_phase_begin(uid, "engine_queue")
        if self._draining:
            self._reject(req, "draining",
                         f"{uid}: engine is draining, not admitting")
        if not self.fits(req.prompt_len, req.max_new_tokens):
            self._reject(
                req, "never_fits", f"{uid}: prompt_len={req.prompt_len} "
                f"max_new={req.max_new_tokens} cannot fit this engine")
        self._queue.append(req)
        self.stats.queue_depth = self.queue_depth()
        return uid

    def _reject(self, req: _RequestState, reason: str, detail: str):
        self.stats.rejected += 1
        self.results[req.uid] = RequestResult(
            uid=req.uid, prompt_len=req.prompt_len, tokens=[],
            status="rejected")
        tracer = get_tracer()
        trace_id = tracer.request_trace_id(req.uid) if tracer.enabled \
            else None
        if self._standalone_obs:
            observe_request_metrics(
                "rejected", replica=self.name or "engine",
                queue_s=0.0, e2e_s=0.0)
            if tracer.enabled:
                tracer.request_end(req.uid, outcome="rejected",
                                   reason=reason)
        raise RequestRejected(reason, detail, trace_id=trace_id)

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    # -- fleet controls ---------------------------------------------------

    def queue_depth(self) -> int:
        """Live requests on this engine (queued + running slots)."""
        return (len(self._queue)
                + sum(1 for s in self._slots if s is not None))

    def pool_free_blocks(self) -> int:
        """Unallocated KV blocks in the pool."""
        return self.allocator.num_blocks - self.allocator.num_allocated

    @property
    def speculating(self) -> bool:
        """Whether decode steps currently run speculation rounds."""
        return self._spec is not None and self._spec_on

    def set_speculation(self, on: bool) -> None:
        """Toggle speculation at a step boundary. It changes which
        workers run, never any worker's shapes; a no-op on an engine built
        without a :class:`.speculative.SpeculationConfig`."""
        if self._spec is not None:
            self._spec_on = bool(on)

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

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Stop admitting new requests; in-flight work keeps stepping to
        completion (``submit`` now rejects with ``reason="draining"``)."""
        self._draining = True

    def evict(self, request_id: str):
        """Remove a live request (queued or running), freeing any blocks
        it holds. Returns ``(prompt, generated_so_far)`` so that the caller
        can resubmit it elsewhere; raises ``KeyError`` if it is not live
        here. It leaves no entry in ``results``."""
        for req in self._queue:
            if req.uid == request_id:
                self._queue.remove(req)
                self.stats.resubmitted += 1
                self.stats.queue_depth = self.queue_depth()
                return list(req.prompt), list(req.generated)
        for req in self._slots:
            if req is not None and req.uid == request_id:
                self._release(req)
                self.stats.resubmitted += 1
                self.stats.queue_depth = self.queue_depth()
                return list(req.prompt), list(req.generated)
        raise KeyError(f"request {request_id!r} is not live on this engine")

    def aot_warm(self) -> bool:
        """True when every worker was leased from the executable cache:
        this engine spun up without capturing anything (``False`` without
        a cache, as the reference's engine without one)."""
        return self._aot_workers is not None and all(
            w.from_cache for w in self._aot_workers.values())

    # -- live migration ---------------------------------------------------

    def export_session(self, request_id: str) -> SessionTicket:
        """Lift a live request off this engine as a :class:`SessionTicket`
        (scheduler state plus its KV blocks), leaving no trace here (blocks
        freed, no ``results`` entry). Unlike :meth:`evict`, generated tokens
        and cached KV survive: landing the ticket elsewhere prefills
        nothing. Raises ``KeyError`` if the request is not live here."""
        now = self._now()
        for req in self._queue:
            if req.uid == request_id:
                self._queue.remove(req)
                self.stats.migrated_out += 1
                self.stats.queue_depth = self.queue_depth()
                return SessionTicket(
                    uid=req.uid, prompt=list(req.prompt),
                    generated=list(req.generated),
                    max_new_tokens=req.max_new_tokens,
                    n_cached=0, age_s=now - req.arrival_time,
                    ttft_s=None,
                    trace=get_tracer().request_export(req.uid))
        for req in self._slots:
            if req is not None and req.uid == request_id:
                blocks = [int(b) for b in self._tables[req.slot] if b >= 0]
                # keep_upto=n_cached: a partially shared donor block ships
                # only this session's rows, never the donor's tail
                kv = extract_blocks(self.cache, blocks,
                                    keep_upto=req.n_cached)
                kv_fp = (kv_payload_fingerprints(kv, PAYLOAD_BLOCK_AXES)
                         if self.ecfg.integrity else None)
                ticket = SessionTicket(
                    uid=req.uid, prompt=list(req.prompt),
                    generated=list(req.generated),
                    max_new_tokens=req.max_new_tokens,
                    n_cached=req.n_cached,
                    age_s=now - req.arrival_time,
                    ttft_s=(req.first_token_time - req.arrival_time
                            if req.first_token_time is not None
                            else None),
                    n_blocks=len(blocks), kv=kv, kv_fp=kv_fp,
                    trace=get_tracer().request_export(req.uid))
                self._release(req)
                self.stats.migrated_out += 1
                self.stats.queue_depth = self.queue_depth()
                return ticket
        raise KeyError(f"request {request_id!r} is not live on this engine")

    def _check_admissible(self, ticket: SessionTicket) -> None:
        if self._draining:
            raise RequestRejected(
                "draining", f"{ticket.uid}: engine is draining")
        if not self.fits(len(ticket.prompt), ticket.max_new_tokens):
            raise RequestRejected(
                "never_fits", f"{ticket.uid}: cannot fit this engine")

    def import_session(self, ticket: SessionTicket) -> None:
        """Land a :class:`SessionTicket` here and continue it with no
        prefill: allocate blocks, inject the shipped KV, rebuild the
        scheduler state at its exported position. All or nothing:
        :class:`RequestRejected` (draining, never fits; no result is
        recorded, the ticket still belongs to the caller),
        :class:`.paging.CacheExhaustedError` (no slot, no blocks) and
        :class:`..resilience.integrity.IntegrityError` (a shipped block
        failed its fingerprint, checked before any pool write; or, with
        ``integrity`` on, KV shipped without fingerprints) leave this
        engine untouched."""
        self._check_admissible(ticket)
        if (self.ecfg.integrity and ticket.kv is not None
                and ticket.kv_fp is None):
            self.stats.integrity_rejects += 1
            emit_event("integrity_mismatch", scope="kv_ticket",
                       uid=ticket.uid,
                       corrupt=[("<unfingerprinted>", -1)])
            raise IntegrityError(
                f"{ticket.uid}: ticket ships KV with no fingerprints "
                "while this engine enforces integrity — importing "
                "unverifiable blocks would silently skip the check; "
                "re-export with integrity on (or turn it off here "
                "explicitly)")
        if ticket.kv is not None and ticket.kv_fp is not None:
            arrived = kv_payload_fingerprints(ticket.kv, PAYLOAD_BLOCK_AXES)
            bad: List[Tuple[str, int]] = []
            for name, fps in ticket.kv_fp.items():
                got = arrived.get(name, [])
                if len(got) != len(fps):
                    bad.append((name, -1))  # tensor missing or reshaped
                    continue
                bad.extend((name, i) for i, (want, have)
                           in enumerate(zip(fps, got)) if want != have)
            bad.extend((name, -1) for name in arrived
                       if name not in ticket.kv_fp)
            if bad:
                self.stats.integrity_rejects += 1
                emit_event("integrity_mismatch", scope="kv_ticket",
                           uid=ticket.uid, corrupt=bad[:8])
                raise IntegrityError(
                    f"{ticket.uid}: shipped KV blocks failed their "
                    f"integrity fingerprints at (tensor, block) {bad[:8]} "
                    "— ticket rejected, nothing imported")
        self._land_session(ticket, blocks=None)

    def _land_session(self, ticket: SessionTicket,
                      blocks: Optional[List[int]]) -> None:
        """The landing shared by :meth:`import_session` and
        :meth:`commit_stream_import`: rebuild the scheduler state at the
        ticket's exported position. ``blocks=None``: the KV rides in
        ``ticket.kv`` and blocks are allocated and injected here; otherwise
        ``blocks`` are allocated already and hold the streamed payload."""
        now = self._now()
        req = _RequestState(
            uid=ticket.uid, prompt=[int(t) for t in ticket.prompt],
            max_new_tokens=int(ticket.max_new_tokens),
            arrival_time=now - ticket.age_s,
            generated=[int(t) for t in ticket.generated])
        tracer = get_tracer()
        if tracer.enabled:
            # resume the request's trace under its trace-id and mark the
            # hop, so that its final span counts the migration
            if ticket.trace is not None:
                tracer.request_import(ticket.trace)
            else:
                tracer.request_begin(req.uid)
            tracer.request_mark(req.uid, "migrate")
            tracer.request_annotate(req.uid, replica=self.name or "engine")
        if ticket.n_blocks == 0:
            self._queue.append(req)
            self.stats.migrated_in += 1
            self.stats.queue_depth = self.queue_depth()
            return
        free = self._free_slots()
        if not free:
            raise CacheExhaustedError(
                f"{ticket.uid}: no free slot on this engine")
        if blocks is None:
            blocks = self._alloc_blocks(ticket.n_blocks)
            inject_blocks(self.cache, blocks, ticket.kv)
            # injected blocks are fully overwritten (K/V and positions): a
            # pending freed-position wipe would null real rows
            self._freed_dirty.difference_update(blocks)
        slot = free[0]
        req.slot = slot
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        req.admit_time = now
        req.n_cached = int(ticket.n_cached)
        # a ticket ships the TARGET pool's KV only: the draft pool has no
        # rows for the imported context, so this request decodes without
        # speculation (until a preemption prefills it here)
        req.spec_ok = False
        if ticket.ttft_s is not None:
            req.first_token_time = req.arrival_time + ticket.ttft_s
        for i, blk in enumerate(blocks):
            self._tables[slot, i] = blk
        self._slot_blocks[slot] = list(blocks)
        self._slots[slot] = req
        self.stats.migrated_in += 1
        self.stats.migrated_tokens += req.n_cached
        self.stats.queue_depth = self.queue_depth()
        # the landed prompt blocks are publishable prefix state here too
        self._maybe_insert_prefix(req)

    # -- streamed import: reserve blocks, land chunks as they arrive, wire
    # the scheduler state only on commit. Reserved blocks are in no table
    # until then, so half-landed state never reaches attention; a torn
    # stream aborts and the blocks free with the pool as before ``begin``.

    def begin_stream_import(self, ticket: SessionTicket) -> Dict[str, Any]:
        """Open a streamed import for ``ticket`` (its scheduler state; the
        KV follows chunk by chunk through :meth:`stream_inject`). Reserves
        ``ticket.n_blocks`` blocks and returns a handle for the other three
        calls. Raises like :meth:`import_session`'s admission checks;
        nothing is reserved on failure."""
        self._check_admissible(ticket)
        if ticket.n_blocks <= 0:
            raise ValueError(
                f"{ticket.uid}: streamed import needs KV blocks; "
                "queued-state tickets go through import_session")
        if not self._free_slots():
            raise CacheExhaustedError(
                f"{ticket.uid}: no free slot on this engine")
        blocks = self._alloc_blocks(ticket.n_blocks)
        # the chunks overwrite every row of these blocks before commit maps
        # them: a freed-position wipe in between would null real positions
        self._freed_dirty.difference_update(blocks)
        return {"uid": ticket.uid, "blocks": list(blocks),
                "ticket": ticket}

    def stream_inject(self, handle: Dict[str, Any], name: str,
                      layer: int, arr: Any,
                      blocks: Optional[Sequence[int]] = None) -> None:
        """Land one verified chunk into the reserved blocks: tensor
        ``name`` (``k``/``v``/``k_scale``/``v_scale`` at ``layer``, or the
        layer-less ``pos``). Chunks land in any order; each overwrites its
        rows. ``blocks`` (indices into the reserved list) lands a shard of
        the slab instead of all of it."""
        sel = (handle["blocks"] if blocks is None
               else [handle["blocks"][int(i)] for i in blocks])
        idx = torch.as_tensor(sel, dtype=torch.long, device=self.device)
        if name == "pos":
            self.cache.pos[idx] = to_torch(arr).to(self.device,
                                                   torch.int32)
            return
        pool = getattr(self.cache, name)
        pool[layer, idx] = to_torch(arr).to(self.device, pool.dtype)

    def commit_stream_import(self, handle: Dict[str, Any]) -> None:
        """Publish a completed stream: wire the scheduler state onto the
        populated reserved blocks. Re-checks admission (the engine may
        have started draining or filled its slots since ``begin``) and
        raises without publishing anything; the caller then
        :meth:`abort_stream_import`\\ s."""
        if self._draining:
            raise RequestRejected(
                "draining", f"{handle['uid']}: engine is draining")
        self._land_session(handle["ticket"], blocks=handle["blocks"])

    def abort_stream_import(self, handle: Dict[str, Any]) -> None:
        """Tear down a failed stream: free every reserved block (none was
        mapped into a table). Abort once."""
        self._freed_dirty.update(self.allocator.free(handle["blocks"]))

    def handoff_ready(self, request_id: str) -> bool:
        """True once ``request_id`` has finished prefill *and* produced
        its first token here: the earliest export that ships the whole
        prompt's KV and an honest ``ttft_s``."""
        for req in self._slots:
            if req is not None and req.uid == request_id:
                return req.decoding and bool(req.generated)
        return False

    def export_prefixes(self, max_blocks: Optional[int] = None
                        ) -> Optional[Dict[str, Any]]:
        """Ship (up to ``max_blocks``) hottest prefix-trie subtrees with
        their pool blocks: warm-start material for a fresh engine. ``None``
        when there is nothing to ship."""
        if self.prefix_cache is None or self.prefix_cache.size == 0:
            return None
        nodes = self.prefix_cache.snapshot(max_blocks)
        blocks = [n["block"] for n in nodes]
        kv = extract_blocks(self.cache, blocks, keep_upto=PAD_POSITION)
        return {"nodes": nodes, "kv": kv}

    def import_prefixes(self, shipment: Optional[Dict[str, Any]]) -> int:
        """Land an :meth:`export_prefixes` shipment into this engine's
        trie; returns the number of nodes inserted. Best effort: a full pool
        imports nothing (0), and a node the trie already holds keeps the
        local block while the shipped copy frees."""
        if (self.prefix_cache is None or not shipment
                or not shipment["nodes"]):
            return 0
        nodes = shipment["nodes"]
        try:
            blocks = self._alloc_blocks(len(nodes))
        except CacheExhaustedError:
            return 0
        inject_blocks(self.cache, blocks, shipment["kv"])
        self._freed_dirty.difference_update(blocks)
        chains: List[Optional[int]] = []
        imported = 0
        for node, blk in zip(nodes, blocks):
            parent = (None if node["parent"] is None
                      else chains[node["parent"]])
            if node["parent"] is not None and parent is None:
                chains.append(None)   # orphaned by a collision upstream
            else:
                chain, inserted = self.prefix_cache.insert(
                    parent, node["tokens"], blk)
                chains.append(chain)
                imported += inserted
            # drop the import's own reference: the trie (or nobody) owns
            # the block now; a block that freed needs the usual wipe
            self._freed_dirty.update(self.allocator.free([blk]))
        return imported

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

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _admit(self) -> None:
        free = self._free_slots()
        now = self._now()
        tracer = get_tracer()
        while free and self._queue and self._queue[0].arrival_time <= now:
            req = self._queue.popleft()
            slot = free.pop(0)
            req.slot = slot
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            if req.admit_time is None:
                req.admit_time = now
            if tracer.enabled:
                tracer.request_phase_end(req.uid, "engine_queue")
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

    def _build_schedule(self, skip=frozenset()):
        """Pack this step's rows: (req, token, position, produce) — one
        decode row per decoding slot, then prefill chunks. Preempts
        (youngest first) when a decode row can't get its next block;
        prefill chunks merely truncate. Packed mode shares one
        ``token_budget`` across both lists; disaggregated mode gives each
        worker its own width. ``skip`` (request ids) leaves out this
        round's speculating slots, whose decode runs in the draft and
        verify workers instead."""
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
                         if s is not None and s.decoding
                         and id(s) not in skip),
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
        one call for each pool (the reference chunks them only to keep one
        compiled shape). Runs before the freed-position wipe: a source
        freed in the same pass still needs its positions for the clone."""
        if not self._pending_cow:
            return
        # a clone whose slot was preempted in the same pass may have had its
        # dst handed out again: the later clone owns it, and one scatter
        # with a repeated dst would leave either on CUDA
        live = {d: (s, k) for s, d, k in self._pending_cow}
        src, keep = zip(*live.values())
        cow_copy_blocks(self.cache, src, list(live), keep)
        if self.dcache is not None:
            # both pools share block ids: the same clones keep the draft
            # pool's view of every block consistent
            cow_copy_blocks(self.dcache, src, list(live), keep)
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

    def _note_run(self, worker: str, *tensors: torch.Tensor) -> None:
        """Count one run of ``worker`` and record its input shapes."""
        caches = [self.cache] + ([self.dcache] if self.dcache is not None
                                 else [])
        self._signatures[worker].add(tuple(
            (tuple(a.shape), a.dtype) for a in list(tensors) + [
                t for c in caches for t in (c.block_tables, c.pos)]))
        self.worker_runs[worker] += 1

    def _run_worker(self, worker: str, rows, width: int) -> np.ndarray:
        """Pack ``rows`` into a fixed ``width`` batch and run one step of
        ``worker``; returns per-row sampled tokens (aligned with ``rows``).
        With speculation the draft model runs over the same rows into its
        own pool, so that the draft never reads context it has not
        written."""
        tokens = np.zeros((1, width), np.int32)
        positions = np.full((1, width), PAD_POSITION, np.int32)
        slot_ids = np.full((width,), self.ecfg.max_slots, np.int32)
        for i, (req, tok, pos, _) in enumerate(rows):
            tokens[0, i] = tok
            positions[0, i] = pos
            slot_ids[i] = req.slot
        if self._aot_workers is not None:
            aw = self._aot_workers[worker]
            bufs = aw.executable.inputs
            for name, buf, a in zip(("tokens", "positions", "slot_ids"),
                                    bufs, (tokens, positions, slot_ids)):
                self._upload(f"{worker}/{name}", buf, a)
            self._note_run(worker, *bufs)
            logits = aw()
            return self._readback(sample(logits[0], self._generator,
                                         self.ecfg.sampling))
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (tokens, positions, slot_ids)]
        self._note_run(worker, *args)
        logits, self.cache = self._forward(
            self.model, args[0], args[1], self.cache, slot_ids=args[2])
        if self.dcache is not None:
            _, self.dcache = self._draft_forward(
                self.draft_model, args[0], args[1], self.dcache,
                slot_ids=args[2])
        return sample(logits[0], self._generator,
                      self.ecfg.sampling).cpu().numpy()

    # -- speculation: the two workers -------------------------------------

    def _lanes(self) -> torch.Tensor:
        s, nb = self._spec_slots, self._spec.num_branches
        return (self.ecfg.max_slots
                + torch.arange(s * nb, dtype=torch.int32, device=self.device))

    def _build_spec_draft(self) -> Callable:
        """The draft worker, ``draft_fn(committed [S], pos [S]) -> drafted
        [S, B, k]``: propose ``k`` tokens on each of ``B`` branches of each
        speculating slot into the draft pool (in place). Depth 0 writes the
        committed token's draft K/V into every lane and splits the branches
        by the draft's top-B choices; depths 1..k follow each branch
        greedily. The last depth runs too, so that the last drafted token's
        K/V lands (its own proposal is discarded)."""
        spec = self._spec
        k, nb, s = spec.speculation_length, spec.num_branches, \
            self._spec_slots
        # the engine holds the worker: a weak reference back keeps the pair
        # out of a reference cycle, so that ``del`` alone frees the engine
        eng = weakref.proxy(self)

        def draft_fn(committed: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
            lanes = eng._lanes()
            eng._note_run("spec_draft", committed, pos)
            pos0 = pos.repeat_interleave(nb)                    # [S*B]
            tok0 = committed.repeat_interleave(nb)
            logits, eng.dcache = eng._draft_forward(
                eng.draft_model, tok0[None], pos0[None], eng.dcache,
                slot_ids=lanes)
            # branch split: lane (s, b) continues from the draft's b-th
            # choice (the rows of one slot are equal: read lane b=0's),
            # ties broken as jax.lax.top_k breaks them
            top = top_k_indices(logits[0], nb)                  # [S*B, B]
            tok = top.reshape(s, nb, nb)[:, 0, :].reshape(s * nb)
            toks = []
            for d in range(1, k + 1):
                p = torch.where(pos0 < PAD_POSITION, pos0 + d,
                                torch.full_like(pos0, PAD_POSITION))
                lg, eng.dcache = eng._draft_forward(
                    eng.draft_model, tok[None], p[None], eng.dcache,
                    slot_ids=lanes)
                toks.append(tok)
                tok = torch.argmax(lg[0], dim=-1)
            return torch.stack(toks, dim=1).reshape(s, nb, k)

        return draft_fn

    def _build_spec_verify(self) -> Callable:
        """The verify worker, ``verify_fn(committed [S], drafted [S, B, k],
        pos [S]) -> (emit [S, k+1], accept_len [S], best_branch [S])``: one
        target forward over every lane's ``[committed, d_1..d_k]`` rows
        (causal within the lane through the stored positions), the deepest
        target-consistent path (:func:`.speculative.medusa_accept_longest`),
        and the rollback: the rows outside the winning branch's accepted
        path get PAD_POSITION in both pools (one scatter each)."""
        spec = self._spec
        k, nb, s = spec.speculation_length, spec.num_branches, \
            self._spec_slots
        rows = s * nb * (k + 1)
        eng = weakref.proxy(self)       # as in _build_spec_draft

        def verify_fn(committed: torch.Tensor, drafted: torch.Tensor,
                      pos: torch.Tensor):
            eng._note_run("spec_verify", committed, drafted, pos)
            dev = eng.device
            offs = torch.arange(k + 1, device=dev)
            lane_tok = torch.cat([committed.long().repeat_interleave(nb)
                                  .reshape(s, nb, 1), drafted], dim=2)
            p = pos.long()[:, None, None]
            lane_pos = torch.where(p < PAD_POSITION, p + offs[None, None, :],
                                   torch.full_like(p, PAD_POSITION)
                                   ).expand(s, nb, k + 1)
            slot_ids = eng._lanes().reshape(s, nb)[:, :, None].expand(
                s, nb, k + 1).reshape(rows)
            positions = lane_pos.reshape(1, rows).to(torch.int32)
            logits, eng.cache = eng._forward(
                eng.model, lane_tok.reshape(1, rows), positions, eng.cache,
                slot_ids=slot_ids)
            lg = logits[0].reshape(s, nb, k + 1, logits.shape[-1])
            # tree node order of SpeculationConfig.tree_choices(): the root,
            # then branch-major chains, node (b, d) at 1 + b*k + d - 1
            tree_logits = torch.cat(
                [lg[:, 0, :1], lg[:, :, 1:].reshape(s, nb * k, -1)], dim=1)
            tree_tokens = torch.cat(
                [committed.long()[:, None], drafted.reshape(s, nb * k)], dim=1)
            best, alen = medusa_accept_longest(tree_logits, tree_tokens,
                                               eng._spec_buffers)
            bonus = torch.gather(torch.argmax(tree_logits, dim=-1), 1,
                                 best[:, None])[:, 0]
            bstar = eng._spec_branch_of[best].clamp(min=0)
            sel = torch.gather(drafted, 1, bstar[:, None, None].expand(
                s, 1, k))[:, 0]                                    # [S, k]
            emit = torch.where(offs[None, :] < alen[:, None],
                               torch.nn.functional.pad(sel, (0, 1)),
                               bonus[:, None])
            brow = torch.arange(nb, device=dev)[None, :, None]
            keep = ((brow == bstar[:, None, None])
                    & (offs[None, None, :] <= alen[:, None, None]))
            c = eng.cache
            tok_tables = c.block_tables[slot_ids.long().clamp(
                0, c.max_slots - 1)]
            flat_idx = flat_write_indices(tok_tables, positions[0],
                                          c.block_size, c.capacity)
            reject = (~keep).reshape(rows)
            mask_pool_positions(eng.cache.pos, flat_idx, reject)
            mask_pool_positions(eng.dcache.pos, flat_idx, reject)
            return emit, alen, bstar

        return verify_fn

    # -- speculation: the round's host side -------------------------------

    def _begin_spec_round(self) -> List[Optional[Tuple]]:
        """Pick this round's speculating slots (oldest decoding first) and
        allocate their branch lanes: a lane's table row is the slot's row
        with every block the round writes replaced by a branch-private
        clone (copy-on-write for mapped blocks, fresh blocks for the tail
        not mapped yet); prefix blocks below the write window stay shared.
        A slot that cannot get its lane blocks decodes normally this step
        (lane allocation never preempts). Returns a list indexed by lane
        group (``None`` = unused group)."""
        if not self.speculating:
            return []
        spec, e = self._spec, self.ecfg
        k, nb, bs = spec.speculation_length, spec.num_branches, \
            e.block_size
        round_state: List[Optional[Tuple]] = []
        for req in sorted((s for s in self._slots
                           if s is not None and s.decoding and s.spec_ok
                           and len(s.generated) < s.max_new_tokens),
                          key=lambda r: r.admit_seq):
            if len(round_state) >= self._spec_slots:
                break
            pos = req.n_cached
            blk0, blk_last = pos // bs, (pos + k) // bs
            if (blk_last >= e.max_blocks_per_seq
                    or pos + k >= self.model_cfg.max_seq_len):
                continue        # no lane room at the table/context end
            mapped = [(bi, int(self._tables[req.slot, bi]))
                      for bi in range(blk0, blk_last + 1)]
            try:
                blocks = self._alloc_blocks(nb * len(mapped))
            except CacheExhaustedError:
                continue        # pool pressure: decode normally instead
            it = iter(blocks)
            lane_blocks: List[List[int]] = []
            for b in range(nb):
                lane = e.max_slots + len(round_state) * nb + b
                self._tables[lane, :] = self._tables[req.slot, :]
                blks = []
                for bi, cur in mapped:
                    dst = next(it)
                    if cur >= 0:
                        # branch-private clone: rows below pos are the
                        # shared committed prefix, rows >= pos this lane's
                        # to write (the slot's own block stays untouched
                        # until adoption)
                        self._pending_cow.append((cur, dst, pos))
                        self._freed_dirty.discard(dst)
                        self.stats.cow_copies += 1
                    self._tables[lane, bi] = dst
                    blks.append(dst)
                lane_blocks.append(blks)
            round_state.append((req, lane_blocks, blk0, blk_last))
        return round_state

    def _filter_spec_round(self, round_state):
        """Drop participants whose slot the scheduling pass preempted after
        lane allocation, freeing their lanes (positions wiped through the
        usual freed-block hygiene). Keeps ``None`` holes, so that survivors
        stay aligned with their lane rows."""
        out: List[Optional[Tuple]] = []
        for entry in round_state:
            if entry is None:
                out.append(None)
                continue
            req, lane_blocks = entry[0], entry[1]
            if req.slot is not None and self._slots[req.slot] is req:
                out.append(entry)
            else:
                for blks in lane_blocks:
                    self._freed_dirty.update(self.allocator.free(blks))
                out.append(None)
        return out

    def _land_spec_round(self, round_state, emit, alen, bstar,
                         now: float) -> None:
        """Adopt each participant's verdict: swap the winning branch's lane
        blocks into the slot's table, free the displaced originals and
        every losing branch in ONE allocator call (pool accounting never
        sees a half-freed round), append the accepted tokens and the bonus,
        and retire on EOS / max_new as usual."""
        spec, e = self._spec, self.ecfg
        k, nb = spec.speculation_length, spec.num_branches
        for i, entry in enumerate(round_state):
            if entry is None:
                continue
            req, lane_blocks, blk0, blk_last = entry
            a = max(0, min(int(alen[i]), k))
            b = max(0, min(int(bstar[i]), nb - 1))
            sb = self._slot_blocks[req.slot]
            drop: List[int] = []
            for j, bi in enumerate(range(blk0, blk_last + 1)):
                old = int(self._tables[req.slot, bi])
                if old >= 0:
                    drop.append(old)
                    sb.remove(old)
                win = lane_blocks[b][j]
                self._tables[req.slot, bi] = win
                sb.append(win)
            for bb in range(nb):
                if bb != b:
                    drop.extend(lane_blocks[bb])
            self._freed_dirty.update(self.allocator.free(drop))
            req.spec_rounds += 1
            req.spec_accepted += a
            self.stats.spec_rounds += 1
            self.stats.spec_accepted_tokens += a
            done = False
            n_emit = 0
            for tok in (int(t) for t in emit[i, :a + 1]):
                req.generated.append(tok)
                n_emit += 1
                self.stats.tokens_generated += 1
                if req.first_token_time is None:
                    req.first_token_time = now
                    self.stats.ttft_s.append(now - req.arrival_time)
                if (len(req.generated) >= req.max_new_tokens
                        or (e.eos_id is not None and tok == e.eos_id)):
                    done = True
                    break
            req.n_cached += n_emit
            if done:
                self._retire(req, now)
        # lane rows route one round's writes only: park them afterwards
        self._tables[e.max_slots:, :] = -1

    def _run_spec_round(self, round_state):
        """Draft then verify this round's participants; the round's one
        host sync fetches ``(emit, alen, bstar)`` together."""
        sw = self._spec_slots
        committed = np.zeros((sw,), np.int32)
        posv = np.full((sw,), PAD_POSITION, np.int32)
        for i, entry in enumerate(round_state):
            if entry is None:
                continue
            req = entry[0]
            committed[i] = req.tokens[req.n_cached]
            posv[i] = req.n_cached
        cm = torch.from_numpy(committed).to(self.device)
        pv = torch.from_numpy(posv).to(self.device)
        tracer = get_tracer()
        with tracer.span("engine/spec_draft"):
            drafted = self._spec_draft_fn(cm, pv)
        with tracer.span("engine/spec_verify"):
            out = self._spec_verify_fn(cm, drafted, pv)
        return [t.cpu().numpy() for t in out]

    def step(self) -> int:
        """One serving step. Returns the number of live rows packed plus
        the slots that ran a speculation round (0 = nothing was runnable).
        Disaggregated, the prefill worker runs first, so its new KV lands
        before the decode worker reads."""
        tracer = get_tracer()
        with tracer.span("engine/admission"):
            self._admit()
            round_state = self._begin_spec_round()
            decode_rows, prefill_rows = self._build_schedule(
                {id(x[0]) for x in round_state if x is not None})
            round_state = self._filter_spec_round(round_state)
        rows = decode_rows + prefill_rows
        spec_live = [x for x in round_state if x is not None]
        if not rows and not spec_live:
            return 0
        t_start = self._now()
        if self.stats.first_step_t is None:
            self.stats.first_step_t = t_start
        with tracer.span("engine/cow"):
            self._apply_pending_cow()
        if self._freed_dirty:
            mask = np.zeros((self.ecfg.num_blocks,), np.bool_)
            mask[list(self._freed_dirty)] = True
            self._freed_dirty.clear()
            if self._aot_workers is not None:
                fmask = self._freed_buf
                self._upload("freed", fmask, mask)
            else:
                fmask = torch.from_numpy(mask).to(self.device)
            _clear_freed_positions(self.cache.pos, fmask)
            if self.dcache is not None:
                _clear_freed_positions(self.dcache.pos, fmask)
        lengths = np.zeros((self._table_rows,), np.int32)
        for i, s in enumerate(self._slots):
            if s is not None:
                lengths[i] = s.n_cached
        if self._aot_workers is not None:
            self._upload("tables", self.cache.block_tables, self._tables)
            self._upload("lengths", self.cache.lengths, lengths)
        else:
            tables = torch.from_numpy(self._tables)
            for c in (self.cache, self.dcache):
                if c is not None:
                    c.block_tables.copy_(tables)
                    c.lengths.copy_(torch.from_numpy(lengths))
        e = self.ecfg
        if e.disaggregated:
            sampled = np.zeros((len(rows),), np.int32)
            if prefill_rows:
                with tracer.span("engine/prefill"):
                    sampled[len(decode_rows):] = self._run_worker(
                        "prefill", prefill_rows, e.prefill_budget
                        or e.token_budget)[:len(prefill_rows)]
            if decode_rows:
                with tracer.span("engine/decode"):
                    sampled[:len(decode_rows)] = self._run_worker(
                        "decode", decode_rows,
                        e.max_slots)[:len(decode_rows)]
        else:
            sampled = np.zeros((0,), np.int32)
            if rows:
                with tracer.span("engine/packed"):
                    sampled = self._run_worker("packed", rows,
                                               e.token_budget)
        if spec_live:
            emit, alen, bstar = self._run_spec_round(round_state)
        if self.prefix_cache is not None:
            for req in {id(r[0]): r[0] for r in prefill_rows}.values():
                self._maybe_insert_prefix(req)

        now = self._now()
        if tracer.enabled:
            # a request served this step waited the whole step on it: each
            # participant's phase takes the step's wall time
            step_us = (now - t_start) * 1e6
            tracer.request_slices(
                [(req.uid, "decode_step", step_us) for req in
                 {id(r[0]): r[0] for r in decode_rows}.values()]
                + [(req.uid, "prefill_slice", step_us) for req in
                   {id(r[0]): r[0] for r in prefill_rows}.values()]
                + [(x[0].uid, "decode_step", step_us) for x in spec_live])
        with tracer.span("engine/retirement"):
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
                        or (e.eos_id is not None and tok == e.eos_id)):
                    self._retire(req, now)
            if spec_live:
                self._land_spec_round(round_state, emit, alen, bstar, now)
        self.stats.steps += 1
        self.stats.step_latency_s.append(now - t_start)
        self.stats.last_step_t = now
        self.stats.occupancy.append(
            self.allocator.num_allocated / self.allocator.num_blocks)
        self.stats.shared_fraction.append(
            self.allocator.num_shared / max(1, self.allocator.num_allocated))
        self.stats.queue_depth = self.queue_depth()
        self._publish_obs(now - t_start)
        return len(rows) + len(spec_live)

    #: EngineStats scalar fields bridged into ``nxd_engine_stats`` a step
    _OBS_SCALAR_FIELDS = (
        "steps", "completed", "rejected", "preempted", "resubmitted",
        "queue_depth", "tokens_generated", "cow_copies",
        "prefix_hit_tokens", "prefill_tokens", "migrated_in",
        "migrated_out", "migrated_tokens", "spec_rounds",
        "spec_accepted_tokens")

    def _publish_obs(self, step_latency_s: float) -> None:
        """Bridge :class:`EngineStats` into registry gauges and poll the
        per-worker compile trackers: one bool check when obs is disabled.
        Child handles are cached against the registry's reset generation."""
        reg = get_registry()
        if not reg.enabled:
            return
        for tracker in self._compile_trackers.values():
            tracker.poll()
        cache = self._obs_cache
        if (cache is None or cache[0] is not reg
                or cache[1] != reg.generation):
            stats_g = reg.gauge(
                "nxd_engine_stats",
                "EngineStats scalar counters bridged per step "
                "(monotonic fields included — they mirror the engine's "
                "own counters).",
                labels=("field",))
            step_h = reg.histogram("nxd_engine_step_seconds",
                                   "Serving step wall time.")
            # a registry reset() mid-run restarts the histogram empty while
            # EngineStats keeps its samples: replay the retained window
            # (all but this step's, observed below)
            for v in self.stats.step_latency_s[-HISTOGRAM_RESERVOIR:-1]:
                step_h.observe(v)
            cache = self._obs_cache = (
                reg, reg.generation,
                {f: stats_g.labels(field=f)
                 for f in self._OBS_SCALAR_FIELDS},
                reg.gauge("nxd_engine_pool_free_blocks",
                          "Unallocated KV blocks."),
                step_h)
        _, _, fields, free_g, step_h = cache
        st = self.stats
        for f, child in fields.items():
            child.set(float(getattr(st, f)))
        free_g.set(self.pool_free_blocks())
        step_h.observe(step_latency_s)

    def _retire(self, req: _RequestState, now: float) -> None:
        self._release(req)
        self.stats.completed += 1
        ttft = (req.first_token_time - req.arrival_time
                if req.first_token_time is not None else None)
        n_gen = len(req.generated)
        tpot = ((now - req.first_token_time) / (n_gen - 1)
                if req.first_token_time is not None and n_gen > 1
                else None)
        k = self._spec.speculation_length if self._spec else 0
        self.results[req.uid] = RequestResult(
            uid=req.uid, prompt_len=req.prompt_len,
            tokens=list(req.generated), status="completed",
            ttft_s=ttft, finish_s=now, tpot_s=tpot,
            accept_rate=(req.spec_accepted / (req.spec_rounds * k)
                         if req.spec_rounds and k else None))
        if self._standalone_obs:
            observe_request_metrics(
                "completed", replica=self.name or "engine",
                ttft_s=ttft, tpot_s=tpot,
                queue_s=(req.admit_time - req.arrival_time
                         if req.admit_time is not None else None),
                e2e_s=now - req.arrival_time)
            tracer = get_tracer()
            if tracer.enabled:
                tracer.request_end(req.uid, outcome="completed",
                                   replica=self.name or "engine",
                                   tokens=n_gen)
