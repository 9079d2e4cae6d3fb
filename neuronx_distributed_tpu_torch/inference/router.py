"""Fault-tolerant multi-replica serving: the front-end request router
(counterpart of ``neuronx_distributed_tpu/inference/router.py``).

:class:`ReplicaRouter` fronts N :class:`~.engine.ServingEngine` replicas
(in-process instances, each with its own block pool, all sharing one copy
of the weights on the device) and owns the request lifecycle end to end:

* **placement**: join-shortest-queue over live queue depth + pool
  occupancy, with optional session affinity; ``placement="prefix"`` sends
  a request to the replica whose prefix cache holds the most of its
  prompt;
* **admission control**: a per-tenant token bucket (:class:`TenantPolicy`)
  plus a global committed-token budget, with a typed
  :class:`~.engine.RequestRejected` at submit and an overload ladder that
  degrades before it sheds:

  ========================  =========================================
  load (committed/budget)   behavior
  ========================  =========================================
  < degrade_threshold       admit as-is
  >= degrade_threshold      admit, cap ``max_new_tokens`` at
                            ``degrade_max_new``
  >= shed_threshold         additionally reject lowest-priority
                            tenants (``over_budget``)
  > 1.0                     reject everyone (``over_budget``)
  ========================  =========================================

* **health + failover**: a per-replica :class:`ReplicaMonitor` (step
  latency z-score spikes, a stall budget, a
  :class:`~.paging.CacheExhaustedError` storm counter) trips a circuit
  breaker: the replica is marked down, its in-flight requests are
  resubmitted from their prompts to survivors (greedy decoding is
  rng-free, so a restarted request produces the same tokens) with bounded
  retries and exponential backoff, and the replica is revived with a fresh
  engine after a probation window of clean steps;
* **graceful drain**: a :class:`~..resilience.preemption.PreemptionGuard`
  SIGTERM flips the router to drain mode; in-flight requests finish, then
  :class:`ServingPreempted` exits with code 75;
* **elasticity**: a :class:`ScalePolicy` watches queue depth, TTFT p99
  and pool occupancy with hysteresis + cooldown and grows or shrinks the
  fleet through :meth:`ReplicaRouter.scale_up` / ``scale_down``; retiring
  or preempted replicas drain by migration (each live session's KV blocks
  and scheduler state ship to a survivor), and ``warm_prefix_blocks``
  ships trie subtrees to a newcomer;
* **cross-host fabric**: :class:`RouterConfig.fabric` splits the fleet
  into a prefill tier (``p*``) and a decode tier (``d*``); once a request
  has its first token, its session streams to the least-loaded decode
  replica through a :class:`~.transport.KVStreamTransport` over a
  simulated :class:`~.transport.DcnLink`; a torn stream frees what landed
  and the request re-prefills on the prefill tier (``no_handoff``).

Chaos drills inject faults through :meth:`FaultPlan.consult` with
``op="step"`` and ``path=<replica name>`` (``crash`` / ``exhaust`` /
``preempt`` / ``bitflip`` / latency seconds, returned, never slept), the
fleet tick consults ``op="scale"``, ``path="fleet"`` for ``scale_burst``,
and the link ``op="link"`` for the ``link_*`` kinds. See
:func:`chaos_drill`, :func:`sdc_serving_drill`,
:func:`elastic_chaos_drill` and :func:`fabric_chaos_drill`.

With ``aot_cache=`` (an :class:`~.aot_cache.AotExecutableCache`) every
replica serves through captured workers: the first replica of a worker
shape captures it, and a later construction (a scale-up, a revival) leases
a capture that no live replica holds. The router makes no cache of its
own (the reference's default is a memory cache): without one its engines
run eagerly. What the port does not have yet is refused, not ignored: the
long-context replica class (``RouterConfig.long_context_*``, which needs
context-parallel engines).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs.events import emit_event
from ..obs.metrics import get_registry
from ..obs.slo import SloMonitor, SloPolicy
from ..obs.tracing import get_tracer
from ..quantization.serving import quantize_params_for_serving
from ..resilience.chaos import FaultPlan
from ..resilience.preemption import EXIT_PREEMPTED, PreemptionGuard
from ..resilience.watchdog import SpikeDetector, StallTimer
from .aot_cache import AotExecutableCache
from .engine import (EngineConfig, RequestRejected, ServingEngine, _family,
                     observe_request_metrics)
from .paging import CacheExhaustedError
from .transport import DcnLink, KVStreamTransport, StreamConfig


class ServingPreempted(SystemExit):
    """Raised by :meth:`ReplicaRouter.run` after a graceful drain
    completes; carries exit code 75 (reschedule-me) and the final
    results so the caller can flush them before exiting."""

    def __init__(self, results, stats):
        super().__init__(EXIT_PREEMPTED)
        self.results = results
        self.stats = stats


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant admission policy.

    ``rate_tokens_per_s``/``burst_tokens`` parameterize a token bucket
    over *committed* tokens (prompt + max_new per request, net of any
    prefix-sharing credit — shared prompt tokens are work the fleet does
    not redo); the defaults are unlimited. ``priority`` orders tenants
    for overload shedding — lower values are shed first once load
    crosses ``shed_threshold``.
    """

    rate_tokens_per_s: float = math.inf
    burst_tokens: float = math.inf
    priority: int = 1


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Obs-driven autoscaling policy.

    Each router step the fleet's load signals — mean live queue depth
    (pending + per-replica), TTFT p99 (from the
    ``nxd_router_ttft_seconds`` histogram when obs is enabled, recent
    completions otherwise), and worst pool occupancy — are compared
    against the thresholds. A *hot* signal must persist for
    ``hysteresis_steps`` consecutive steps before a scale-up (spikes
    don't flap the fleet), likewise *cold* for scale-down; any scale
    action then freezes the policy for ``cooldown_steps`` so the fleet
    settles before the next decision. ``ttft_p99_high_s`` defaults to
    never-trips — wall-clock TTFT is noisy on CPU test rigs, so queue
    depth and occupancy are the default signals."""

    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 8.0         # mean live requests per replica
    queue_low: float = 1.0
    ttft_p99_high_s: float = math.inf
    occupancy_high: float = 0.85    # worst replica's pool occupancy
    hysteresis_steps: int = 3
    cooldown_steps: int = 8


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Two-tier cross-host topology: ``prefill_replicas`` hosts named
    ``p0..`` take every admission; ``decode_replicas`` hosts named
    ``d0..`` take streamed session handoffs once prefill completes.
    ``stream`` parameterizes the shared DCN link and the per-stream
    reliability knobs (:class:`~.transport.StreamConfig`);
    ``prefill_scale`` / ``decode_scale`` are *independent* autoscale
    policies — the whole point of disaggregation is that the two tiers
    size to different signals (prefill to admission queue, decode to
    slot/pool occupancy). ``None`` keeps a tier's size fixed. With a
    fabric configured, ``RouterConfig.num_replicas`` and ``scale`` are
    ignored."""

    prefill_replicas: int = 1
    decode_replicas: int = 1
    stream: StreamConfig = StreamConfig()
    prefill_scale: Optional[ScalePolicy] = None
    decode_scale: Optional[ScalePolicy] = None


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router-side knobs (engine knobs stay in :class:`EngineConfig`).

    ``global_token_budget`` defaults to the aggregate pool capacity
    (``num_replicas * num_blocks * block_size``). Health thresholds are
    deliberately loose by default — CPU test timing is noisy, so drills
    trigger failures through chaos directives, not wall-clock jitter.
    """

    num_replicas: int = 2
    tenants: Dict[str, TenantPolicy] = dataclasses.field(
        default_factory=dict)
    default_tenant: str = "default"
    # "jsq" = join-shortest-queue; "prefix" = prefix-locality: route to
    # the replica whose prefix cache already holds the most of this
    # prompt (ties fall back to JSQ). Combined with
    # ``EngineConfig.disaggregated`` this is the prefill→decode pipeline
    # placement mode: requests land where their prefix KV lives, the
    # prefill worker computes only the divergent tail, and the decode
    # worker picks the blocks up from the shared pool.
    placement: str = "jsq"
    global_token_budget: Optional[int] = None
    degrade_threshold: float = 0.75
    shed_threshold: float = 0.9
    degrade_max_new: int = 16
    occupancy_weight: float = 4.0   # JSQ: occupancy vs queue-depth weight
    affinity: bool = True
    max_retries: int = 3
    backoff_base_s: float = 0.01
    stall_timeout_s: float = 30.0
    latency_window: int = 32
    latency_zscore: float = 50.0
    latency_min_steps: int = 8
    exhaust_window: int = 8
    exhaust_threshold: int = 3
    probation_steps: int = 8        # router steps a tripped replica sits out
    probation_ok_steps: int = 4     # clean steps to go probation -> up
    # elasticity: None = fixed fleet (scale_up/scale_down stay manual);
    # a ScalePolicy turns on the obs-driven autoscale tick
    scale: Optional[ScalePolicy] = None
    # declarative service-level objectives: when set, a
    # :class:`~..obs.slo.SloMonitor` is evaluated once per router step
    # (availability = live replica fraction); a *sustained* breach emits
    # `slo_breach`, degrades new admissions like the load ladder, and
    # counts as a hot signal for the autoscaler — SLO attainment instead
    # of another hand-picked latency constant
    slo: Optional[SloPolicy] = None
    # trie subtrees shipped to a fresh/revived replica from the hottest
    # surviving trie (0 = off; needs EngineConfig.prefix_sharing)
    warm_prefix_blocks: int = 0
    # SDC defense: every Nth completed request is re-decoded on a
    # *different* replica as a shadow probe (greedy decoding makes the
    # re-decode bit-identical on healthy hardware, so any token
    # divergence is corruption). A mismatch quarantines the primary
    # through the circuit breaker and adopts the shadow's tokens.
    # 0 = off. Shadows ride outside admission: no stats, no budget.
    integrity_shadow_every: int = 0
    # cross-host serving fabric: a two-tier prefill/decode topology with
    # streamed KV handoff over a simulated DCN link (see FabricConfig
    # and inference/transport.py). None = classic single-tier fleet.
    fabric: Optional[FabricConfig] = None
    # the long-context replica class (replicas built from an EngineConfig
    # with ``cp > 1``): the port's engines have no context parallelism
    # yet, so ReplicaRouter refuses any of these three set
    long_context_replicas: int = 0
    long_context_engine: Optional[EngineConfig] = None
    long_context_threshold: Optional[int] = None


@dataclasses.dataclass
class RouterResult:
    uid: str
    tenant: str
    status: str                     # "completed" | "rejected" | "failed"
    tokens: List[int] = dataclasses.field(default_factory=list)
    reason: Optional[str] = None    # rejection reason / failure cause
    replica: Optional[str] = None   # replica that completed it
    resubmits: int = 0              # failovers this request survived
    ttft_s: Optional[float] = None
    degraded: bool = False


@dataclasses.dataclass
class RouterStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    failed: int = 0
    degraded: int = 0
    rejected_by_reason: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    tenant_shed: Dict[str, int] = dataclasses.field(default_factory=dict)
    failovers: int = 0              # circuit-breaker trips
    resubmits: int = 0              # request resubmissions after a trip
    resubmitted_tokens: int = 0     # re-done work: re-prefilled + discarded
    revivals: int = 0
    steps: int = 0
    scale_ups: int = 0              # replicas added (policy or manual)
    scale_downs: int = 0            # replicas retired by migration
    preemptions: int = 0            # SIGTERM-style drains (chaos preempt)
    migrated_sessions: int = 0      # live sessions shipped to a survivor
    migrated_tokens: int = 0        # cached tokens moved without re-prefill
    reprefilled_tokens: int = 0     # migration fallbacks that re-prefilled
    integrity_shadows: int = 0      # shadow re-decodes launched
    integrity_mismatches: int = 0   # shadow/primary token divergences
    slo_breaches: int = 0           # objectives entering sustained breach
    slo_scale_ups: int = 0          # scale-ups the SLO layer demanded
    spec_toggles: int = 0           # SLO-driven speculation flips
    handoffs: int = 0               # sessions committed over the fabric
    handoff_aborts: int = 0         # torn streams (fell back to re-prefill)
    handoff_chunks: int = 0         # chunks across committed streams
    handoff_retries: int = 0        # chunk retransmissions (all streams)
    handoff_bytes: int = 0          # wire bytes incl headers/retransmits
    handoff_wire_payload_bytes: int = 0   # first-copy payload bytes
    handoff_fp32_payload_bytes: int = 0   # same payload at fp32 (baseline)
    ttft_s: List[float] = dataclasses.field(default_factory=list)

    def availability(self) -> float:
        """Admitted-request completion rate — the service-level signal
        (an admitted request that fails after retries is an outage)."""
        return self.completed / max(1, self.admitted)

    def to_dict(self) -> Dict[str, Any]:
        ttft = np.asarray(self.ttft_s or [0.0])
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "completed": self.completed,
            "failed": self.failed,
            "degraded": self.degraded,
            "availability": self.availability(),
            "failovers": self.failovers,
            "resubmits": self.resubmits,
            "resubmitted_tokens": self.resubmitted_tokens,
            "revivals": self.revivals,
            "steps": self.steps,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "preemptions": self.preemptions,
            "migrated_sessions": self.migrated_sessions,
            "migrated_tokens": self.migrated_tokens,
            "reprefilled_tokens": self.reprefilled_tokens,
            "integrity_shadows": self.integrity_shadows,
            "integrity_mismatches": self.integrity_mismatches,
            "slo_breaches": self.slo_breaches,
            "slo_scale_ups": self.slo_scale_ups,
            "spec_toggles": self.spec_toggles,
            "handoffs": self.handoffs,
            "handoff_aborts": self.handoff_aborts,
            "handoff_chunks": self.handoff_chunks,
            "handoff_retries": self.handoff_retries,
            "handoff_bytes": self.handoff_bytes,
            "handoff_wire_ratio": (
                self.handoff_fp32_payload_bytes
                / max(1, self.handoff_wire_payload_bytes)),
            "rejected_by_reason": dict(self.rejected_by_reason),
            "tenant_shed": dict(self.tenant_shed),
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
        }


class ReplicaMonitor:
    """Per-replica health monitor, reusing the training watchdog's
    factored primitives: a :class:`SpikeDetector` over step latency
    (training watches loss; serving watches time), a :class:`StallTimer`
    consulted synchronously via ``observe`` (no background thread — the
    router is single-threaded and fake-clock friendly), and a sliding
    window of :class:`CacheExhaustedError` storms."""

    def __init__(self, cfg: RouterConfig):
        self._cfg = cfg
        self.latency = SpikeDetector(window=cfg.latency_window,
                                     zscore=cfg.latency_zscore,
                                     min_steps=cfg.latency_min_steps)
        self.stall = StallTimer(cfg.stall_timeout_s)
        self.exhausts: Deque[int] = deque(maxlen=cfg.exhaust_window)

    def observe_step(self, latency_s: float,
                     exhausted: bool = False) -> Optional[str]:
        """Feed one step's (possibly chaos-inflated) latency; returns the
        tripped verdict or None."""
        if self.stall.observe(latency_s):
            return "stall"
        if self.latency.observe(latency_s) is not None:
            return "latency_spike"
        self.exhausts.append(1 if exhausted else 0)
        if sum(self.exhausts) >= self._cfg.exhaust_threshold:
            self.exhausts.clear()
            return "exhaust_storm"
        return None


@dataclasses.dataclass
class _RouterRequest:
    uid: str
    tenant: str
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float
    session: Optional[str] = None
    attempts: int = 0               # failovers survived so far
    next_try: float = 0.0           # backoff: not placeable before this
    placed_at: Optional[float] = None
    degraded: bool = False
    charged_tokens: int = 0         # budget charge net of prefix credit
    shadow_of: Optional[str] = None  # uid of the primary this re-decodes
    avoid_replica: Optional[str] = None  # don't place on the primary
    expect_tokens: Optional[List[int]] = None  # primary's recorded tokens
    no_handoff: bool = False        # torn-stream fallback: finish where
    #                                 placed, never re-enter the fabric

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class _Replica:
    name: str
    engine: Optional[ServingEngine]
    monitor: ReplicaMonitor
    state: str = "up"               # "up" | "probation" | "down"
    down_steps: int = 0             # steps left before revival
    ok_steps: int = 0               # clean steps while in probation
    generation: int = 0             # bumped per engine replacement, so
    corrupt_bit: Optional[int] = None  # armed chaos bitflip (SDC drill)
    tier: str = "serve"             # "serve" | fabric: "prefill"/"decode"
    assigned: Dict[str, _RouterRequest] = dataclasses.field(  # obs series
        default_factory=dict)       # from before a revival stay distinct

    @property
    def live(self) -> bool:
        return self.state != "down" and self.engine is not None


def shared_serving_weights(model_cfg, params, engine_cfg: EngineConfig,
                           device: DeviceLike = None):
    """``params`` as every replica's engine will hold them: quantized once
    to ``engine_cfg.weight_quant`` when set, then moved once to ``device``
    in the dtype the serving model keeps each tensor in. An engine built
    from the result makes no copy (``build_model`` moves a tensor only
    where it is not on the device in its dtype already), so N replicas
    share one copy of the weights. Returns ``(model_cfg, params)``."""
    dev = resolve_device(device)
    wq = engine_cfg.weight_quant
    if wq is not None:
        if model_cfg.weight_quant != wq:
            model_cfg = dataclasses.replace(model_cfg, weight_quant=wq)
        params = quantize_params_for_serving(model_cfg, params)
    family, _ = _family(model_cfg)
    model = family.build_model(model_cfg, params, dev)
    return model_cfg, dict(model.state_dict())


def _finish_handoff_trace(tr: KVStreamTransport) -> Optional[Dict[str, Any]]:
    """Precommit hook of the fabric's streams: close the handoff phase on
    the live trace and hand the trace to the committing ticket, so the
    decode side resumes one continuous span with the transfer inside it.
    A plain function: a stream must not keep its router alive."""
    tracer = get_tracer()
    if not tracer.enabled:
        return None
    uid = tr.ticket.uid
    tracer.request_phase_end(uid, "handoff")
    tracer.request_mark(uid, "handoff")
    return tracer.request_export(uid)


class ReplicaRouter:
    """Front-end for N in-process serving replicas; see module docstring.

    Engines can be injected (``engines=``) for tests; by default the
    router builds ``cfg.num_replicas`` fresh :class:`ServingEngine`
    instances on ``device`` (``None`` means CUDA and raises without a
    card) from ``params`` (a state dict), which is quantized and moved to
    the device once (:func:`shared_serving_weights`), so that every
    replica, revival and scale-up shares one copy of the weights. All
    engines run on one ``clock``. ``aot_cache``: an executable cache
    shared by every replica (None: eager engines).
    """

    def __init__(self, model_cfg, params,
                 engine_cfg: EngineConfig = EngineConfig(),
                 cfg: RouterConfig = RouterConfig(), *,
                 engines: Optional[Sequence[ServingEngine]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 preemption_guard: Optional[PreemptionGuard] = None,
                 chaos: Optional[FaultPlan] = None,
                 aot_cache: Optional[AotExecutableCache] = None,
                 draft_cfg=None, draft_params=None,
                 device: DeviceLike = None):
        self._aot = aot_cache
        if (cfg.long_context_replicas or cfg.long_context_engine is not None
                or cfg.long_context_threshold is not None):
            raise NotImplementedError(
                "RouterConfig.long_context_*: the long-context replica "
                "class needs engines with cp > 1, which the PyTorch port "
                "does not have yet")
        if cfg.placement not in ("jsq", "prefix"):
            raise ValueError(
                f"unknown placement {cfg.placement!r}: want 'jsq' or "
                f"'prefix'")
        self.device = resolve_device(device)
        self.ecfg = engine_cfg
        self.model_cfg, self.params = shared_serving_weights(
            model_cfg, params, engine_cfg, self.device)
        # speculative decoding: optional separate draft model shared by
        # every replica (None = self-draft with the target weights)
        self._draft_cfg = draft_cfg
        self._draft_params = draft_params
        if draft_params is not None:
            self._draft_cfg, self._draft_params = shared_serving_weights(
                draft_cfg or model_cfg, draft_params, engine_cfg,
                self.device)
        self.cfg = cfg
        self.stats = RouterStats()
        self.results: Dict[str, RouterResult] = {}
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._guard = preemption_guard
        self._chaos = chaos
        self._draining = False
        self._uid_counter = 0
        self._pending: Deque[_RouterRequest] = deque()
        self._sessions: Dict[str, str] = {}   # session -> replica name
        self._buckets: Dict[str, List[float]] = {}  # tenant -> [tokens, t]
        self._committed = 0                   # admitted tokens in flight
        # engine counters absorbed from crashed (discarded) engines, so
        # aggregate prefix stats survive failover
        self._eng_acc = {"prefix_hit_tokens": 0, "prefill_tokens": 0,
                         "cow_copies": 0, "spec_rounds": 0,
                         "spec_accepted_tokens": 0}
        # autoscale state (see ScalePolicy)
        self._scale_cooldown = 0
        self._scale_up_streak = 0
        self._scale_down_streak = 0
        # cross-host fabric state (None / empty outside fabric mode)
        self._fabric = cfg.fabric
        self._streams: Dict[str, Dict[str, Any]] = {}
        self._link: Optional[DcnLink] = None
        self._tier_scale = {t: {"cooldown": 0, "up": 0, "down": 0}
                            for t in ("prefill", "decode")}
        if self._fabric is not None:
            if engines is not None:
                raise ValueError(
                    "engines= injection is incompatible with a two-tier "
                    "fabric: the router builds tiered replicas itself")
            fb = self._fabric
            self._link = DcnLink(bandwidth=fb.stream.bandwidth,
                                 latency_s=fb.stream.latency_s,
                                 chaos=chaos)
            self.replicas = [
                _Replica(name=f"p{i}", engine=self._new_engine(f"p{i}"),
                         monitor=ReplicaMonitor(cfg), tier="prefill")
                for i in range(fb.prefill_replicas)] + [
                _Replica(name=f"d{i}", engine=self._new_engine(f"d{i}"),
                         monitor=ReplicaMonitor(cfg), tier="decode")
                for i in range(fb.decode_replicas)]
            self._tier_seq = {"prefill": fb.prefill_replicas,
                              "decode": fb.decode_replicas}
        else:
            if engines is not None:
                if len(engines) != cfg.num_replicas:
                    raise ValueError(
                        f"got {len(engines)} engines for "
                        f"num_replicas={cfg.num_replicas}")
                engines = list(engines)
            else:
                engines = [self._new_engine(f"r{i}")
                           for i in range(cfg.num_replicas)]
            self.replicas = [
                _Replica(name=f"r{i}", engine=eng,
                         monitor=ReplicaMonitor(cfg))
                for i, eng in enumerate(engines)]
            for rep in self.replicas:
                rep.engine._standalone_obs = False  # router retires
        self._replica_seq = cfg.num_replicas  # next fresh replica name
        # declarative SLO layer (see RouterConfig.slo)
        self.slo = SloMonitor(cfg.slo) if cfg.slo is not None else None
        self._slo_active_prev: set = set()
        self._recompute_budget()

    def _new_engine(self, name: Optional[str] = None) -> ServingEngine:
        eng = ServingEngine(self.model_cfg, self.params, self.ecfg,
                            clock=self._clock, device=self.device,
                            name=name, draft_cfg=self._draft_cfg,
                            draft_params=self._draft_params,
                            aot_cache=self._aot)
        eng._standalone_obs = False  # router owns request retirement
        return eng

    def _recompute_budget(self) -> None:
        """Global committed-token budget tracks fleet size unless pinned
        by ``global_token_budget`` — an elastic fleet's capacity is not a
        constant."""
        if self.cfg.global_token_budget is not None:
            self._budget = self.cfg.global_token_budget
            return
        total = 0
        for rep in self.replicas:
            e = rep.engine.ecfg if rep.engine is not None else self.ecfg
            total += e.num_blocks * e.block_size
        self._budget = max(1, total)

    # -- time / introspection ---------------------------------------------

    def _now(self) -> float:
        return self._clock() - self._t0

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Stop admitting; in-flight requests keep running to completion
        (failing replicas still hand off to survivors)."""
        self._draining = True

    def live_replicas(self) -> List[_Replica]:
        return [r for r in self.replicas if r.live]

    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._streams) or any(
            r.assigned for r in self.replicas)

    def _policy(self, tenant: str) -> TenantPolicy:
        return self.cfg.tenants.get(tenant, TenantPolicy())

    # -- admission ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               tenant: Optional[str] = None, uid: Optional[str] = None,
               session: Optional[str] = None,
               arrival_time: Optional[float] = None) -> str:
        """Admit or reject a request. Raises
        :class:`~.engine.RequestRejected` with a machine-readable
        ``reason`` after recording the rejection in ``results``; returns
        the uid on admission."""
        if uid is None:
            uid = f"rr{self._uid_counter}"
            self._uid_counter += 1
        tenant = tenant or self.cfg.default_tenant
        prompt = [int(t) for t in prompt]
        req = _RouterRequest(
            uid=uid, tenant=tenant, prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            arrival_time=(self._now() if arrival_time is None
                          else float(arrival_time)),
            session=session)
        self.stats.submitted += 1
        tracer = get_tracer()
        if tracer.enabled:
            # begin the request span before any admission check, so a
            # rejection still produces a complete (if short) span
            tracer.request_begin(uid, tenant=tenant)
            tracer.request_phase_begin(uid, "router_queue")
        if self._draining:
            self._reject(req, "draining", "router is draining")
        if not self._fits_any(req):
            self._reject(req, "never_fits",
                         f"{uid}: cannot fit any replica even alone")
        credit = self._prefix_credit(req)
        spec_extra = self._spec_draft_surcharge(req)
        load = (self._committed + req.total_tokens - credit
                + spec_extra) / max(1, self._budget)
        if load > 1.0:
            self._reject(req, "over_budget",
                         f"global budget: load would be {load:.2f}")
        if load >= self.cfg.shed_threshold and self._is_sheddable(tenant):
            self.stats.tenant_shed[tenant] = (
                self.stats.tenant_shed.get(tenant, 0) + 1)
            self._reject(req, "over_budget",
                         f"shedding low-priority tenant {tenant!r} at "
                         f"load {load:.2f}")
        slo_hot = self.slo is not None and self.slo.breached
        if load >= self.cfg.degrade_threshold or slo_hot:
            capped = min(req.max_new_tokens, self.cfg.degrade_max_new)
            if capped < req.max_new_tokens:
                req.max_new_tokens = capped
                req.degraded = True
                self.stats.degraded += 1
        req.charged_tokens = max(0, req.total_tokens - credit) + spec_extra
        if not self._bucket_take(tenant, req.charged_tokens):
            self._reject(req, "tenant_throttled",
                         f"tenant {tenant!r} token bucket empty")
        self._committed += req.charged_tokens
        self.stats.admitted += 1
        self._pending.append(req)
        return uid

    def _fits_any(self, req: _RouterRequest) -> bool:
        return any(r.engine is not None and r.engine.fits(
            len(req.prompt), req.max_new_tokens) for r in self.replicas)

    def _prefix_credit(self, req: _RouterRequest) -> int:
        """Prompt tokens some live replica's prefix cache already holds
        — work this request will share instead of redoing, credited
        against the global budget and the tenant bucket so prefix-heavy
        traffic is not spuriously ``over_budget``. ``never_fits`` stays
        *uncredited* on purpose: its pool/table bound is about distinct
        blocks coexisting in one pool, which sharing does not change."""
        if not getattr(self.ecfg, "prefix_sharing", False):
            return 0
        return max((rep.engine.prefix_lookup(req.prompt)
                    for rep in self.live_replicas()), default=0)

    def _fleet_speculating(self) -> bool:
        return any(rep.engine is not None and rep.engine.speculating
                   for rep in self.live_replicas())

    def _spec_accept_hat(self) -> float:
        """Fleet-wide measured mean accept length, optimistic (= k) until
        real rounds exist — optimism under-prices early traffic instead
        of spuriously shedding it before any accept-rate signal."""
        spec = self.ecfg.speculation
        rounds = self._eng_acc["spec_rounds"]
        acc = self._eng_acc["spec_accepted_tokens"]
        for rep in self.replicas:
            if rep.engine is not None:
                rounds += rep.engine.stats.spec_rounds
                acc += rep.engine.stats.spec_accepted_tokens
        if rounds <= 0:
            return float(spec.speculation_length)
        return acc / rounds

    def _spec_draft_surcharge(self, req: _RouterRequest) -> int:
        """Admission price for speculation's extra verify rows. A
        speculating fleet spends ``B*(k+1)`` packed rows to land
        ``a_hat+1`` tokens, so each landed token costs
        ``B*(k+1)/(a_hat+1)`` rows instead of 1 — charge the overage on
        the decode portion so admission sees real row pressure, not the
        optimistic one-row-per-token fiction."""
        spec = self.ecfg.speculation
        if spec is None or not self._fleet_speculating():
            return 0
        k, nb = spec.speculation_length, spec.num_branches
        overhead = nb * (k + 1) / (self._spec_accept_hat() + 1.0)
        return int(req.max_new_tokens * max(0.0, overhead - 1.0))

    def _is_sheddable(self, tenant: str) -> bool:
        """Shed tenants strictly below the highest configured priority;
        with no priority spread nobody is singled out (the hard budget
        still backstops)."""
        policies = list(self.cfg.tenants.values())
        if not policies:
            return False
        top = max(p.priority for p in policies)
        return self._policy(tenant).priority < top

    def _bucket_take(self, tenant: str, cost: int) -> bool:
        pol = self._policy(tenant)
        if math.isinf(pol.rate_tokens_per_s) and math.isinf(
                pol.burst_tokens):
            return True
        now = self._now()
        tokens, last = self._buckets.get(tenant, [pol.burst_tokens, now])
        tokens = min(pol.burst_tokens,
                     tokens + pol.rate_tokens_per_s * max(0.0, now - last))
        if tokens < cost:
            self._buckets[tenant] = [tokens, now]
            return False
        self._buckets[tenant] = [tokens - cost, now]
        return True

    def _reject(self, req: _RouterRequest, reason: str, detail: str):
        self.stats.rejected_by_reason[reason] = (
            self.stats.rejected_by_reason.get(reason, 0) + 1)
        self.results[req.uid] = RouterResult(
            uid=req.uid, tenant=req.tenant, status="rejected",
            reason=reason)
        wait = max(0.0, self._now() - req.arrival_time)
        observe_request_metrics("rejected", tenant=req.tenant,
                                queue_s=wait, e2e_s=wait)
        if self.slo is not None:
            self.slo.observe(ok=False)
        tracer = get_tracer()
        trace_id = None
        if tracer.enabled:
            trace_id = tracer.request_trace_id(req.uid)
            tracer.request_end(req.uid, outcome="rejected",
                               tenant=req.tenant, reason=reason)
        raise RequestRejected(reason, detail, trace_id=trace_id)

    # -- placement ---------------------------------------------------------

    def _score(self, rep: _Replica) -> float:
        eng = rep.engine
        occupancy = 1.0 - eng.pool_free_blocks() / max(1, eng.allocator
                                                       .num_blocks)
        return eng.queue_depth() + self.cfg.occupancy_weight * occupancy

    def _choose_replica(self, req: _RouterRequest) -> Optional[_Replica]:
        live = self.live_replicas()
        if self._fabric is not None:
            # every admission prefills on the prefill tier — including
            # torn-stream fallbacks, which then finish there colocated
            # (no_handoff) instead of re-entering the fabric. Decode
            # replicas only ever receive committed streams.
            live = [r for r in live if r.tier == "prefill"]
        if not live:
            return None
        if req.avoid_replica is not None:
            # shadow probes must land on *different* hardware than the
            # primary; with nowhere else to go they fall back (a
            # same-replica re-decode is a vacuous but harmless check)
            others = [r for r in live if r.name != req.avoid_replica]
            if others:
                live = others
        if self.cfg.affinity and req.session:
            name = self._sessions.get(req.session)
            hit = next((r for r in live if r.name == name), None)
            if hit is not None:
                return hit
        if self.cfg.placement == "prefix":
            # prefix locality: most cached prompt tokens wins, JSQ breaks
            # ties (covers the cold-start case where nobody holds it)
            return min(live, key=lambda r: (
                -r.engine.prefix_lookup(req.prompt), self._score(r),
                r.name))
        return min(live, key=lambda r: (self._score(r), r.name))

    def _place_pending(self) -> int:
        placed = 0
        now = self._now()
        tracer = get_tracer()
        for req in list(self._pending):
            if req.arrival_time > now or req.next_try > now:
                continue
            rep = self._choose_replica(req)
            if rep is None:
                continue  # all replicas down; retried after revival
            try:
                # engine-frame arrival so the engine admits it now and
                # its ttft_s measures time-from-placement
                rep.engine.submit(req.prompt, req.max_new_tokens,
                                  uid=req.uid,
                                  arrival_time=rep.engine._now())
            except RequestRejected:
                # a replica-local refusal (e.g. drained externally) is a
                # failover event for this request, not a router rejection
                rep.engine.results.pop(req.uid, None)
                self._pending.remove(req)
                if tracer.enabled:
                    # the engine-queue phase its submit opened must not
                    # keep accruing while the request waits out backoff
                    tracer.request_phase_end(req.uid, "engine_queue")
                self._requeue(req, rep, lost_generated=0)
                continue
            self._pending.remove(req)
            req.placed_at = now
            if tracer.enabled:
                tracer.request_phase_end(req.uid, "router_queue")
            rep.assigned[req.uid] = req
            if req.session:
                self._sessions[req.session] = rep.name
            placed += 1
            reg = get_registry()
            if reg.enabled:
                reg.counter("nxd_router_placed_total",
                            "Requests placed onto a replica.",
                            labels=("replica",)).labels(
                                replica=rep.name).inc()
        return placed

    # -- health + failover -------------------------------------------------

    def _requeue(self, req: _RouterRequest, rep: Optional[_Replica],
                 lost_generated: int) -> None:
        """Route a request back through pending after its replica failed
        it; bounded retries with exponential backoff."""
        tracer = get_tracer()
        if req.shadow_of is not None:
            # shadows are probes, not traffic: a probe that loses its
            # replica retries quietly and is *dropped* (never a "failed"
            # result, never counted) once retries run out
            req.attempts += 1
            if req.attempts > self.cfg.max_retries:
                if tracer.enabled:
                    tracer.request_end(req.uid, outcome="shadow")
                return
            req.next_try = self._now() + (
                self.cfg.backoff_base_s * 2 ** (req.attempts - 1))
            req.placed_at = None
            if rep is not None and req.uid in rep.assigned:
                del rep.assigned[req.uid]
            self._pending.append(req)
            return
        req.attempts += 1
        # re-done work: the prompt is re-prefilled and any generated
        # tokens are discarded (greedy regenerates them bit-identically)
        self.stats.resubmitted_tokens += len(req.prompt) + lost_generated
        if req.attempts > self.cfg.max_retries:
            self._committed -= req.charged_tokens
            self.stats.failed += 1
            self.results[req.uid] = RouterResult(
                uid=req.uid, tenant=req.tenant, status="failed",
                reason="max_retries", resubmits=req.attempts - 1)
            e2e = max(0.0, self._now() - req.arrival_time)
            observe_request_metrics("failed", tenant=req.tenant,
                                    queue_s=None, e2e_s=e2e)
            if self.slo is not None:
                self.slo.observe(ok=False)
            if tracer.enabled:
                tracer.request_end(req.uid, outcome="failed",
                                   tenant=req.tenant,
                                   reason="max_retries")
            return
        req.next_try = self._now() + (
            self.cfg.backoff_base_s * 2 ** (req.attempts - 1))
        req.placed_at = None
        self.stats.resubmits += 1
        if tracer.enabled:
            # failover is visible in the span: a zero-duration resubmit
            # marker plus a reopened router-queue wait
            tracer.request_mark(req.uid, "resubmit")
            tracer.request_phase_begin(req.uid, "router_queue")
        if rep is not None and req.uid in rep.assigned:
            del rep.assigned[req.uid]
        self._pending.append(req)

    def _fail_replica(self, rep: _Replica, why: str,
                      engine_alive: bool) -> None:
        """Trip the circuit breaker: evict/salvage in-flight requests to
        pending, mark the replica down for a probation window."""
        self.stats.failovers += 1
        self._abort_streams_to(rep, why)
        reg = get_registry()
        if reg.enabled:
            reg.counter("nxd_router_failovers_total",
                        "Circuit-breaker trips by replica and cause.",
                        labels=("replica", "reason")).labels(
                            replica=rep.name, reason=why).inc()
        for uid, req in list(rep.assigned.items()):
            lost = 0
            if engine_alive and rep.engine is not None:
                try:
                    _, generated = rep.engine.evict(uid)
                    lost = len(generated)
                except KeyError:
                    pass  # completed this very step; collected below
            self._requeue(req, None, lost_generated=lost)
        rep.assigned.clear()
        self._drop_sessions_for(rep)
        rep.state = "down"
        rep.down_steps = self.cfg.probation_steps
        rep.ok_steps = 0
        if not engine_alive:
            if rep.engine is not None:
                self._absorb_engine_stats(rep.engine)
            rep.engine = None  # crashed: the instance is gone
        rep.monitor = ReplicaMonitor(self.cfg)

    def _drop_sessions_for(self, rep: _Replica) -> None:
        """Forget session→replica pins pointing at ``rep`` (migrated
        sessions were already re-pointed at their destination)."""
        for s in [s for s, n in self._sessions.items() if n == rep.name]:
            del self._sessions[s]

    def _tick_revivals(self) -> None:
        for rep in self.replicas:
            if rep.state != "down":
                continue
            rep.down_steps -= 1
            if rep.down_steps > 0:
                continue
            if rep.engine is None:
                # the replacement engine shares the fleet's weights,
                # gets a bumped generation so its obs series don't alias
                # the dead engine's, and warm-starts its prefix trie from
                # the hottest survivor instead of coming back cold
                rep.engine = self._new_engine(rep.name)
                rep.generation += 1
                self._warm_prefix(rep)
            rep.state = "probation"
            rep.ok_steps = 0
            self.stats.revivals += 1
            reg = get_registry()
            if reg.enabled:
                reg.counter("nxd_router_revivals_total",
                            "Replicas revived into probation.",
                            labels=("replica",)).labels(
                                replica=rep.name).inc()

    # -- elasticity --------------------------------------------------------

    def _warm_prefix(self, rep: _Replica) -> None:
        """Ship up to ``warm_prefix_blocks`` hottest trie subtrees from
        the best-stocked survivor into a fresh/revived replica, KV blocks
        included — the newcomer serves prefix hits from its first step."""
        k = self.cfg.warm_prefix_blocks
        if not k or rep.engine is None:
            return
        donors = [r for r in self.live_replicas()
                  if r is not rep and r.engine.prefix_cache is not None
                  and r.engine.prefix_cache.size > 0]
        if not donors:
            return
        donor = max(donors, key=lambda r: r.engine.prefix_cache.size)
        n = rep.engine.import_prefixes(donor.engine.export_prefixes(k))
        if n:
            emit_event("router_prefix_warm", replica=rep.name,
                       donor=donor.name, nodes=n)

    def _migrate_sessions(self, rep: _Replica, why: str) -> int:
        """Drain ``rep`` by *shipping* each live session — KV blocks and
        scheduler state — to a survivor (most free pool blocks first), so
        nothing re-prefills and greedy outputs continue bit-identically.
        A session no survivor can host falls back to the failover path
        (resubmit-from-prompt), accounted in ``reprefilled_tokens``."""
        if rep.engine is None or not rep.assigned:
            return 0
        self._collect(rep)  # completions are results, not migrations
        moved = 0
        for uid, req in list(rep.assigned.items()):
            del rep.assigned[uid]
            try:
                ticket = rep.engine.export_session(uid)
            except KeyError:
                self._requeue(req, None, lost_generated=0)
                continue
            dest = None
            # same tier first (a fabric decode session belongs on the
            # decode tier), most free blocks within a tier
            for cand in sorted(
                    (r for r in self.live_replicas() if r is not rep),
                    key=lambda r: (r.tier != rep.tier,
                                   -r.engine.pool_free_blocks())):
                try:
                    cand.engine.import_session(ticket)
                    dest = cand
                    break
                except (RequestRejected, CacheExhaustedError):
                    continue
            if dest is not None:
                dest.assigned[uid] = req
                if req.session:
                    self._sessions[req.session] = dest.name
                self.stats.migrated_sessions += 1
                self.stats.migrated_tokens += ticket.n_cached
                moved += 1
            else:
                self.stats.reprefilled_tokens += min(
                    ticket.n_cached, len(ticket.prompt))
                # nobody imported the ticket, so its exported trace is
                # orphaned — re-adopt it locally before the failover
                # path resubmits, keeping the span history intact
                if ticket.trace is not None:
                    get_tracer().request_import(ticket.trace)
                self._requeue(req, None,
                              lost_generated=len(ticket.generated))
        if moved:
            emit_event("router_sessions_migrated", replica=rep.name,
                       reason=why, sessions=moved)
        return moved

    # -- cross-host fabric (streamed prefill→decode handoff) ---------------

    def _choose_decode_dest(self) -> Optional[_Replica]:
        """Least-loaded live decode replica, or None (the session then
        simply keeps decoding on its prefill replica — degradation, not
        an outage)."""
        cands = [r for r in self.live_replicas() if r.tier == "decode"]
        if not cands:
            return None
        return min(cands, key=lambda r: (self._score(r), r.name))

    def _begin_handoffs(self, rep: _Replica) -> int:
        """Export every handoff-ready session on prefill replica ``rep``
        and open a stream toward the decode tier. The transfer overlaps
        whatever the decode tier is already stepping; the request stays
        un-assigned while its bytes fly (the stream owns it)."""
        started = 0
        now = self._now()
        tracer = get_tracer()
        for uid, req in list(rep.assigned.items()):
            if req.no_handoff or req.shadow_of is not None:
                continue
            if uid in rep.engine.results \
                    or not rep.engine.handoff_ready(uid):
                continue
            dest = self._choose_decode_dest()
            if dest is None:
                continue
            ticket = rep.engine.export_session(uid)
            del rep.assigned[uid]
            if tracer.enabled and ticket.trace is not None:
                # keep the live trace here while the bytes fly, so the
                # transfer is a real phase in the request span; the
                # precommit hook folds it back into the landing ticket
                tracer.request_import(ticket.trace)
                tracer.request_phase_begin(uid, "handoff")
            route = f"{rep.name}->{dest.name}/{uid}"
            tr = KVStreamTransport(
                ticket, dest.engine, self._link, route, self._fabric.stream,
                on_precommit=_finish_handoff_trace)
            self._streams[route] = {"tr": tr, "req": req, "dest": dest,
                                    "src": rep.name}
            tr.start(now)
            started += 1
        return started

    def _abort_streams_to(self, rep: _Replica, why: str) -> None:
        """A dying/retiring replica takes its inbound streams with it;
        the terminal-state sweep in :meth:`_pump_streams` routes each
        aborted request through the re-prefill fallback."""
        for ent in self._streams.values():
            if ent["dest"] is rep and ent["tr"].state == "streaming":
                ent["tr"].abort(f"destination {rep.name}: {why}")

    def _pump_streams(self) -> int:
        """Deliver link arrivals to their streams, advance sender
        timers, and resolve terminal streams: a commit re-assigns the
        request to its decode replica; an abort re-queues it from the
        prompt with ``no_handoff`` set (availability over locality) and
        charges ``reprefilled_tokens`` + ``handoff_aborts``."""
        if self._fabric is None:
            return 0
        now = self._now()
        activity = 0
        for route, data in self._link.deliver(now):
            ent = self._streams.get(route)
            if ent is not None:
                ent["tr"].on_wire(data, now)
                activity += 1
        tracer = get_tracer()
        for route, ent in list(self._streams.items()):
            tr: KVStreamTransport = ent["tr"]
            state = tr.pump(now)
            if state == "streaming":
                continue
            del self._streams[route]
            activity += 1
            req: _RouterRequest = ent["req"]
            self.stats.handoff_retries += tr.stats.retries
            self.stats.handoff_bytes += tr.stats.wire_bytes
            self.stats.handoff_wire_payload_bytes += \
                tr.stats.wire_payload_bytes
            self.stats.handoff_fp32_payload_bytes += \
                tr.stats.fp32_payload_bytes
            if state == "committed":
                dest: _Replica = ent["dest"]
                dest.assigned[req.uid] = req
                if req.session:
                    self._sessions[req.session] = dest.name
                self.stats.handoffs += 1
                self.stats.handoff_chunks += tr.stats.chunks
                self.stats.migrated_sessions += 1
                self.stats.migrated_tokens += tr.ticket.n_cached
                continue
            # torn stream: the ticket never landed — what's left of the
            # request is its prompt. Resubmit colocated, bounded by the
            # usual retry budget; greedy re-derives the same tokens.
            self.stats.handoff_aborts += 1
            self.stats.reprefilled_tokens += min(
                tr.ticket.n_cached, len(tr.ticket.prompt))
            req.no_handoff = True
            if tracer.enabled:
                # the handoff phase opened at export is still live on
                # this side; close it before the failover machinery
                # reopens router_queue
                tracer.request_phase_end(req.uid, "handoff")
            self._requeue(req, None,
                          lost_generated=len(tr.ticket.generated))
        return activity

    def _preempt_replica(self, rep: _Replica) -> None:
        """A SIGTERM-style eviction notice (chaos ``preempt``): unlike a
        crash, the drain window lets every live session migrate out
        before the engine goes away; the replica then sits out the usual
        probation window and revives with a fresh engine."""
        self.stats.preemptions += 1
        self._abort_streams_to(rep, "preempt")
        self._migrate_sessions(rep, "preempt")
        rep.assigned.clear()
        self._drop_sessions_for(rep)
        if rep.engine is not None:
            self._absorb_engine_stats(rep.engine)
        rep.engine = None
        rep.state = "down"
        rep.down_steps = self.cfg.probation_steps
        rep.ok_steps = 0
        rep.monitor = ReplicaMonitor(self.cfg)
        emit_event("router_preempt", replica=rep.name)

    def _scale_policy(self, tier: Optional[str]) -> Optional[ScalePolicy]:
        """The policy governing ``tier`` — the fabric's per-tier policy
        when two-tier, else the fleet-wide ``cfg.scale``."""
        if self._fabric is not None and tier is not None:
            return (self._fabric.prefill_scale if tier == "prefill"
                    else self._fabric.decode_scale)
        return self.cfg.scale

    def _tier_live(self, tier: Optional[str]) -> List[_Replica]:
        live = self.live_replicas()
        if tier is None:
            return live
        return [r for r in live if r.tier == tier]

    def scale_up(self, why: str = "manual",
                 tier: Optional[str] = None) -> Optional[str]:
        """Add a replica (on the fleet's shared weights, warm-started from
        a shipped prefix trie when enabled). With a two-tier fabric, grows
        ``tier`` (prefill/decode) under that tier's policy. Returns its
        name, or None at the policy's ``max_replicas`` cap."""
        if self._fabric is not None and tier is None:
            tier = "prefill"
        pol = self._scale_policy(tier)
        if pol is not None and len(self._tier_live(tier)) >= \
                pol.max_replicas:
            return None
        if self._fabric is not None:
            name = f"{tier[0]}{self._tier_seq[tier]}"
            self._tier_seq[tier] += 1
        else:
            name = f"r{self._replica_seq}"
            self._replica_seq += 1
        rep = _Replica(name=name, engine=self._new_engine(name),
                       monitor=ReplicaMonitor(self.cfg),
                       tier=tier or "serve")
        self.replicas.append(rep)
        self._recompute_budget()
        self.stats.scale_ups += 1
        if self._fabric is not None:
            ts = self._tier_scale[tier]
            ts["cooldown"] = pol.cooldown_steps if pol else 0
            ts["up"] = ts["down"] = 0
        else:
            self._scale_cooldown = pol.cooldown_steps if pol else 0
            self._scale_up_streak = self._scale_down_streak = 0
        self._warm_prefix(rep)
        emit_event("router_scale_up", replica=name, reason=why,
                   fleet=len(self.live_replicas()),
                   warm=rep.engine.aot_warm())
        return name

    def scale_down(self, why: str = "manual",
                   tier: Optional[str] = None) -> Optional[str]:
        """Gracefully retire one replica — fewest live sessions, newest
        on ties — migrating its sessions to survivors. With a two-tier
        fabric, shrinks ``tier`` under that tier's floor. Returns the
        retired name, or None at the ``min_replicas`` floor."""
        if self._fabric is not None and tier is None:
            tier = "prefill"
        live = self._tier_live(tier)
        pol = self._scale_policy(tier)
        floor = pol.min_replicas if pol else 1
        if len(live) <= max(1, floor):
            return None
        victim = min(reversed(live), key=lambda r: len(r.assigned))
        self._abort_streams_to(victim, "scaled down")
        self._collect(victim)
        self._migrate_sessions(victim, why)
        self._drop_sessions_for(victim)
        if victim.engine is not None:
            self._absorb_engine_stats(victim.engine)
        self.replicas.remove(victim)
        self._recompute_budget()
        self.stats.scale_downs += 1
        if self._fabric is not None:
            ts = self._tier_scale[tier]
            ts["cooldown"] = pol.cooldown_steps if pol else 0
            ts["up"] = ts["down"] = 0
        else:
            self._scale_cooldown = pol.cooldown_steps if pol else 0
            self._scale_up_streak = self._scale_down_streak = 0
        emit_event("router_scale_down", replica=victim.name, reason=why,
                   fleet=len(self.live_replicas()))
        return victim.name

    def _ttft_p99(self) -> float:
        """TTFT p99 in seconds — from the obs histogram when enabled,
        else the recent completions window; 0.0 with no signal yet."""
        reg = get_registry()
        if reg.enabled:
            h = reg.get("nxd_router_ttft_seconds")
            if h is not None:
                q = h.quantile(0.99)
                if not math.isnan(q):
                    return float(q)
        if self.stats.ttft_s:
            return float(np.percentile(
                np.asarray(self.stats.ttft_s[-64:]), 99))
        return 0.0

    def _tick_autoscale(self) -> None:
        """One :class:`ScalePolicy` decision: compare the fleet's load
        signals against the thresholds, require ``hysteresis_steps`` of
        agreement, respect the cooldown. No-op without a policy or while
        draining (a draining fleet must only shrink by completion).
        With a fabric, each tier runs its own decision loop: the prefill
        tier watches the admission queue, the decode tier watches
        in-flight handoff streams plus its own occupancy."""
        if self._fabric is not None:
            if self._draining:
                return
            for tier in ("prefill", "decode"):
                self._tick_autoscale_tier(tier)
            return
        pol = self.cfg.scale
        if pol is None or self._draining:
            return
        if self._scale_cooldown > 0:
            self._scale_cooldown -= 1
            return
        live = self.live_replicas()
        if not live:
            return
        queue = (len(self._pending) + sum(
            r.engine.queue_depth() for r in live)) / len(live)
        occupancy = max(
            1.0 - r.engine.pool_free_blocks()
            / max(1, r.engine.allocator.num_blocks) for r in live)
        ttft = self._ttft_p99()
        # a sustained SLO breach is a hot signal in its own right —
        # attainment, not another raw constant, drives the fleet
        slo_hot = (self.slo is not None
                   and self.slo.last_status is not None
                   and bool(self.slo.last_status.breached))
        hot = (queue >= pol.queue_high or occupancy >= pol.occupancy_high
               or ttft >= pol.ttft_p99_high_s or slo_hot)
        cold = (queue <= pol.queue_low
                and occupancy < pol.occupancy_high
                and ttft < pol.ttft_p99_high_s and not slo_hot)
        if hot:
            self._scale_up_streak += 1
            self._scale_down_streak = 0
            if self._scale_up_streak >= pol.hysteresis_steps:
                reason = (f"obs:queue={queue:.1f}"
                          f",occ={occupancy:.2f},ttft={ttft:.3f}")
                if slo_hot:
                    reason = "slo:" + ",".join(
                        self.slo.last_status.breached)
                if self.scale_up(reason) is not None and slo_hot:
                    self.stats.slo_scale_ups += 1
        elif cold:
            self._scale_down_streak += 1
            self._scale_up_streak = 0
            if self._scale_down_streak >= pol.hysteresis_steps:
                self.scale_down(f"obs:queue={queue:.1f}"
                                f",occ={occupancy:.2f}")
        else:
            self._scale_up_streak = self._scale_down_streak = 0

    def _tick_autoscale_tier(self, tier: str) -> None:
        """One per-tier :class:`ScalePolicy` decision for the fabric.
        Streak/cooldown state lives in ``_tier_scale[tier]`` so the two
        tiers breathe independently."""
        pol = self._scale_policy(tier)
        if pol is None:
            return
        ts = self._tier_scale[tier]
        if ts["cooldown"] > 0:
            ts["cooldown"] -= 1
            return
        live = self._tier_live(tier)
        if not live:
            return
        pend = (len(self._pending) if tier == "prefill"
                else len(self._streams))
        queue = (pend + sum(
            r.engine.queue_depth() for r in live)) / len(live)
        occupancy = max(
            1.0 - r.engine.pool_free_blocks()
            / max(1, r.engine.allocator.num_blocks) for r in live)
        hot = queue >= pol.queue_high or occupancy >= pol.occupancy_high
        cold = queue <= pol.queue_low and occupancy < pol.occupancy_high
        if hot:
            ts["up"] += 1
            ts["down"] = 0
            if ts["up"] >= pol.hysteresis_steps:
                self.scale_up(f"obs:{tier}:queue={queue:.1f}"
                              f",occ={occupancy:.2f}", tier=tier)
        elif cold:
            ts["down"] += 1
            ts["up"] = 0
            if ts["down"] >= pol.hysteresis_steps:
                self.scale_down(f"obs:{tier}:queue={queue:.1f}"
                                f",occ={occupancy:.2f}", tier=tier)
        else:
            ts["up"] = ts["down"] = 0

    # -- stats -------------------------------------------------------------

    def _absorb_engine_stats(self, eng: ServingEngine) -> None:
        """Fold a to-be-discarded engine's prefix counters into the
        accumulator so crashes don't erase them from the aggregate."""
        self._eng_acc["prefix_hit_tokens"] += eng.stats.prefix_hit_tokens
        self._eng_acc["prefill_tokens"] += eng.stats.prefill_tokens
        self._eng_acc["cow_copies"] += eng.stats.cow_copies
        self._eng_acc["spec_rounds"] += eng.stats.spec_rounds
        self._eng_acc["spec_accepted_tokens"] += (
            eng.stats.spec_accepted_tokens)

    def engine_aggregate(self) -> Dict[str, float]:
        """Prefix-sharing and speculation metrics aggregated across
        replicas (live engines plus counters absorbed from crashed
        ones)."""
        hit = self._eng_acc["prefix_hit_tokens"]
        pre = self._eng_acc["prefill_tokens"]
        cow = self._eng_acc["cow_copies"]
        rounds = self._eng_acc["spec_rounds"]
        acc = self._eng_acc["spec_accepted_tokens"]
        fracs: List[float] = []
        for rep in self.replicas:
            if rep.engine is None:
                continue
            s = rep.engine.stats
            hit += s.prefix_hit_tokens
            pre += s.prefill_tokens
            cow += s.cow_copies
            rounds += s.spec_rounds
            acc += s.spec_accepted_tokens
            fracs.extend(s.shared_fraction)
        return {
            "prefix_hit_rate": hit / max(1, hit + pre),
            "shared_block_fraction": (float(np.mean(fracs))
                                      if fracs else 0.0),
            "cow_copies": cow,
            "spec_rounds": rounds,
            "spec_accepted_tokens": acc,
            "spec_accept_mean": acc / max(1, rounds),
        }

    def stats_dict(self) -> Dict[str, Any]:
        """:meth:`RouterStats.to_dict` plus the cross-replica prefix
        aggregate."""
        d = self.stats.to_dict()
        d.update(self.engine_aggregate())
        return d

    # -- stepping ----------------------------------------------------------

    def _collect(self, rep: _Replica) -> None:
        eng = rep.engine
        now = self._now()
        tracer = get_tracer()
        for uid in [u for u in rep.assigned if u in eng.results]:
            req = rep.assigned.pop(uid)
            res = eng.results.pop(uid)
            if req.shadow_of is not None:
                if tracer.enabled:
                    tracer.request_end(uid, outcome="shadow",
                                       replica=rep.name)
                self._resolve_shadow(rep, req, list(res.tokens))
                continue
            self._committed -= req.charged_tokens
            self.stats.completed += 1
            ttft = None
            if res.ttft_s is not None and req.placed_at is not None:
                ttft = (req.placed_at - req.arrival_time) + res.ttft_s
                self.stats.ttft_s.append(ttft)
                reg = get_registry()
                if reg.enabled:
                    reg.histogram(
                        "nxd_router_ttft_seconds",
                        "End-to-end TTFT (router arrival to first "
                        "token) — the autoscaler's latency signal."
                    ).observe(ttft)
            # a request that survived a failover retires as
            # "resubmitted" so the latency SLO can see recovery cost
            outcome = "resubmitted" if req.attempts > 0 else "completed"
            observe_request_metrics(
                outcome, tenant=req.tenant, replica=rep.name,
                ttft_s=ttft, tpot_s=res.tpot_s,
                queue_s=(req.placed_at - req.arrival_time
                         if req.placed_at is not None else None),
                e2e_s=max(0.0, now - req.arrival_time))
            if self.slo is not None:
                self.slo.observe(ttft_s=ttft, tpot_s=res.tpot_s, ok=True)
            if tracer.enabled:
                tracer.request_end(uid, outcome=outcome,
                                   tenant=req.tenant, replica=rep.name,
                                   tokens=len(res.tokens),
                                   resubmits=req.attempts)
            self.results[uid] = RouterResult(
                uid=uid, tenant=req.tenant, status="completed",
                tokens=list(res.tokens), replica=rep.name,
                resubmits=req.attempts, ttft_s=ttft,
                degraded=req.degraded)
            if (self.cfg.integrity_shadow_every > 0
                    and (self.stats.completed - 1)
                    % self.cfg.integrity_shadow_every == 0):
                self._spawn_shadow(req, rep)

    # -- SDC shadow spot checks --------------------------------------------

    def _spawn_shadow(self, req: _RouterRequest, rep: _Replica) -> None:
        """Launch a shadow re-decode of a just-completed request on a
        different replica. Greedy decoding is deterministic, so the
        shadow's tokens must equal the primary's bit-for-bit; divergence
        means one of the two replicas silently corrupted data. Shadows
        bypass admission entirely — not submitted, not admitted, not
        budget-charged — so availability and TTFT stats describe real
        traffic only."""
        shadow = _RouterRequest(
            uid=f"{req.uid}::shadow", tenant=req.tenant,
            prompt=list(req.prompt),
            max_new_tokens=req.max_new_tokens,
            arrival_time=self._now(), shadow_of=req.uid,
            avoid_replica=rep.name,
            expect_tokens=list(self.results[req.uid].tokens))
        self.stats.integrity_shadows += 1
        self._pending.append(shadow)

    def _resolve_shadow(self, rep: _Replica, req: _RouterRequest,
                        tokens: List[int]) -> None:
        """A shadow completed on ``rep``: compare against the primary's
        recorded tokens. On divergence, trust the shadow (it ran on
        hardware the breaker considers healthy *and* re-derived the
        tokens from the prompt alone): overwrite the served result and
        quarantine the primary replica through the circuit breaker —
        the same down→probation→revive path a crash takes, so the
        suspect hardware re-enters service only after clean steps."""
        if tokens == (req.expect_tokens or []):
            return
        self.stats.integrity_mismatches += 1
        reg = get_registry()
        if reg.enabled:
            reg.counter("nxd_integrity_mismatch_total",
                        "Integrity fingerprint mismatches detected",
                        labels=("scope",)).labels(scope="decode").inc()
        emit_event("integrity_mismatch", scope="decode",
                   uid=req.shadow_of, primary=req.avoid_replica,
                   shadow=rep.name)
        prior = self.results.get(req.shadow_of)
        if prior is not None:
            prior.tokens = list(tokens)
            prior.replica = rep.name
        primary = next((r for r in self.replicas
                        if r.name == req.avoid_replica), None)
        if primary is not None and primary is not rep and primary.live:
            self._fail_replica(primary, "integrity_mismatch",
                               engine_alive=False)

    def _apply_bitflip(self, rep: _Replica) -> None:
        """Chaos ``bitflip`` armed on a serving replica: corrupt one
        generated token of its next completed (non-shadow) result —
        modeling SDC on the decode/readback path. The request still
        completes, availability is unharmed, and nothing crashes: only
        the shadow spot-check can notice the wrong bytes."""
        eng = rep.engine
        for uid, res in eng.results.items():
            r = rep.assigned.get(uid)
            if r is None or r.shadow_of is not None or not res.tokens:
                continue
            res.tokens = list(res.tokens)
            res.tokens[-1] = int(res.tokens[-1]) ^ (
                1 << (rep.corrupt_bit % 4))
            rep.corrupt_bit = None
            emit_event("chaos_bitflip", scope="decode",
                       replica=rep.name, uid=uid)
            return

    def step(self) -> int:
        """One router step: check the preemption guard, tick revivals,
        place pending requests, then step every live replica under chaos
        consultation and health monitoring. Returns placed + stepped
        activity (0 = nothing was runnable now)."""
        if self._guard is not None and self._guard.requested:
            self._draining = True
        self._tick_revivals()
        if self._chaos is not None and not self._draining:
            burst, _ = self._chaos.consult("scale", "fleet")
            if burst == "scale_burst":
                self.scale_up("chaos_burst",
                              tier=("prefill" if self._fabric is not None
                                    else None))
        with get_tracer().span("router/place"):
            activity = self._place_pending()
        for rep in list(self.replicas):
            if not rep.live or not rep.assigned:
                continue
            directive, extra_latency, detail = (
                self._chaos.consult_detail("step", rep.name)
                if self._chaos is not None else (None, 0.0, {}))
            if directive == "crash":
                self._fail_replica(rep, "crash", engine_alive=False)
                continue
            if directive == "preempt":
                self._preempt_replica(rep)
                continue
            if directive == "bitflip":
                rep.corrupt_bit = int(detail.get("bit", 0))
            exhausted = directive == "exhaust"
            rows = 0
            try:
                rows = rep.engine.step()
            except CacheExhaustedError:
                # nothing left to preempt: a real storm, count it
                exhausted = True
            activity += rows
            if rep.corrupt_bit is not None:
                self._apply_bitflip(rep)
            latency = (rep.engine.stats.step_latency_s[-1]
                       if rows and rep.engine.stats.step_latency_s
                       else 0.0) + extra_latency
            self._collect(rep)   # completions survive a same-step trip
            verdict = rep.monitor.observe_step(latency,
                                               exhausted=exhausted)
            if verdict is not None:
                self._fail_replica(rep, verdict, engine_alive=True)
                continue
            if rep.state == "probation":
                rep.ok_steps += 1
                if rep.ok_steps >= self.cfg.probation_ok_steps:
                    rep.state = "up"
        if self._fabric is not None:
            activity += self._pump_streams()
            for rep in list(self.replicas):
                if rep.live and rep.tier == "prefill" and rep.assigned:
                    activity += self._begin_handoffs(rep)
        if self.slo is not None:
            live_frac = (len(self.live_replicas())
                         / max(1, len(self.replicas)))
            status = self.slo.evaluate(availability=live_frac)
            newly = set(status.breached) - self._slo_active_prev
            self.stats.slo_breaches += len(newly)
            self._slo_active_prev = set(status.breached)
            spec = self.ecfg.speculation
            if spec is not None and spec.slo_adaptive:
                # auto-toggle: speculation burns ~B*(k+1) rows per landed
                # token, so keep it OFF while TPOT is comfortable and
                # switch it ON only when the decode objective is in
                # sustained breach (host-only flip: no recompile)
                want = "tpot_p99_s" in status.breached
                for rep in self.live_replicas():
                    eng = rep.engine
                    if eng is not None and eng.speculating != want:
                        eng.set_speculation(want)
                        self.stats.spec_toggles += 1
                        emit_event("spec_toggle", scope="router",
                                   replica=rep.name, on=want)
        self._tick_autoscale()
        self.stats.steps += 1
        self._publish_obs()
        return activity

    _BREAKER_STATES = {"up": 0.0, "probation": 1.0, "down": 2.0}

    def _publish_obs(self) -> None:
        """Bridge breaker state and :class:`RouterStats` into gauges.
        One bool check when obs is disabled."""
        reg = get_registry()
        if not reg.enabled:
            return
        breaker = reg.gauge(
            "nxd_router_replica_state",
            "Circuit-breaker state per replica (0=up, 1=probation, "
            "2=down).", labels=("replica",))
        for rep in self.replicas:
            breaker.labels(replica=rep.name).set(
                self._BREAKER_STATES.get(rep.state, 2.0))
        gauges = reg.gauge(
            "nxd_router_stats",
            "RouterStats.to_dict() scalar fields bridged per step.",
            labels=("field",))
        for k, v in self.stats.to_dict().items():
            if isinstance(v, (int, float)):
                gauges.labels(field=k).set(float(v))
        reg.gauge("nxd_router_pending",
                  "Requests waiting for placement.").set(len(self._pending))
        reg.gauge("nxd_router_fleet_size",
                  "Live replicas (elastic fleet).").set(
                      len(self.live_replicas()))
        eng_g = reg.gauge(
            "nxd_router_replica_engine",
            "Per-replica engine signals, keyed by revival generation so "
            "series from a replaced engine never alias its predecessor's.",
            labels=("replica", "generation", "field"))
        for rep in self.live_replicas():
            gen = str(rep.generation)
            eng_g.labels(replica=rep.name, generation=gen,
                         field="queue_depth").set(
                             rep.engine.queue_depth())
            eng_g.labels(replica=rep.name, generation=gen,
                         field="pool_free_blocks").set(
                             rep.engine.pool_free_blocks())

    def _idle_gap(self) -> float:
        """Seconds until the next externally-scheduled event (a pending
        arrival/backoff, a link delivery, or a stream's retransmit/ACK
        timer). 0.0 when something is due now or nothing is scheduled."""
        now = self._now()
        gaps = [max(r.arrival_time, r.next_try) - now
                for r in self._pending]
        if self._link is not None:
            nxt = self._link.next_deliver()
            if nxt is not None:
                gaps.append(nxt - now)
        for ent in self._streams.values():
            t = ent["tr"].next_timer()
            if t is not None:
                gaps.append(t - now)
        gaps = [g for g in gaps if g > 0]
        return min(gaps) if gaps else 0.0

    def run(self) -> Dict[str, RouterResult]:
        """Drive :meth:`step` until every admitted request resolves.
        With a fake clock, waits (future arrivals, backoff, in-flight
        handoff bytes) fast-forward; with the real clock they sleep.
        Raises :class:`ServingPreempted` (exit 75) if a drain was
        requested and has completed."""
        while self.has_work():
            if self.step() == 0 and self.has_work():
                gap = self._idle_gap()
                if gap > 0:
                    if self._clock is not time.monotonic:
                        self._t0 -= gap  # fake clock: fast-forward
                    else:
                        time.sleep(min(gap, 0.05))
        if self._draining and self._guard is not None:
            raise ServingPreempted(self.results, self.stats)
        return self.results




def _drill_prompts(model_cfg, n_requests: int, prompt_len: int,
                   seed: int):
    """The drills' random prompts, and the generator that made them (the
    arrival times come next from it)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, model_cfg.vocab_size, (prompt_len,)).tolist()
            for _ in range(n_requests)], rng


def _greedy_match(results: Dict[str, RouterResult],
                  ref_results: Dict[str, RouterResult]) -> bool:
    """Every completed request's tokens equal the reference run's."""
    return all(
        results[uid].tokens == ref_results[uid].tokens
        for uid in ref_results
        if results.get(uid) is not None
        and results[uid].status == "completed")


def _drive_charged(router: ReplicaRouter, idle_gap,
                   after_step: Optional[Callable[[], None]] = None) -> None:
    """Run ``router`` to completion as the elastic and fabric drills do:
    under a fake clock every step that did work is charged a nominal 50 ms
    of virtual time (so later arrivals and the streams' timers interleave
    with in-flight steps), then ``after_step`` runs; idle waits
    fast-forward a fake clock and sleep (at most 50 ms at a time) on the
    real one."""
    while router.has_work():
        stepped = router.step()
        if router._clock is not time.monotonic and stepped:
            router._t0 -= 0.05
        if after_step is not None:
            after_step()
        if stepped == 0 and router.has_work():
            gap = idle_gap(router)
            if gap > 0:
                if router._clock is not time.monotonic:
                    router._t0 -= gap  # fake clock: fast-forward
                else:
                    time.sleep(min(gap, 0.05))


def chaos_drill(model_cfg, params, engine_cfg: EngineConfig,
                *, n_requests: int = 6, prompt_len: int = 6,
                max_new_tokens: int = 4,
                plan_spec: str = "step|r1 : crash, after=3, times=1",
                num_replicas: int = 2,
                clock: Optional[Callable[[], float]] = None,
                seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Deterministic failover drill.

    Runs the same request set twice — fault-free on one replica, then on
    ``num_replicas`` replicas under ``plan_spec`` — and reports
    availability, failover counts, resubmitted-token cost, chaos TTFT,
    and whether every completed output equals the fault-free run's
    (greedy decoding makes failover invisible in the tokens).
    """
    prompts, _ = _drill_prompts(model_cfg, n_requests, prompt_len, seed)
    model_cfg, params = shared_serving_weights(model_cfg, params,
                                               engine_cfg, device)

    def _run(n_rep: int, chaos: Optional[FaultPlan]):
        router = ReplicaRouter(
            model_cfg, params, engine_cfg,
            RouterConfig(num_replicas=n_rep),
            clock=clock, chaos=chaos, device=device)
        for i, p in enumerate(prompts):
            router.submit(p, max_new_tokens, uid=f"req{i}")
        return router.run(), router.stats

    ref_results, _ = _run(1, None)
    chaos_results, stats = _run(num_replicas,
                                FaultPlan.parse(plan_spec))
    completed = [r for r in chaos_results.values()
                 if r.status == "completed"]
    d = stats.to_dict()
    return {
        "router_availability": d["availability"],
        "router_failovers": d["failovers"],
        "router_resubmits": d["resubmits"],
        "router_resubmitted_tokens": d["resubmitted_tokens"],
        "router_revivals": d["revivals"],
        "router_completed": len(completed),
        "router_admitted": d["admitted"],
        "router_ttft_p99_ms_chaos": d["ttft_p99_ms"],
        "router_greedy_match_ref": float(_greedy_match(chaos_results,
                                                       ref_results)),
    }


def sdc_serving_drill(model_cfg, params, engine_cfg: EngineConfig,
                      *, n_requests: int = 6, prompt_len: int = 6,
                      max_new_tokens: int = 4,
                      plan_spec: str = ("step|r0 : bitflip, after=2, "
                                        "times=1"),
                      num_replicas: int = 2,
                      clock: Optional[Callable[[], float]] = None,
                      seed: int = 0,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Deterministic silent-data-corruption drill for serving.

    A chaos ``bitflip`` corrupts one generated token on a replica; the
    request completes, so nothing in the crash/latency machinery can see
    it. With ``integrity_shadow_every=1`` every completion is re-decoded on
    a different replica; the divergence is detected, the corrupted result
    is replaced with the shadow's tokens, and the primary is quarantined
    through the circuit breaker. Reports availability, shadow / mismatch /
    quarantine counts, and whether every served output equals a
    fault-free single-replica reference."""
    prompts, _ = _drill_prompts(model_cfg, n_requests, prompt_len, seed)
    model_cfg, params = shared_serving_weights(model_cfg, params,
                                               engine_cfg, device)

    def _run(n_rep: int, chaos: Optional[FaultPlan], shadow_every: int):
        router = ReplicaRouter(
            model_cfg, params, engine_cfg,
            RouterConfig(num_replicas=n_rep,
                         integrity_shadow_every=shadow_every),
            clock=clock, chaos=chaos, device=device)
        for i, p in enumerate(prompts):
            router.submit(p, max_new_tokens, uid=f"req{i}")
        results = router.run()
        max_cc = max((r.engine.compile_count() for r in router.replicas
                      if r.engine is not None), default=0)
        return results, router.stats, max_cc

    ref_results, _, _ = _run(1, None, 0)
    sdc_results, stats, max_cc = _run(num_replicas,
                                      FaultPlan.parse(plan_spec), 1)
    d = stats.to_dict()
    return {
        "sdc_serving_availability": d["availability"],
        "sdc_serving_completed": d["completed"],
        "sdc_serving_shadows": d["integrity_shadows"],
        "sdc_serving_mismatches": d["integrity_mismatches"],
        "sdc_serving_quarantines": d["failovers"],
        "sdc_serving_revivals": d["revivals"],
        "sdc_serving_greedy_match_ref": float(_greedy_match(sdc_results,
                                                            ref_results)),
        "sdc_serving_max_compile_count": int(max_cc),
    }


def elastic_chaos_drill(model_cfg, params, engine_cfg: EngineConfig,
                        *, n_requests: int = 8, prompt_len: int = 8,
                        max_new_tokens: int = 4,
                        clock: Optional[Callable[[], float]] = None,
                        seed: int = 0,
                        cache_dir: Optional[str] = None,
                        scale_down_step: int = 8,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """Deterministic elastic-fleet drill: the full scale cycle under
    ragged-Poisson load.

    Runs the request set fault-free on one replica for reference, then on
    a 2-replica elastic fleet where chaos preempts ``r1`` mid-flight
    (sessions migrate out), a ``scale_burst`` directive forces a scale-up,
    a scripted ``scale_down`` retires a replica by migration, and the
    preempted replica revives. Reports availability, migration vs
    re-prefill token accounting, replica spin-up cold (the first engine
    captures its workers into the shared executable cache) against warm
    (the second leases them), the cache's hits and misses, compile counts,
    and whether every completed output equals the reference's. Every
    engine of the drill serves through the cache. With a ``cache_dir``
    the warm probe uses a fresh cache over that directory, as the
    reference's does: a captured graph is not written to disk, so that
    probe misses and captures."""
    prompts, rng = _drill_prompts(model_cfg, n_requests, prompt_len, seed)
    arrivals = np.cumsum(rng.exponential(0.02, n_requests))
    model_cfg, params = shared_serving_weights(model_cfg, params,
                                               engine_cfg, device)
    aot = AotExecutableCache(cache_dir)

    t0 = time.perf_counter()
    ServingEngine(model_cfg, params, engine_cfg, clock=clock, device=device,
                  aot_cache=aot, name="cold-probe")
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_cache = AotExecutableCache(cache_dir) if cache_dir else aot
    t0 = time.perf_counter()
    warm_probe = ServingEngine(model_cfg, params, engine_cfg, clock=clock,
                               device=device, aot_cache=warm_cache,
                               name="warm-probe")
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_loaded = warm_probe.aot_warm()
    del warm_probe

    def _submit_all(router: ReplicaRouter) -> None:
        for i, (p, at) in enumerate(zip(prompts, arrivals)):
            router.submit(p, max_new_tokens, uid=f"req{i}",
                          arrival_time=float(at))

    # pin the admission budget to the drill's total demand so admission
    # is identical between the 1-replica reference and the elastic fleet
    # (the drill measures migration/scaling, not shedding)
    budget = n_requests * (prompt_len + max_new_tokens)
    ref = ReplicaRouter(model_cfg, params, engine_cfg,
                        RouterConfig(num_replicas=1,
                                     global_token_budget=budget),
                        clock=clock, device=device, aot_cache=aot)
    _submit_all(ref)
    ref_results = ref.run()
    del ref

    plan = FaultPlan.parse(
        "step|r1 : preempt, after=2, times=1 ; "
        "scale|fleet : scale_burst, after=5, times=1")
    # a deliberately unmeetable TTFT target plus a full-fleet availability
    # target: the preemption window and the charged step latency each push
    # an objective into sustained breach, so the drill exercises
    # slo_breach emission and the SLO-hot autoscale path
    slo = SloPolicy(name="drill", ttft_p99_s=1e-4, availability=1.0,
                    min_samples=2, breach_patience=2, window=64)
    router = ReplicaRouter(
        model_cfg, params, engine_cfg,
        RouterConfig(num_replicas=2, global_token_budget=budget,
                     scale=ScalePolicy(min_replicas=1, max_replicas=3,
                                       hysteresis_steps=2,
                                       cooldown_steps=2),
                     slo=slo),
        clock=clock, chaos=plan, device=device, aot_cache=aot)
    _submit_all(router)

    def _arrival_gap(r: ReplicaRouter) -> float:
        gaps = [max(q.arrival_time, q.next_try) - r._now()
                for q in r._pending]
        return min(gaps) if gaps else 0.0

    scaled_down = []

    def _scripted_scale_down() -> None:
        if (not scaled_down and router.stats.steps >= scale_down_step
                and len(router.live_replicas()) >= 2):
            router.scale_down("drill")
            scaled_down.append(True)

    _drive_charged(router, _arrival_gap, _scripted_scale_down)
    results = router.results

    completed = [r for r in results.values() if r.status == "completed"]
    compile_counts = [rep.engine.compile_count()
                      for rep in router.replicas
                      if rep.engine is not None]
    d = router.stats.to_dict()
    return {
        "elastic_availability": d["availability"],
        "elastic_greedy_match_ref": float(_greedy_match(results,
                                                        ref_results)),
        "elastic_completed": len(completed),
        "elastic_admitted": d["admitted"],
        "elastic_preemptions": d["preemptions"],
        "elastic_scale_ups": d["scale_ups"],
        "elastic_scale_downs": d["scale_downs"],
        "elastic_revivals": d["revivals"],
        "elastic_slo_breaches": d["slo_breaches"],
        "elastic_slo_scale_ups": d["slo_scale_ups"],
        "migrated_sessions": d["migrated_sessions"],
        "migrated_tokens": d["migrated_tokens"],
        "reprefilled_tokens": d["reprefilled_tokens"],
        "bundle_cold_start_ms": cold_ms,
        "bundle_cold_start_warm_ms": warm_ms,
        "bundle_cold_start_speedup": cold_ms / max(warm_ms, 1e-9),
        "aot_warm_loaded": float(warm_loaded),
        "aot_cache_hits": aot.hits,
        "aot_cache_misses": aot.misses,
        "max_compile_count": max(compile_counts, default=0),
    }


def fabric_chaos_drill(model_cfg, params, engine_cfg: EngineConfig,
                       *, n_requests: int = 6, prompt_len: int = 8,
                       max_new_tokens: int = 5,
                       plan_spec: str = "",
                       stream: Optional[StreamConfig] = None,
                       clock: Optional[Callable[[], float]] = None,
                       seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """Deterministic two-host fabric drill: disaggregated prefill→decode
    serving with the KV handoff streamed over a (faulty) link.

    Runs the request set fault-free on one colocated replica for
    reference, then on a 1-prefill + 1-decode fabric where ``plan_spec``
    drives the link's fault surface (``link_drop`` / ``link_corrupt`` /
    ``link_delay`` / ``link_partition``). Reports availability, handoff
    wire accounting (bytes, retries, compression ratio vs fp32), the
    re-prefill cost of torn streams, per-tier compile counts, whether
    every completed output equals the reference's, and the pool-leak
    check: every allocator must be empty when the drill drains."""
    prompts, rng = _drill_prompts(model_cfg, n_requests, prompt_len, seed)
    arrivals = np.cumsum(rng.exponential(0.02, n_requests))
    budget = n_requests * (prompt_len + max_new_tokens)
    model_cfg, params = shared_serving_weights(model_cfg, params,
                                               engine_cfg, device)

    def _submit_all(router: ReplicaRouter) -> None:
        for i, (p, at) in enumerate(zip(prompts, arrivals)):
            router.submit(p, max_new_tokens, uid=f"req{i}",
                          arrival_time=float(at))

    ref = ReplicaRouter(model_cfg, params, engine_cfg,
                        RouterConfig(num_replicas=1,
                                     global_token_budget=budget),
                        clock=clock, device=device)
    _submit_all(ref)
    ref_results = ref.run()
    del ref

    # a slow narrow link so multi-step overlap is real under the fake
    # clock: ~10 chunks take tens of virtual milliseconds to fly while
    # the decode tier keeps stepping
    scfg = stream or StreamConfig(bandwidth=50e3, latency_s=1e-3)
    chaos = FaultPlan.parse(plan_spec) if plan_spec else None
    router = ReplicaRouter(
        model_cfg, params, engine_cfg,
        RouterConfig(fabric=FabricConfig(prefill_replicas=1,
                                         decode_replicas=1,
                                         stream=scfg),
                     global_token_budget=budget),
        clock=clock, chaos=chaos, device=device)
    _submit_all(router)
    _drive_charged(router, ReplicaRouter._idle_gap)
    results = router.results

    completed = [r for r in results.values() if r.status == "completed"]
    tier_compiles = {"prefill": 0, "decode": 0}
    leaked = 0
    for rep in router.replicas:
        if rep.engine is None:
            continue
        tier_compiles[rep.tier] = max(tier_compiles.get(rep.tier, 0),
                                      rep.engine.compile_count())
        leaked += rep.engine.allocator.num_allocated
    d = router.stats.to_dict()
    return {
        "fabric_availability": d["availability"],
        "fabric_greedy_match_ref": float(_greedy_match(results,
                                                       ref_results)),
        "fabric_completed": len(completed),
        "fabric_admitted": d["admitted"],
        "handoffs": d["handoffs"],
        "handoff_aborts": d["handoff_aborts"],
        "handoff_chunks": d["handoff_chunks"],
        "handoff_retries": d["handoff_retries"],
        "handoff_bytes": d["handoff_bytes"],
        "handoff_wire_ratio": d["handoff_wire_ratio"],
        "migrated_tokens": d["migrated_tokens"],
        "reprefilled_tokens": d["reprefilled_tokens"],
        "ttft_p99_ms_handoff": d["ttft_p99_ms"],
        "prefill_compile_count": tier_compiles["prefill"],
        "decode_compile_count": tier_compiles["decode"],
        "pool_leak_blocks": leaked,
    }
