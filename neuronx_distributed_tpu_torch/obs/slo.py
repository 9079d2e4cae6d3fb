"""Declarative SLOs evaluated from the metrics registry (counterpart of
``neuronx_distributed_tpu/obs/slo.py``).

A declarative :class:`SloPolicy` — TTFT p99, TPOT p99, availability and
error-rate targets over sliding windows — and a :class:`SloMonitor` that a
router evaluates once per step:

* measured values come from the per-request histograms
  (``nxd_request_ttft_seconds`` / ``nxd_request_tpot_seconds``) when the
  registry is enabled, else from the monitor's own sliding windows fed
  by ``observe(...)`` — SLO enforcement works with metrics export off;
* every evaluation publishes ``nxd_slo_compliance{policy,objective}``
  gauges (1 = within target, 0 = breached);
* an objective that stays breached for ``breach_patience`` consecutive
  evaluations emits one typed ``slo_breach`` event (and ``slo_recovered``
  on exit), so alerting fires on sustained violation, not noise.

The port has no router yet; the monitor is fed by its caller. Stdlib-only
and host-side, like the rest of ``obs``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .events import emit_event
from .metrics import MetricsRegistry, get_registry

#: objectives a policy can target; "lower is better" unless noted.
OBJECTIVES = ("ttft_p99_s", "tpot_p99_s", "availability", "error_rate")


def _p99(samples: List[float]) -> float:
    """Nearest-rank p99 (NaN if empty) — matches the registry histograms."""
    if not samples:
        return math.nan
    data = sorted(samples)
    idx = max(0, min(len(data) - 1, int(math.ceil(0.99 * len(data))) - 1))
    return data[idx]


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Targets for one serving class. ``inf``/``0``/``1`` defaults leave
    an objective un-targeted, so a policy only pays for what it states.

    ``availability`` is the live fraction of the replica fleet (fed by
    the router), ``error_rate`` the failed+rejected fraction of retired
    requests over the sliding window.
    """

    name: str = "default"
    ttft_p99_s: float = math.inf      # breach when measured > target
    tpot_p99_s: float = math.inf      # breach when measured > target
    availability: float = 0.0         # breach when measured < target
    error_rate: float = 1.0           # breach when measured > target
    window: int = 256                 # sliding window (samples)
    min_samples: int = 8              # below this, never judge latency
    breach_patience: int = 3          # consecutive evals before the event

    def targeted(self) -> Tuple[str, ...]:
        out = []
        if math.isfinite(self.ttft_p99_s):
            out.append("ttft_p99_s")
        if math.isfinite(self.tpot_p99_s):
            out.append("tpot_p99_s")
        if self.availability > 0.0:
            out.append("availability")
        if self.error_rate < 1.0:
            out.append("error_rate")
        return tuple(out)

    def target_of(self, objective: str) -> float:
        return float(getattr(self, objective))


@dataclasses.dataclass(frozen=True)
class SloStatus:
    """One evaluation: measured values vs targets plus active breaches."""

    compliant: bool
    breached: Tuple[str, ...]          # active (patience-filtered)
    measured: Dict[str, float]
    targets: Dict[str, float]
    samples: int

    def attainment(self, objective: str) -> float:
        """1.0 when within target; degrades proportionally past it."""
        m = self.measured.get(objective, math.nan)
        t = self.targets.get(objective, math.nan)
        if not (math.isfinite(m) and math.isfinite(t)):
            return 1.0
        if objective == "availability":
            return min(1.0, m / t) if t > 0 else 1.0
        if m <= t:
            return 1.0
        return t / m if m > 0 else 0.0


class SloMonitor:
    """Evaluates one :class:`SloPolicy` against measured behaviour.

    The router calls :meth:`observe` as requests retire and
    :meth:`evaluate` once per step; everything is host-side and costs a
    couple of deque appends per request.
    """

    def __init__(self, policy: SloPolicy,
                 registry: Optional[MetricsRegistry] = None):
        self.policy = policy
        self._registry = registry
        self._lock = threading.Lock()
        w = max(1, policy.window)
        self._ttft: Deque[float] = deque(maxlen=w)
        self._tpot: Deque[float] = deque(maxlen=w)
        self._ok: Deque[int] = deque(maxlen=w)
        self._streak: Dict[str, int] = {}
        self._active: set = set()
        self.last_status: Optional[SloStatus] = None

    # -- feed ---------------------------------------------------------
    def observe(self, ttft_s: Optional[float] = None,
                tpot_s: Optional[float] = None,
                ok: Optional[bool] = None) -> None:
        with self._lock:
            if ttft_s is not None:
                self._ttft.append(float(ttft_s))
            if tpot_s is not None:
                self._tpot.append(float(tpot_s))
            if ok is not None:
                self._ok.append(1 if ok else 0)

    # -- registry-backed measurement ---------------------------------
    def _hist_p99(self, name: str) -> Tuple[float, int]:
        reg = self._registry if self._registry is not None \
            else get_registry()
        if not reg.enabled:
            return math.nan, 0
        metric = reg.get(name)
        if metric is None or metric.kind != "histogram":
            return math.nan, 0
        pooled: List[float] = []
        for child in metric.children():
            pooled.extend(child.samples())
        return _p99(pooled), len(pooled)

    def _measure(self, availability: Optional[float]) -> Tuple[
            Dict[str, float], int]:
        pol = self.policy
        with self._lock:
            win_ttft = list(self._ttft)
            win_tpot = list(self._tpot)
            win_ok = list(self._ok)
        measured: Dict[str, float] = {}
        n_samples = len(win_ok)
        if "ttft_p99_s" in pol.targeted():
            v, n = self._hist_p99("nxd_request_ttft_seconds")
            if n < pol.min_samples:
                v, n = _p99(win_ttft), len(win_ttft)
            measured["ttft_p99_s"] = v if n >= pol.min_samples else math.nan
            n_samples = max(n_samples, n)
        if "tpot_p99_s" in pol.targeted():
            v, n = self._hist_p99("nxd_request_tpot_seconds")
            if n < pol.min_samples:
                v, n = _p99(win_tpot), len(win_tpot)
            measured["tpot_p99_s"] = v if n >= pol.min_samples else math.nan
            n_samples = max(n_samples, n)
        if "availability" in pol.targeted() and availability is not None:
            measured["availability"] = float(availability)
        if "error_rate" in pol.targeted() and win_ok:
            measured["error_rate"] = 1.0 - sum(win_ok) / len(win_ok)
        return measured, n_samples

    # -- evaluation ---------------------------------------------------
    def evaluate(self, availability: Optional[float] = None) -> SloStatus:
        """One evaluation step: refresh gauges, track breach streaks,
        emit ``slo_breach`` / ``slo_recovered`` on transitions."""
        pol = self.policy
        measured, n_samples = self._measure(availability)
        targets = {obj: pol.target_of(obj) for obj in pol.targeted()}
        breaching_now = []
        for obj, target in targets.items():
            m = measured.get(obj, math.nan)
            if not math.isfinite(m):
                continue
            bad = m < target if obj == "availability" else m > target
            if bad:
                breaching_now.append(obj)
        with self._lock:
            for obj in targets:
                if obj in breaching_now:
                    self._streak[obj] = self._streak.get(obj, 0) + 1
                else:
                    self._streak[obj] = 0
            newly_active = [
                obj for obj in breaching_now
                if self._streak[obj] >= pol.breach_patience
                and obj not in self._active]
            recovered = [obj for obj in sorted(self._active)
                         if obj not in breaching_now]
            self._active.update(newly_active)
            self._active.difference_update(recovered)
            active = tuple(sorted(self._active))
        for obj in newly_active:
            emit_event("slo_breach", policy=pol.name, objective=obj,
                       measured=round(measured.get(obj, math.nan), 6),
                       target=targets[obj], samples=n_samples)
        for obj in recovered:
            emit_event("slo_recovered", policy=pol.name, objective=obj,
                       measured=round(measured.get(obj, math.nan), 6),
                       target=targets[obj])
        status = SloStatus(compliant=not active, breached=active,
                           measured=measured, targets=targets,
                           samples=n_samples)
        self._publish(status)
        self.last_status = status
        return status

    @property
    def breached(self) -> bool:
        """True while any objective is in sustained breach."""
        return bool(self._active)

    def _publish(self, status: SloStatus) -> None:
        reg = self._registry if self._registry is not None \
            else get_registry()
        if not reg.enabled:
            return
        g = reg.gauge("nxd_slo_compliance",
                      "1 when the objective meets its SLO target, 0 in "
                      "sustained breach.", labels=("policy", "objective"))
        for obj in status.targets:
            g.labels(policy=self.policy.name, objective=obj).set(
                0.0 if obj in status.breached else 1.0)
        g.labels(policy=self.policy.name, objective="all").set(
            1.0 if status.compliant else 0.0)


def slo_from_dict(d: Dict[str, Any]) -> SloPolicy:
    """Build a policy from loosely-typed kwargs (CLI / YAML plumbing)."""
    fields = {f.name for f in dataclasses.fields(SloPolicy)}
    kwargs = {k: v for k, v in d.items() if k in fields}
    return SloPolicy(**kwargs)
