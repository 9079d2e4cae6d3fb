"""Host-side span tracer: nested spans, chrome-trace export, latency stats
(counterpart of ``neuronx_distributed_tpu/obs/tracing.py``; the same span
records, stats keys and request-trace calls).

Spans are host-side: a span around ``step_fn(...)`` measures the host wall
time of the call. In eager PyTorch that is the launches plus any host
synchronisation inside the call; it is not the card's time.

Four surfaces:

* ``span(name, **attrs)`` — context manager, nests via a per-thread stack;
* ``mark_event_start/end(name)`` — name-keyed flat events (also handy
  across callback boundaries);
* ``request_*`` — request-scoped traces keyed by request uid. A serving
  request crosses threads and step boundaries, so the per-thread span
  stack cannot follow it. Request traces instead accumulate per-phase time
  under an explicit uid: ``request_begin`` at admission,
  ``request_phase_begin/end`` for open-ended waits, ``request_mark`` /
  ``request_slices`` for step-sliced work, ``request_export`` /
  ``request_import`` to carry the trace across a live-migration ticket,
  and ``request_end(outcome=...)`` at retirement — which emits one
  chrome event per request with per-phase totals and critical-path
  attribution in ``args``.
* ``profile_step(logdir)`` — wraps ``torch.profiler`` with a
  ``tensorboard_trace_handler(logdir)`` and records a host span carrying
  the logdir attribute, so the device trace is findable from the host
  timeline. Such traces can drop launches of the package's ctypes
  kernels (``tools/probe_trace_loss.py`` counts them), so kernel times
  come from CUDA events, never from a trace.

``chrome_trace()`` / ``save()`` snapshot everything under the lock and
emit still-open spans as zero-duration ``"incomplete"`` events instead of
dropping them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import QUANTILES

#: live request traces kept before the oldest is evicted — a leak guard
#: for callers that begin traces and never retire them, not a window.
MAX_LIVE_REQUESTS = 10_000


class _RequestTrace:
    """Accumulated per-phase time for one in-flight request."""

    __slots__ = ("uid", "trace_id", "t0_us", "attrs", "phase_us",
                 "phase_n", "open_phases", "migrations")

    def __init__(self, uid: str, trace_id: str, t0_us: float,
                 attrs: Dict[str, Any]):
        self.uid = uid
        self.trace_id = trace_id
        self.t0_us = t0_us
        self.attrs = attrs
        self.phase_us: Dict[str, float] = {}
        self.phase_n: Dict[str, int] = {}
        self.open_phases: Dict[str, float] = {}
        self.migrations = 0

    def add(self, phase: str, dur_us: float, n: int = 1) -> None:
        self.phase_us[phase] = self.phase_us.get(phase, 0.0) + dur_us
        self.phase_n[phase] = self.phase_n.get(phase, 0) + n


class _NullSpan:
    """Returned when tracing is disabled: one shared, reentrant no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attribute(self, key: str, value: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("tracer", "name", "attrs", "t0_us", "parent")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0_us = 0.0
        self.parent: Optional[str] = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0_us = time.perf_counter_ns() / 1000.0
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_us = time.perf_counter_ns() / 1000.0
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.tracer._record(self, end_us)
        return False


class SpanTracer:
    """Thread-safe recorder for nested host spans.

    ``max_events`` bounds memory: beyond it the event list becomes a ring
    buffer of the most recent spans (per-name stats keep counting — they
    aggregate at record time, not from the buffer).
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self._events: List[Dict[str, Any]] = []
        self._next = 0
        self._open_named: Dict[str, float] = {}
        self._stats: Dict[str, List[float]] = {}
        self._requests: Dict[str, _RequestTrace] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- plumbing ---------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _append_event(self, ev: Dict[str, Any]) -> None:
        # caller holds self._lock
        if len(self._events) < self.max_events:
            self._events.append(ev)
        else:
            self._events[self._next] = ev
            self._next = (self._next + 1) % self.max_events

    def _record(self, span: Span, end_us: float) -> None:
        dur = end_us - span.t0_us
        ev = {
            "name": span.name, "ph": "X", "ts": span.t0_us, "dur": dur,
            "pid": os.getpid(), "tid": threading.get_ident() % 10000,
        }
        args = dict(span.attrs)
        if span.parent is not None:
            args["parent"] = span.parent
        if args:
            ev["args"] = args
        with self._lock:
            self._append_event(ev)
            self._stats.setdefault(span.name, []).append(dur)

    # -- span surface -----------------------------------------------
    def span(self, name: str, **attrs: Any):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    # -- Timeline-compatible name-keyed surface ----------------------
    def mark_event_start(self, name: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open_named[name] = time.perf_counter_ns() / 1000.0

    def mark_event_end(self, name: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            start = self._open_named.pop(name, None)
            if start is None:
                return
            dur = now - start
            self._append_event({
                "name": name, "ph": "X", "ts": start, "dur": dur,
                "pid": os.getpid(), "tid": threading.get_ident() % 10000,
            })
            self._stats.setdefault(name, []).append(dur)

    @contextlib.contextmanager
    def event(self, name: str):
        self.mark_event_start(name)
        try:
            yield
        finally:
            self.mark_event_end(name)

    # -- request-scoped traces ---------------------------------------
    def request_begin(self, uid: str, trace_id: Optional[str] = None,
                      **attrs: Any) -> Optional[str]:
        """Open (or adopt) a request trace; returns its trace-id.

        Idempotent: a second ``request_begin`` for a live uid merges
        attributes and keeps the original trace-id, so the router can
        open the trace at admission and a standalone engine can call it
        again at ``submit`` without forking the request's identity.
        """
        if not self.enabled:
            return None
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            tr = self._requests.get(uid)
            if tr is not None:
                tr.attrs.update(attrs)
                return tr.trace_id
            if len(self._requests) >= MAX_LIVE_REQUESTS:
                # leak guard: drop the oldest live trace, not the newest
                self._requests.pop(next(iter(self._requests)))
            tr = _RequestTrace(uid, trace_id or ("trace-%s" % uid),
                               now, dict(attrs))
            self._requests[uid] = tr
            return tr.trace_id

    def request_trace_id(self, uid: str) -> Optional[str]:
        with self._lock:
            tr = self._requests.get(uid)
            return tr.trace_id if tr is not None else None

    def request_annotate(self, uid: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            tr = self._requests.get(uid)
            if tr is not None:
                tr.attrs.update(attrs)

    def request_phase_begin(self, uid: str, phase: str) -> None:
        """Open-ended phase (queue waits) closed by ``request_phase_end``
        — or implicitly by ``request_end`` / ``request_export``."""
        if not self.enabled:
            return
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            tr = self._requests.get(uid)
            if tr is not None:
                tr.open_phases.setdefault(phase, now)

    def request_phase_end(self, uid: str, phase: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            tr = self._requests.get(uid)
            if tr is None:
                return
            start = tr.open_phases.pop(phase, None)
            if start is not None:
                tr.add(phase, now - start)

    def request_mark(self, uid: str, phase: str, dur_us: float = 0.0,
                     n: int = 1) -> None:
        """Accumulate a known duration (or a zero-duration marker such as
        ``resubmit``) into a request phase."""
        if not self.enabled:
            return
        with self._lock:
            tr = self._requests.get(uid)
            if tr is not None:
                tr.add(phase, dur_us, n)

    def request_slices(
            self, items: Iterable[Tuple[str, str, float]]) -> None:
        """Batch ``request_mark`` — one lock acquisition for a whole
        engine step's prefill/decode slice attribution."""
        if not self.enabled:
            return
        with self._lock:
            for uid, phase, dur_us in items:
                tr = self._requests.get(uid)
                if tr is not None:
                    tr.add(phase, dur_us)

    def request_export(self, uid: str) -> Optional[Dict[str, Any]]:
        """Pop a live trace into a portable dict (a ``SessionTicket``
        rider): the importing replica resumes the same trace-id and the
        accumulated phase totals survive the migration."""
        if not self.enabled:
            return None
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            tr = self._requests.pop(uid, None)
            if tr is None:
                return None
            for phase, start in tr.open_phases.items():
                tr.add(phase, now - start)
            return {
                "uid": tr.uid, "trace_id": tr.trace_id,
                "attrs": dict(tr.attrs),
                "phase_us": dict(tr.phase_us),
                "phase_n": dict(tr.phase_n),
                "elapsed_us": now - tr.t0_us,
                "migrations": tr.migrations + 1,
            }

    def request_import(self, state: Dict[str, Any]) -> None:
        """Adopt an exported request trace on the destination replica."""
        if not self.enabled or not state:
            return
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            uid = str(state.get("uid", ""))
            if not uid or uid in self._requests:
                return
            if len(self._requests) >= MAX_LIVE_REQUESTS:
                self._requests.pop(next(iter(self._requests)))
            tr = _RequestTrace(uid, str(state.get("trace_id", uid)),
                               now - float(state.get("elapsed_us", 0.0)),
                               dict(state.get("attrs", {})))
            tr.phase_us = {str(k): float(v)
                           for k, v in state.get("phase_us", {}).items()}
            tr.phase_n = {str(k): int(v)
                          for k, v in state.get("phase_n", {}).items()}
            tr.migrations = int(state.get("migrations", 1))
            self._requests[uid] = tr

    def request_end(self, uid: str, outcome: str = "completed",
                    **attrs: Any) -> Optional[Dict[str, Any]]:
        """Retire a request trace: emits one chrome event carrying the
        per-phase totals and critical-path attribution, and returns the
        summary (``None`` for unknown uids or when disabled)."""
        if not self.enabled:
            return None
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            tr = self._requests.pop(uid, None)
            if tr is None:
                return None
            for phase, start in tr.open_phases.items():
                tr.add(phase, now - start)
            total_us = max(0.0, now - tr.t0_us)
            attributed = sum(tr.phase_us.values())
            critical = max(tr.phase_us.items(), key=lambda kv: kv[1])[0] \
                if tr.phase_us else ""
            args: Dict[str, Any] = dict(tr.attrs)
            args.update(attrs)
            args.update({
                "trace_id": tr.trace_id, "outcome": outcome,
                "phase_us": {k: round(v, 3)
                             for k, v in sorted(tr.phase_us.items())},
                "phase_n": dict(sorted(tr.phase_n.items())),
                "critical_path": critical,
                "phase_share": {
                    k: round(v / total_us, 4) if total_us > 0 else 0.0
                    for k, v in sorted(tr.phase_us.items())},
                "unattributed_us": round(max(0.0, total_us - attributed),
                                         3),
            })
            if tr.migrations:
                args["migrations"] = tr.migrations
            self._append_event({
                "name": "request:%s" % uid, "ph": "X",
                "ts": tr.t0_us, "dur": total_us,
                "pid": os.getpid(),
                # stable per-request lane so each request gets its own
                # row in the chrome viewer regardless of serving thread
                "tid": zlib.crc32(uid.encode("utf-8")) % 10000,
                "args": args,
            })
            self._stats.setdefault("request/%s" % outcome,
                                   []).append(total_us)
            return {"uid": uid, "trace_id": tr.trace_id,
                    "outcome": outcome, "total_us": total_us,
                    "phase_us": dict(tr.phase_us),
                    "critical_path": critical}

    # -- torch.profiler glue -----------------------------------------
    @contextlib.contextmanager
    def profile_step(self, logdir: str = "build/nxd_profile"):
        """Attach a ``torch.profiler`` trace of the CPU and, where there is
        one, the CUDA card (written by ``tensorboard_trace_handler(logdir)``
        when the block ends, viewable in Perfetto or TensorBoard) to a
        host span, so device and host timelines cross-reference."""
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
        prof.start()
        span = self.span("profile_step", logdir=logdir)
        try:
            with span:
                yield logdir
        finally:
            prof.stop()

    # -- export ------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Snapshot as a chrome-trace dict.

        Taken entirely under the lock so concurrent writers can't tear
        the event list; spans still open at snapshot time (both the
        name-keyed kind and ``span()`` stacks) appear as zero-duration
        events tagged ``{"incomplete": true}`` rather than vanishing.
        """
        now = time.perf_counter_ns() / 1000.0
        with self._lock:
            if len(self._events) < self.max_events:
                events = list(self._events)
            else:  # unroll the ring into chronological order
                events = (self._events[self._next:]
                          + self._events[:self._next])
            open_named = dict(self._open_named)
            open_requests = [
                (tr.uid, tr.trace_id, tr.t0_us, dict(tr.phase_us))
                for tr in self._requests.values()]
        events = [dict(ev) for ev in events]
        for name, start in sorted(open_named.items()):
            events.append({
                "name": name, "ph": "X", "ts": start, "dur": 0.0,
                "pid": os.getpid(), "tid": threading.get_ident() % 10000,
                "args": {"incomplete": True, "open_for_us": now - start},
            })
        for uid, trace_id, start, phase_us in sorted(open_requests):
            events.append({
                "name": "request:%s" % uid, "ph": "X", "ts": start,
                "dur": 0.0, "pid": os.getpid(),
                "tid": zlib.crc32(uid.encode("utf-8")) % 10000,
                "args": {"incomplete": True, "trace_id": trace_id,
                         "open_for_us": now - start,
                         "phase_us": phase_us},
            })
        return {"traceEvents": events}

    def save(self, path: str) -> str:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return path

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name latency stats (durations in microseconds)."""
        with self._lock:
            snap = {name: list(durs) for name, durs in self._stats.items()}
        out: Dict[str, Dict[str, float]] = {}
        for name, durs in sorted(snap.items()):
            durs.sort()
            n = len(durs)
            entry = {
                "count": float(n),
                "total_us": sum(durs),
                "mean_us": sum(durs) / n,
                "min_us": durs[0],
                "max_us": durs[-1],
            }
            for q in QUANTILES:
                idx = max(0, min(n - 1, int(math.ceil(q * n)) - 1))
                entry["p%g_us" % (q * 100)] = durs[idx]
            out[name] = entry
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._next = 0
            self._open_named.clear()
            self._stats.clear()
            self._requests.clear()


#: process-wide default tracer; enabled/disabled in lockstep with the
#: default metrics registry by ``obs.enable()`` / ``obs.disable()``.
_DEFAULT: Optional[SpanTracer] = None
_DEFAULT_LOCK = threading.Lock()


def get_tracer() -> SpanTracer:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = SpanTracer(
                    enabled=os.environ.get("NXD_OBS", "0") == "1")
    return _DEFAULT
