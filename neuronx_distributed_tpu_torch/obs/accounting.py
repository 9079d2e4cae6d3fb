"""Automatic accounting: compile tracking and wire-byte counters
(counterpart of ``neuronx_distributed_tpu/obs/accounting.py``).

**Compile tracking.** The reference counts the compiles of a jitted
callable; eager PyTorch compiles nothing, and the port's analog of "one
program" is one step shape: the serving engine counts the distinct shape
signatures of its steps (``ServingEngine.compile_count()``), and the train
step counts those of its batches (``make_train_step``'s
``step.cache_size()``). ``CompileTracker`` polls such a count after calls,
counts new signatures under the reference's metric names
(``nxd_compile_total``, ``nxd_compile_wall_seconds``,
``nxd_recompile_total``), attributes the call's wall time to the new
signature, and on any signature *beyond the first* raises the
``recompile_detected`` alert through the shared event channel — the same
channel the watchdog emits on.

**Wire bytes.** ``record_wire_bytes`` and ``record_collective_time``
account collectives by kind and wire dtype. The port has no compressed
collectives yet, so nothing calls them; they are here so that the
registry's names are the reference's when those collectives come.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from .events import emit_event
from .metrics import MetricsRegistry, get_registry

# ---------------------------------------------------------------------------
# wire-byte accounting
# ---------------------------------------------------------------------------


def record_wire_bytes(kind: str, dtype: str, wire_bytes: float,
                      raw_bytes: float,
                      registry: Optional[MetricsRegistry] = None) -> None:
    """Account one logical collective: bytes actually shipped vs fp32.

    ``kind`` names the collective site (e.g. ``grad_all_reduce``,
    ``act_all_gather_matmul``); ``dtype`` is the wire dtype label.
    Callers compute the byte figures with ``wire_codec`` arithmetic so
    the counters and the codec can never disagree by construction drift.
    """
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    labels = ("collective", "dtype")
    reg.counter("nxd_wire_bytes_total",
                "Bytes shipped on the wire per collective kind "
                "(traced-bytes: counted once per trace, not per run).",
                labels=labels).labels(
                    collective=kind, dtype=dtype).inc(wire_bytes)
    reg.counter("nxd_wire_raw_bytes_total",
                "fp32-equivalent bytes for the same collectives.",
                labels=labels).labels(
                    collective=kind, dtype=dtype).inc(raw_bytes)
    reg.counter("nxd_wire_collectives_total",
                "Logical collective calls accounted.",
                labels=labels).labels(collective=kind, dtype=dtype).inc()


def record_collective_time(tier: str, nbytes: float, seconds: float,
                           registry: Optional[MetricsRegistry] = None
                           ) -> None:
    """Account one *timed* collective: (payload bytes, wall seconds).

    Records measured host wall time around an executed collective, the
    (bytes, time) pairs a link model is fitted from. ``tier`` is the link
    tier label; the payload size rides as a label so distinct sizes come
    back from a plain registry snapshot.
    """
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    reg.histogram("nxd_collective_seconds",
                  "Measured wall time of executed collectives, labeled "
                  "by link tier and payload bytes (calibration source).",
                  labels=("tier", "nbytes")).labels(
                      tier=tier, nbytes=str(int(nbytes))).observe(seconds)


def wire_totals(registry: Optional[MetricsRegistry] = None
                ) -> Tuple[float, float]:
    """(wire_bytes, raw_bytes) summed over all collective kinds."""
    reg = registry if registry is not None else get_registry()
    wire = reg.get("nxd_wire_bytes_total")
    raw = reg.get("nxd_wire_raw_bytes_total")
    w = sum(c.value for c in wire.children()) if wire is not None else 0.0
    r = sum(c.value for c in raw.children()) if raw is not None else 0.0
    return w, r


def wire_compression_ratio(registry: Optional[MetricsRegistry] = None
                           ) -> float:
    """raw/wire over everything accounted so far (1.0 when empty)."""
    w, r = wire_totals(registry)
    return (r / w) if w > 0 else 1.0


# ---------------------------------------------------------------------------
# compile tracking
# ---------------------------------------------------------------------------


def cache_size(fn: Any) -> Optional[int]:
    """Best-effort count of a callable's distinct step shapes, through its
    ``cache_size()`` (``make_train_step``'s step) or ``compile_count()``
    (a ``ServingEngine``); None when it has neither."""
    probe = getattr(fn, "cache_size", None) or getattr(
        fn, "compile_count", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


class CompileTracker:
    """Tracks the step-shape count of one site (a train step or a serving
    worker).

    ``poll(wall_s=...)`` compares the current count against the last
    observation; growth means the preceding call met a new shape. The
    first per site is expected and merely counted; any further one is a
    *recompile* in the reference's terms — counted separately and alerted
    on through the event channel (``recompile_detected``), watchdog-style.
    """

    def __init__(self, site: str, cache_size_fn: Callable[[], Optional[int]],
                 registry: Optional[MetricsRegistry] = None,
                 alert: bool = True):
        self.site = site
        self._cache_size_fn = cache_size_fn
        self._registry = registry
        self._alert = alert
        self._last = 0

    @classmethod
    def for_function(cls, site: str, fn: Any, **kw: Any) -> "CompileTracker":
        return cls(site, lambda: cache_size(fn), **kw)

    @property
    def _reg(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_registry())

    def poll(self, wall_s: Optional[float] = None) -> int:
        """Observe the cache size; record any compiles since last poll.

        Returns the current cache size (0 if unobservable). ``wall_s``,
        when given, is the wall time of the call that just finished and
        is attributed to compilation if the count grew.
        """
        n = self._cache_size_fn()
        if n is None:
            return 0
        grew = n - self._last
        if grew <= 0:
            return n
        self._last = n
        reg = self._reg
        if reg.enabled:
            reg.counter("nxd_compile_total",
                        "Compiles observed per site.",
                        labels=("site",)).labels(site=self.site).inc(grew)
            if wall_s is not None:
                reg.histogram("nxd_compile_wall_seconds",
                              "Wall time of calls that triggered a "
                              "compile.",
                              labels=("site",)).labels(
                                  site=self.site).observe(wall_s)
        if n > 1:
            recompiles = grew if self._last - grew >= 1 else n - 1
            if reg.enabled:
                reg.counter("nxd_recompile_total",
                            "Compiles beyond the first per site "
                            "(each one is a performance bug).",
                            labels=("site",)).labels(
                                site=self.site).inc(recompiles)
            if self._alert:
                emit_event("recompile_detected", site=self.site,
                           cache_size=n, new_compiles=grew,
                           wall_s=wall_s)
        return n

    def wrap(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Wrap a step callable: time each call and poll afterwards."""

        def _wrapped(*args: Any, **kw: Any) -> Any:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.poll(wall_s=time.perf_counter() - t0)
            return out

        _wrapped.__name__ = getattr(fn, "__name__", "compiled")
        return _wrapped


def compile_events(registry: Optional[MetricsRegistry] = None) -> float:
    """Total compiles accounted across all sites."""
    reg = registry if registry is not None else get_registry()
    m = reg.get("nxd_compile_total")
    return sum(c.value for c in m.children()) if m is not None else 0.0
