"""Unified observability: metrics registry, span tracer, accounting
(counterpart of ``neuronx_distributed_tpu/obs``, with the same exports).

One switch governs the whole subsystem::

    from neuronx_distributed_tpu_torch import obs
    obs.enable()                  # or NXD_OBS=1 in the environment
    ...run training / serving...
    print(obs.get_registry().to_prometheus())
    obs.get_tracer().save("trace.json")   # open in Perfetto

Disabled (the default), every instrumented path reduces to a single bool
check.
"""

from __future__ import annotations

from .accounting import (CompileTracker, cache_size, compile_events,
                         record_collective_time, record_wire_bytes,
                         wire_compression_ratio, wire_totals)
from .events import emit_event, subscribe
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .slo import SloMonitor, SloPolicy, SloStatus
from .tracing import Span, SpanTracer, get_tracer

__all__ = [
    "CompileTracker", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SloMonitor", "SloPolicy", "SloStatus",
    "Span", "SpanTracer", "cache_size", "compile_events", "disable",
    "emit_event", "enable", "enabled", "get_registry", "get_tracer",
    "record_collective_time", "record_wire_bytes", "reset", "subscribe",
    "wire_compression_ratio", "wire_totals",
]


def enable() -> None:
    """Turn on metrics collection and span recording process-wide."""
    get_registry().enable()
    get_tracer().enabled = True


def disable() -> None:
    get_registry().disable()
    get_tracer().enabled = False


def enabled() -> bool:
    return get_registry().enabled


def reset() -> None:
    """Drop all recorded metrics and spans (tests / fresh bench runs)."""
    get_registry().reset()
    get_tracer().reset()
