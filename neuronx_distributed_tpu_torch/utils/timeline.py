"""Execution timelines under the reference's names (counterpart of
``neuronx_distributed_tpu/utils/timeline.py``): thin shims over
:class:`..obs.tracing.SpanTracer`. New code can use ``obs.get_tracer()``
itself, with nested spans, attributes and per-name latency stats.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from ..obs.tracing import SpanTracer, get_tracer


class Timeline:
    """Host-side chrome-trace event recorder over a tracer of its own, so
    separate Timelines do not see each other's events and carry their own
    ``enabled`` flag, whatever the ``obs`` switch. ``save`` snapshots under
    the tracer's lock and writes spans still open as zero-duration
    ``{"incomplete": true}`` events."""

    def __init__(self, output_file: str = "timeline.json",
                 enabled: bool = True):
        self.output_file = output_file
        self._tracer = SpanTracer(enabled=enabled)

    @property
    def enabled(self) -> bool:
        return self._tracer.enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._tracer.enabled = value

    def mark_event_start(self, name: str) -> None:
        self._tracer.mark_event_start(name)

    def mark_event_end(self, name: str) -> None:
        self._tracer.mark_event_end(name)

    def event(self, name: str):
        return self._tracer.event(name)

    def save(self, path: Optional[str] = None) -> str:
        return self._tracer.save(path or self.output_file)


@contextlib.contextmanager
def profile_step(logdir: str = "build/nxd_profile"):
    """A ``torch.profiler`` trace of the enclosed steps (the CPU, and the
    CUDA card where there is one), written under ``logdir`` and recorded as
    a host span of the default tracer when tracing is on
    (:meth:`..obs.tracing.SpanTracer.profile_step`)."""
    with get_tracer().profile_step(logdir) as d:
        yield d
