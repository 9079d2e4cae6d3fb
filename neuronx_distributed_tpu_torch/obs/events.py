"""Operational event channel: one source of truth for NXD_EVENT lines
(counterpart of ``neuronx_distributed_tpu/obs/events.py``).

``utils.logger.log_event`` (used by the resilience subsystem and the
watchdog) routes through here, so every event at once

* emits the grep/parse-friendly ``NXD_EVENT {json}`` log line (launch
  tooling depends on the format),
* increments ``nxd_events_total{event=...}`` in the metrics registry, and
* fans out to in-process subscribers (tests, custom alert hooks).

The log line is unconditional — operational events stay visible with
metrics collection disabled; only the counter and the subscribers' side
gate on the registry's enabled flag (subscribers are called either way,
as in the reference).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Any, Callable, Dict, List, Optional

from .metrics import get_registry

Subscriber = Callable[[str, Dict[str, Any]], None]

_SUBSCRIBERS: List[Subscriber] = []
_SUB_LOCK = threading.Lock()


def subscribe(fn: Subscriber) -> Callable[[], None]:
    """Register ``fn(event, fields)``; returns an unsubscribe thunk."""
    with _SUB_LOCK:
        _SUBSCRIBERS.append(fn)

    def _unsubscribe() -> None:
        with _SUB_LOCK:
            try:
                _SUBSCRIBERS.remove(fn)
            except ValueError:
                pass

    return _unsubscribe


def emit_event(event: str, logger: Optional[logging.Logger] = None,
               **fields: Any) -> None:
    """Record an operational event (see module docstring for the fan-out)."""
    if logger is None:
        from ..utils.logger import get_logger  # lazy: avoids import cycle

        # a child logger, never the package root: get_logger attaches a
        # handler and sets propagate=False on the name it is given
        logger = get_logger("neuronx_distributed_tpu_torch.obs.events")
    payload = {"event": event, **fields}
    logger.warning("NXD_EVENT %s",
                   json.dumps(payload, sort_keys=True, default=str))

    reg = get_registry()
    if reg.enabled:
        reg.counter("nxd_events_total",
                    "Operational events by type (NXD_EVENT lines).",
                    labels=("event",)).labels(event=event).inc()
    with _SUB_LOCK:
        subs = list(_SUBSCRIBERS)
    for fn in subs:
        try:
            fn(event, dict(fields))
        except Exception:
            logger.exception("event subscriber failed for %r", event)
