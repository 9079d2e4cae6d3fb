"""Preemption-safe checkpointing (the port's copy of
``neuronx_distributed_tpu/resilience/preemption.py``).

Cloud schedulers preempt with SIGTERM and a short grace window. A naive run
loses up to ``every`` steps of work; a handler that checkpoints *inside the
signal handler* corrupts in-flight async commits. :class:`PreemptionGuard`
does neither: the handler only records the request, and ``Trainer.fit``
honors it at the next step boundary with a synchronous emergency
``save_checkpoint``, then raises :class:`TrainingPreempted` — a
``SystemExit`` carrying :data:`EXIT_PREEMPTED` so an unhandled preemption
exits the process with a distinct, resumable status the launcher can key
restarts on.

The grace deadline bounds the emergency save: when storage is too slow to
finish inside the remaining grace, the save degrades to flushing in-flight
async commits (the last periodic checkpoint stays the resume point instead
of a half-written emergency tag).
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Iterable, Optional

from ..utils.logger import get_logger, log_event

logger = get_logger(__name__)

#: Resumable exit status (BSD ``EX_TEMPFAIL``): "failed for a transient
#: reason — rerun me". Distinct from 0 (done), 1 (crash) and 128+signum
#: (killed without cleanup), so launch scripts can requeue on exactly this.
EXIT_PREEMPTED = 75


class TrainingPreempted(SystemExit):
    """Raised by ``Trainer.fit`` after the emergency save. Subclasses
    ``SystemExit(EXIT_PREEMPTED)``: uncaught, the process exits resumable;
    caught, ``step``/``saved_tag`` say where training can pick up."""

    def __init__(self, step: int, saved_tag: Optional[str] = None):
        super().__init__(EXIT_PREEMPTED)
        self.step = step
        self.saved_tag = saved_tag

    def __str__(self) -> str:
        return (f"training preempted at step {self.step} "
                f"(emergency checkpoint: {self.saved_tag or 'none'}; "
                f"exit code {EXIT_PREEMPTED})")


class PreemptionGuard:
    """Turns SIGTERM/SIGINT into a step-boundary checkpoint request.

    Usage::

        guard = PreemptionGuard(checkpoint_path=ckpt_dir, grace_s=30)
        trainer = Trainer(step_fn, state, callbacks=[...],
                          preemption_guard=guard)
        trainer.fit(batches)   # raises TrainingPreempted on SIGTERM

    The handler is async-signal-safe by construction: it records a
    timestamp and sets an event — no IO, no locks. Everything heavy happens
    on the training thread at the next step boundary.

    ``signal.signal`` requires the main thread; ``install()`` raises
    elsewhere rather than silently not protecting the run.
    """

    def __init__(self, checkpoint_path: Optional[str] = None,
                 grace_s: float = 30.0,
                 signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self.checkpoint_path = checkpoint_path
        self.grace_s = float(grace_s)
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._requested_at: Optional[float] = None
        self._signum: Optional[int] = None
        self._old_handlers: dict = {}
        self.installed = False

    # ---- signal side (async-signal-safe: no IO, no allocation-heavy work)

    def _handler(self, signum, frame) -> None:
        if self._requested_at is None:
            self._requested_at = time.monotonic()
            self._signum = signum
        self._event.set()

    # ---- control side

    def install(self) -> "PreemptionGuard":
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "PreemptionGuard.install() must run on the main thread "
                "(signal.signal requirement)")
        for s in self.signals:
            self._old_handlers[s] = signal.signal(s, self._handler)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for s, old in self._old_handlers.items():
            signal.signal(s, old)
        self._old_handlers.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def remaining_grace(self) -> float:
        """Seconds of grace left for the emergency save (full grace when no
        preemption has been requested)."""
        if self._requested_at is None:
            return self.grace_s
        return max(0.0, self.grace_s
                   - (time.monotonic() - self._requested_at))

    def reset(self) -> None:
        """Clear a handled request (tests / supervisors that decide to keep
        running after draining)."""
        self._event.clear()
        self._requested_at = None
        self._signum = None

    def announce(self, step: int) -> None:
        """Log the machine-parseable preemption event (called by the
        trainer once, at the boundary that honors the request)."""
        log_event(logger, "preemption_requested", step=step,
                  signum=self._signum, grace_s=self.grace_s,
                  remaining_grace_s=round(self.remaining_grace(), 3))
