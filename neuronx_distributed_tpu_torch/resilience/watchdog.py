"""Training watchdog: anomaly detection with recovery policies (the port's
copy of ``neuronx_distributed_tpu/resilience/watchdog.py``).

A NaN loss, an exploding gradient, or a hung collective each wedge a run in
a different way: the first two silently destroy the model while steps keep
"succeeding"; the last produces no steps at all. :class:`Watchdog` is a
``Trainer`` callback covering all three:

* **non-finite loss / grad-norm** → configurable policy:

  - ``halt``: raise :class:`WatchdogHalt` (default — fail loudly);
  - ``skip_step``: copy the pre-step snapshot back into ``trainer.state``
    and continue with the next batch (the port's step updates the state in
    place, so ``Trainer`` keeps a real copy for this policy alone; the
    on-device equivalent is ``make_train_step(skip_nonfinite=True)``);
  - ``rewind``: restore the newest complete checkpoint from
    ``checkpoint_path`` and continue from there.

* **loss spikes** — rolling z-score over the last ``spike_window`` finite
  losses; a spike logs a machine-parseable event (and optionally applies
  the anomaly policy when ``spike_is_anomaly=True``).

* **stalls** — a host-side daemon thread watches a heartbeat updated at
  every step boundary; a step exceeding ``stall_timeout_s`` wall-clock
  (hung collective, stalled ``data/native_loader`` iterator) fires
  ``on_stall`` — by default logging CRITICAL and interrupting the main
  thread so the run dies visibly instead of burning a reservation.

The watchdog reads ``float(metrics[...])`` and is therefore *the* host sync
point of the loop — by design: anomaly detection needs the value, and a
single fetch per step is the price of catching divergence the step it
happens.

The two detection primitives are factored out as :class:`SpikeDetector`
(rolling z-score) and :class:`StallTimer` (heartbeat staleness) so the
serving-side replica health monitor (the reference's
``inference/router.py``, a later slice here) can reuse the same statistics
over *step latency* that training runs over *loss*.
"""

from __future__ import annotations

import collections
import math
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

from ..utils.logger import get_logger, log_event

logger = get_logger(__name__)

_POLICIES = ("halt", "skip_step", "rewind")


class WatchdogHalt(RuntimeError):
    """Training halted by the watchdog (non-finite metrics with policy
    ``halt``, or a recovery policy that ran out of budget)."""


class SpikeDetector:
    """Rolling z-score spike detector over a bounded window of finite
    observations.

    Factored out of the training watchdog so serving health monitors can
    reuse the exact same statistic: training feeds *loss*, the replica
    router (``inference/router.py``) feeds *step latency*. An observation
    is compared against the window **before** being appended, so a spike
    does not poison the baseline it is judged against — but it does enter
    the window afterwards, matching the original watchdog semantics
    (a sustained level shift stops spiking once the window absorbs it).
    """

    def __init__(self, window: int = 32, zscore: float = 8.0,
                 min_steps: int = 8):
        self.window = window
        self.zscore = zscore
        self.min_steps = max(min_steps, 2)
        self.values: collections.deque = collections.deque(maxlen=window)
        self.spikes = 0

    def __len__(self) -> int:
        return len(self.values)

    def clear(self) -> None:
        self.values.clear()

    def observe(self, value: float) -> Optional[Tuple[float, float]]:
        """Feed one finite observation. Returns ``(z, rolling_mean)`` when
        it spikes past the threshold (and counts it), else None. No spike
        is ever reported before ``min_steps`` observations exist."""
        spike = None
        if len(self.values) >= self.min_steps:
            mean = sum(self.values) / len(self.values)
            var = sum((x - mean) ** 2
                      for x in self.values) / len(self.values)
            z = (value - mean) / max(math.sqrt(var), 1e-8)
            if z > self.zscore:
                self.spikes += 1
                spike = (z, mean)
        self.values.append(value)
        return spike


class StallTimer:
    """Heartbeat-staleness detector, factored from the watchdog's stall
    thread so the serving router reuses it instead of duplicating.

    Three usage shapes share one fire-once-per-heartbeat state machine:

    * **threaded** (``start()``/``stop()``): a daemon thread polls and
      calls ``on_stall(stalled_for_s)`` when a heartbeat goes stale — the
      training-watchdog mode (a hung collective never returns control, so
      only another thread can notice);
    * **passive** (``beat()`` + ``check()``): the owner polls on its own
      schedule against an injectable ``clock`` — deterministic under the
      fake clocks serving tests drive;
    * **post-hoc** (``observe(elapsed_s)``): the owner measured a step's
      duration itself (possibly including chaos-injected virtual latency)
      and asks whether it blew the budget.
    """

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[float], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "nxd-stall-timer"):
        self.timeout_s = float(timeout_s)
        self._on_stall = on_stall
        self._clock = clock
        self._name = name
        self.stalls = 0
        self._heartbeat = clock()
        self._fired_for: Optional[float] = None
        self._stop = threading.Event()
        self.thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._heartbeat = self._clock()

    def stalled_for(self) -> float:
        return self._clock() - self._heartbeat

    def check(self) -> bool:
        """True exactly once per stale heartbeat (re-arms on ``beat()``)."""
        hb = self._heartbeat
        if self._clock() - hb > self.timeout_s and self._fired_for != hb:
            self._fired_for = hb
            self.stalls += 1
            return True
        return False

    def observe(self, elapsed_s: float) -> bool:
        """Record a step that took ``elapsed_s``; True when it exceeds the
        budget. Counts every over-budget step (each is its own stall)."""
        self.beat()
        if elapsed_s > self.timeout_s:
            self.stalls += 1
            return True
        return False

    # ---- threaded mode ---------------------------------------------------

    def _loop(self) -> None:
        poll = min(1.0, self.timeout_s / 4.0)
        while not self._stop.wait(poll):
            if self.check() and self._on_stall is not None:
                try:
                    self._on_stall(self.stalled_for())
                except Exception:
                    logger.exception("stall timer: on_stall callback failed")

    def start(self) -> "StallTimer":
        if self.thread is None:
            self._stop.clear()
            self.beat()
            self.thread = threading.Thread(target=self._loop, daemon=True,
                                           name=self._name)
            self.thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.thread is not None:
            self.thread.join(timeout=5.0)
            self.thread = None


def _state_step(state) -> Optional[int]:
    step = getattr(state, "step", None)
    if step is None and isinstance(state, dict):
        step = state.get("step")
    try:
        return None if step is None else int(step)
    except Exception:
        return None


class Watchdog:
    """See module docstring. Construct and pass via ``callbacks=[...]``."""

    @property
    def needs_prev_state(self) -> bool:
        """Tells ``Trainer.fit`` to keep a pre-step copy of the state: for
        ``skip_step`` only (a copy costs the state's size, where the
        reference's immutable state made it free)."""
        return self.policy == "skip_step"

    def __init__(self, policy: str = "halt",
                 checkpoint_path: Optional[str] = None,
                 max_consecutive_skips: int = 5,
                 max_rewinds: int = 3,
                 spike_window: int = 32,
                 spike_zscore: float = 8.0,
                 spike_min_steps: int = 8,
                 spike_is_anomaly: bool = False,
                 stall_timeout_s: Optional[float] = None,
                 on_stall: Optional[Callable] = None):
        if policy not in _POLICIES:
            raise ValueError(f"unknown watchdog policy {policy!r}; "
                             f"expected one of {_POLICIES}")
        if policy == "rewind" and checkpoint_path is None:
            raise ValueError("policy='rewind' requires checkpoint_path")
        self.policy = policy
        self.checkpoint_path = checkpoint_path
        self.max_consecutive_skips = max_consecutive_skips
        self.max_rewinds = max_rewinds
        self.spike_window = spike_window
        self.spike_zscore = spike_zscore
        self.spike_min_steps = max(spike_min_steps, 2)
        self.spike_is_anomaly = spike_is_anomaly
        self.stall_timeout_s = stall_timeout_s
        self._on_stall = on_stall or self._default_on_stall
        self._detector = SpikeDetector(window=spike_window,
                                       zscore=spike_zscore,
                                       min_steps=spike_min_steps)
        self._consecutive_skips = 0
        self._rewinds = 0
        self.anomalies = 0
        self._timer: Optional[StallTimer] = None
        self._stalls_base = 0  # stalls from timers already stopped
        # the trainer of the running fit, for on_stall; a weak reference,
        # since the trainer holds this callback and a strong one would keep
        # a finished trainer's model and optimizer state alive until a
        # garbage collection
        self._trainer: Optional[weakref.ref] = None

    # ------------------------------------------------------------- stalls

    @property
    def spikes(self) -> int:
        return self._detector.spikes

    @property
    def stalls(self) -> int:
        live = self._timer.stalls if self._timer is not None else 0
        return self._stalls_base + live

    @property
    def _stall_thread(self) -> Optional[threading.Thread]:
        return self._timer.thread if self._timer is not None else None

    def _default_on_stall(self, trainer) -> None:
        logger.critical(
            "watchdog: step exceeded the %.1fs wall-clock budget — hung "
            "collective or stalled data loader; interrupting the run",
            self.stall_timeout_s)
        import _thread

        _thread.interrupt_main()

    def _handle_stall(self, stalled_for_s: float) -> None:
        log_event(logger, "watchdog_stall", budget_s=self.stall_timeout_s,
                  stalled_for_s=round(stalled_for_s, 3))
        self._on_stall(self._trainer() if self._trainer is not None
                       else None)

    # ---------------------------------------------------- Callback hooks

    def on_train_start(self, trainer) -> None:
        self._trainer = weakref.ref(trainer)
        if self.stall_timeout_s is not None and self._timer is None:
            self._timer = StallTimer(self.stall_timeout_s,
                                     on_stall=self._handle_stall,
                                     name="nxd-watchdog-stall").start()

    def on_step_end(self, trainer, metrics: Dict) -> None:
        if self._timer is not None:
            self._timer.beat()
        loss = float(metrics.get("loss", float("nan")))
        grad_norm = float(metrics.get("grad_norm", 0.0))
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            self._anomaly(trainer,
                          f"non-finite metrics at step {trainer.host_step}: "
                          f"loss={loss} grad_norm={grad_norm}")
            return
        self._consecutive_skips = 0
        self._check_spike(trainer, loss)

    def on_eval_end(self, trainer, metrics: Dict) -> None: ...

    def on_train_end(self, trainer) -> None:
        if self._timer is not None:
            self._timer.stop()
            self._stalls_base += self._timer.stalls
            self._timer = None
        self._trainer = None

    # ----------------------------------------------------------- spikes

    def _check_spike(self, trainer, loss: float) -> None:
        spike = self._detector.observe(loss)
        if spike is not None:
            z, mean = spike
            log_event(logger, "watchdog_loss_spike",
                      step=trainer.host_step, loss=round(loss, 6),
                      rolling_mean=round(mean, 6), zscore=round(z, 2))
            if self.spike_is_anomaly:
                self._anomaly(trainer,
                              f"loss spike at step {trainer.host_step}: "
                              f"loss={loss:.4g} z={z:.1f}")

    # --------------------------------------------------------- anomalies

    def report_anomaly(self, trainer, reason: str) -> None:
        """External anomaly entry point: other detectors (a custom
        data-quality check, say) feed the same halt / skip_step / rewind
        discipline as the built-in
        non-finite and spike detectors — one recovery policy, one rewind
        budget, regardless of who detected the problem."""
        self._anomaly(trainer, reason)

    def _anomaly(self, trainer, reason: str) -> None:
        self.anomalies += 1
        log_event(logger, "watchdog_anomaly", policy=self.policy,
                  step=trainer.host_step, reason=reason)
        if self.policy == "halt":
            raise WatchdogHalt(reason)
        if self.policy == "skip_step":
            prev = getattr(trainer, "_prev_state", None)
            if prev is None:
                raise WatchdogHalt(
                    f"{reason} — skip_step needs the pre-step state, which "
                    "Trainer keeps when a callback sets needs_prev_state")
            self._consecutive_skips += 1
            if self._consecutive_skips > self.max_consecutive_skips:
                raise WatchdogHalt(
                    f"{reason} — {self._consecutive_skips} consecutive "
                    "skipped steps; the run is not recovering")
            from ..trainer.checkpoint import load_tree_

            load_tree_(trainer.state, prev)
            trainer.host_step = max(trainer.host_step - 1, 0)
            logger.warning("watchdog: skipped bad update, retrying from "
                           "step %d", trainer.host_step)
            return
        # rewind
        from ..trainer import checkpoint as ckpt

        if self._rewinds >= self.max_rewinds:
            raise WatchdogHalt(
                f"{reason} — rewound {self._rewinds} times already; "
                "the run is not recovering")
        # quiesce in-flight async saves first: the newest verified tag is
        # often the one committed by this very boundary's CheckpointCallback
        ckpt.finalize_checkpoint()
        if not ckpt.has_checkpoint(self.checkpoint_path):
            raise WatchdogHalt(
                f"{reason} — no complete checkpoint under "
                f"{self.checkpoint_path} to rewind to")
        trainer.state, _ = ckpt.load_checkpoint(self.checkpoint_path,
                                                tag=None,
                                                target=trainer.state)
        self._rewinds += 1
        step = _state_step(trainer.state)
        if step is not None:
            trainer.host_step = step
        self._detector.clear()
        logger.warning("watchdog: rewound to checkpoint step %s "
                       "(rewind %d/%d)", step, self._rewinds,
                       self.max_rewinds)
