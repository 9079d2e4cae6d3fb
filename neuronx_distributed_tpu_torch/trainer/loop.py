"""High-level training loop with callbacks (counterpart of
``neuronx_distributed_tpu/trainer/loop.py``).

The loop is a plain function over the train step (``make_train_step``);
the reference's Lightning surface maps to :class:`Callback` hooks
(logging, checkpointing, the watchdog, the integrity monitor) around it.

Observability, as in the reference (``obs``): the spans ``train/data``
(the next batch), ``train/step`` (the step call), ``train/callbacks`` and
``CheckpointCallback``'s ``train/checkpoint`` (``mode="async"`` or
``"sync"``); the counter ``nxd_train_steps_total`` and the histogram
``nxd_train_step_seconds`` (the step call's wall time); and a
``CompileTracker`` over the step's count of batch shapes (site
``trainer/step``), which alerts when a second shape appears. ``train/step``
is the host wall time of the step call, as in the reference; there it is
the jitted step's dispatch, here the eager step's launches plus any host
synchronisation inside it (``skip_nonfinite``'s reads of the loss and
the norm), not the card's time.
With obs disabled each hook costs one bool check.

The port's step updates the state in place, and the state lives on the
model's device; batches (numpy arrays or tensors) move there inside the
step.

Across ranks every rank runs ``fit`` on the same global batches (the step
takes each rank's rows), and every host decision is taken by all ranks
together at the same step boundary: a preemption that any rank's guard
saw makes every rank save the same emergency tag and exit (one
:func:`..parallel.mesh.agree` of a flag per step); the watchdog's halt,
skip and rewind agree because ``loss`` and ``grad_norm`` are global, and a
rewind loads the same tag on every rank (verification agreed); the
integrity monitor agrees on a mismatch any rank saw. Checkpoints are
saved and loaded by every rank together (:mod:`.checkpoint`). Only rank 0
logs ``MetricsLogger``'s lines and writes its file. The reference's loop
is a single controller and needs no such agreement: this is a divergence
of the port, which runs one process per rank. The emergency save's grace
deadline is not enforced across ranks: the save runs on the training
thread, since its collectives may not run beside a deadline thread's.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..obs.accounting import CompileTracker
from ..obs.metrics import get_registry
from ..obs.tracing import get_tracer
from ..parallel import mesh as ps
from ..utils.logger import get_logger, log_event
from . import checkpoint as ckpt

logger = get_logger(__name__)


class Callback:
    """Hook points (the Lightning-callback analogue)."""

    def on_train_start(self, trainer: "Trainer") -> None: ...

    def on_step_end(self, trainer: "Trainer", metrics: Dict) -> None: ...

    def on_eval_end(self, trainer: "Trainer", metrics: Dict) -> None: ...

    def on_train_end(self, trainer: "Trainer") -> None: ...


class MetricsLogger(Callback):
    """Rank-0 console/TSV metrics logging (reference ``lightning/logger.py``
    TB logger)."""

    def __init__(self, every: int = 10, file: Optional[str] = None):
        self.every = every
        self.file = file
        self._t0 = None
        self._tokens = 0

    def on_train_start(self, trainer):
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer, metrics):
        step = trainer.host_step
        self._tokens += trainer.tokens_per_batch
        if step % self.every == 0 and ps.world_rank() == 0:
            dt = time.perf_counter() - self._t0
            tps = self._tokens / max(dt, 1e-9)
            line = (f"step {step} loss {float(metrics['loss']):.4f} "
                    f"grad_norm {float(metrics.get('grad_norm', 0)):.3f} "
                    f"tokens/s {tps:,.0f}")
            logger.info(line)
            if self.file:
                with open(self.file, "a") as f:
                    f.write(line + "\n")


class CheckpointCallback(Callback):
    """Periodic async checkpointing with retention + final flush (reference
    ``lightning/checkpoint_io.py`` over our checkpoint engine).

    Step 0 never saves (an untrained checkpoint both wastes a retention
    slot and can shadow a real resume point), and ``on_train_end`` saves
    the final step synchronously when it is not aligned to ``every`` — the
    tail of a run is never lost to alignment.

    Every tag carries a save manifest with per-shard content digests, so
    a later rewind (the watchdog, or :class:`~..resilience.integrity
    .IntegrityMonitor` on a fingerprint mismatch) restores from a
    checkpoint whose *bytes* verify. Order this callback *before* the
    IntegrityMonitor in ``callbacks``: detection then fires after the
    boundary's save, and a mismatch rewinds to state captured before the
    corruption could be persisted.
    """

    def __init__(self, path: str, every: int = 1000, num_kept: int = 3):
        self.path = path
        self.every = every
        self.num_kept = num_kept
        self._last_saved: Optional[int] = None

    def on_step_end(self, trainer, metrics):
        step = trainer.host_step
        if self.every and step > 0 and step % self.every == 0:
            with get_tracer().span("train/checkpoint", step=step,
                                   mode="async"):
                ckpt.save_checkpoint(self.path, step, trainer.state,
                                     async_save=True,
                                     num_kept=self.num_kept)
            self._last_saved = step

    def on_train_end(self, trainer):
        step = trainer.host_step
        if step > 0 and step != self._last_saved:
            with get_tracer().span("train/checkpoint", step=step,
                                   mode="sync"):
                ckpt.save_checkpoint(self.path, step, trainer.state,
                                     async_save=False,
                                     num_kept=self.num_kept)
            self._last_saved = step
        ckpt.finalize_checkpoint()


class Trainer:
    """Minimal loop: resume → iterate batches → step → callbacks.

    The analogue of ``NeuronLTModule`` + Lightning ``Trainer.fit`` for users
    who don't bring their own loop.

    ``step_fn(state, batch) -> (state, metrics)`` as ``make_train_step``
    builds it; ``state`` its ``TrainState``. With ``resume_path`` holding a
    complete checkpoint, the newest one that verifies is copied into
    ``state`` in place. When a callback sets ``needs_prev_state`` (the
    watchdog's ``skip_step``), ``fit`` copies the whole state before every
    step, on its device: one more copy of the parameters and optimizer
    state (12 bytes a parameter with fp32 AdamW) and a device-to-device
    copy of it per step.
    """

    def __init__(self, step_fn: Callable, state: Any,
                 callbacks: Optional[List[Callback]] = None,
                 resume_path: Optional[str] = None,
                 eval_fn: Optional[Callable] = None,
                 preemption_guard: Optional[Any] = None):
        self.step_fn = step_fn
        self.eval_fn = eval_fn
        self.state = state
        self.callbacks = callbacks or []
        self.tokens_per_batch = 0
        # a resilience.PreemptionGuard: fit() honors a SIGTERM/SIGINT
        # request at the next step boundary with an emergency checkpoint
        self.preemption_guard = preemption_guard
        if preemption_guard is not None and not preemption_guard.installed:
            preemption_guard.install()
        # pre-step copy for callbacks that roll back a bad update
        # (Watchdog skip_step); only kept when a callback asks for it
        self._track_prev = any(
            getattr(cb, "needs_prev_state", False) for cb in self.callbacks)
        self._prev_state: Optional[Any] = None
        # observability: the step's count of batch shapes (alerts on a
        # second one through the shared event channel) + phase spans
        self._compile_tracker = CompileTracker.for_function(
            "trainer/step", step_fn)
        # obs handle cache, keyed by (registry, generation) so a mid-run
        # reset() rebuilds the children instead of writing into dropped
        # metrics
        self._obs_cache = None
        # host-side mirror of state.step, which callbacks read; the port's
        # step count is a host integer, so reading it never syncs
        self.host_step = int(state.step)
        if resume_path is not None and ckpt.has_checkpoint(resume_path):
            self.state, _ = ckpt.load_checkpoint(resume_path, tag=None,
                                                 target=state)
            self.host_step = int(self.state.step)
            logger.info("resumed from step %d", self.host_step)

    def fit(self, batches: Iterable, max_steps: Optional[int] = None,
            eval_batches: Optional[Iterable] = None,
            eval_every: Optional[int] = None):
        """Train; optionally evaluate every ``eval_every`` steps and once
        at the end — the validation-loop role of the reference's Lightning
        adapter. Eval metrics reach ``on_eval_end`` and the returned
        metrics dict under ``eval_*`` keys (they are NOT visible to
        ``on_step_end``, which fires before each eval)."""
        if eval_batches is not None:
            if self.eval_fn is None:
                # fail in milliseconds, not after the whole training run
                raise ValueError(
                    "fit(eval_batches=...) requires eval_fn at "
                    "construction")
            # materialise once: a one-shot generator would silently yield
            # zero batches on every eval after the first
            eval_batches = list(eval_batches)
        for cb in self.callbacks:
            cb.on_train_start(self)
        metrics: Dict = {}
        evaluated_at = -1
        tracer = get_tracer()
        reg = get_registry()
        batch_iter = iter(batches)
        while True:
            if max_steps is not None and self.host_step >= max_steps:
                break
            # phase: data — host-side input pipeline latency
            with tracer.span("train/data", step=self.host_step):
                try:
                    batch = next(batch_iter)
                except StopIteration:
                    break
            ids = batch.get("input_ids")
            self.tokens_per_batch = (int(np.prod(ids.shape))
                                     if ids is not None else 0)
            if self._track_prev:
                self._prev_state = ckpt.state_to_tree(
                    self.state, lambda t: t.detach().clone())
            # phase: step — the step call's host wall time (see the
            # module docstring)
            t0 = time.perf_counter()
            with tracer.span("train/step", step=self.host_step):
                self.state, metrics = self.step_fn(self.state, batch)
            wall_s = time.perf_counter() - t0
            self._compile_tracker.poll(wall_s=wall_s)
            self.host_step += 1
            if reg.enabled:
                cache = self._obs_cache
                if (cache is None or cache[0] is not reg
                        or cache[1] != reg.generation):
                    cache = (reg, reg.generation,
                             reg.counter("nxd_train_steps_total",
                                         "Train steps completed."),
                             reg.histogram(
                                 "nxd_train_step_seconds",
                                 "Wall time per train step (dispatch + "
                                 "any blocking compile) — the planner's "
                                 "compute-efficiency calibration "
                                 "source."))
                    self._obs_cache = cache
                cache[2].inc()
                cache[3].observe(wall_s)
            # phase: checkpoint et al. — callbacks (CheckpointCallback
            # opens its own train/checkpoint span inside)
            with tracer.span("train/callbacks", step=self.host_step):
                for cb in self.callbacks:
                    cb.on_step_end(self, metrics)
            if self._preempted():
                # step boundary: the request recorded by the signal handler
                # becomes a synchronous emergency save + resumable exit
                self._handle_preemption()
            if (eval_batches is not None and eval_every
                    and self.host_step % eval_every == 0):
                metrics.update(self.evaluate(eval_batches))
                evaluated_at = self.host_step
        if eval_batches is not None and evaluated_at != self.host_step:
            metrics.update(self.evaluate(eval_batches))
        self._prev_state = None  # a state's worth of memory, needed no more
        for cb in self.callbacks:
            cb.on_train_end(self)
        return self.state, metrics

    def _preempted(self) -> bool:
        """Whether to stop for a preemption at this boundary: this
        process's guard saw a signal, or across ranks any rank's did."""
        if self.preemption_guard is None:
            return False
        requested = self.preemption_guard.requested
        if ps.world_size() > 1:
            requested = ps.agree(float(requested), "max") > 0
        return requested

    def _checkpoint_path(self) -> Optional[str]:
        """Where an emergency save goes: the guard's explicit path, else
        the first CheckpointCallback's — the run resumes from the same
        directory it periodically checkpoints to."""
        if self.preemption_guard is not None and \
                self.preemption_guard.checkpoint_path:
            return self.preemption_guard.checkpoint_path
        for cb in self.callbacks:
            if isinstance(cb, CheckpointCallback):
                return cb.path
        return None

    def _handle_preemption(self) -> None:
        from ..resilience.preemption import TrainingPreempted

        guard = self.preemption_guard
        guard.announce(self.host_step)
        path = self._checkpoint_path()
        saved_tag = None
        if path is not None:
            saved_tag = self._emergency_save(path, guard.remaining_grace())
        else:
            logger.warning(
                "preempted with no checkpoint path (no PreemptionGuard "
                "checkpoint_path and no CheckpointCallback); flushing "
                "in-flight commits only")
            ckpt.finalize_checkpoint()
        log_event(logger, "preemption_exit", step=self.host_step,
                  saved_tag=saved_tag)
        raise TrainingPreempted(self.host_step, saved_tag)

    def _emergency_save(self, path: str, grace_s: float) -> Optional[str]:
        """Synchronous save bounded by the grace deadline. A save that
        cannot finish in time degrades to flushing the in-flight async
        commits — the last periodic checkpoint stays the resume point
        rather than a half-written emergency tag (which the commit
        protocol would reject on resume anyway)."""
        tag = str(self.host_step)
        if ps.world_size() > 1:
            # every rank saves its part on the training thread: the save's
            # collectives may not run on a deadline thread beside the
            # loop's
            try:
                ckpt.save_checkpoint(path, tag, self.state,
                                     async_save=False)
            except Exception as e:  # noqa: BLE001 - reported below
                logger.error("emergency checkpoint %s/%s failed: %r", path,
                             tag, e)
                return None
            logger.info("emergency checkpoint saved: %s/%s", path, tag)
            return tag
        box: Dict[str, Any] = {}

        def run():
            try:
                ckpt.save_checkpoint(path, tag, self.state,
                                     async_save=False)
                box["ok"] = True
            except BaseException as e:  # noqa: BLE001 - reported below
                box["err"] = e

        # daemon: if the deadline fires we abandon the writer thread so the
        # process can still exit inside the platform's kill window
        t = threading.Thread(target=run, daemon=True,
                             name="ckpt-emergency")
        t.start()
        t.join(timeout=max(grace_s, 0.0))
        if t.is_alive():
            logger.warning(
                "emergency checkpoint %s/%s exceeded the %.1fs grace "
                "deadline; falling back to flushing in-flight commits",
                path, tag, grace_s)
            try:
                ckpt.finalize_checkpoint()
            except Exception:
                logger.exception("flushing in-flight commits failed")
            return None
        if "err" in box:
            logger.error("emergency checkpoint %s/%s failed: %r — falling "
                         "back to flushing in-flight commits", path, tag,
                         box["err"])
            try:
                ckpt.finalize_checkpoint()
            except Exception:
                logger.exception("flushing in-flight commits failed")
            return None
        logger.info("emergency checkpoint saved: %s/%s", path, tag)
        return tag

    def evaluate(self, batches: Iterable) -> Dict:
        """Mean loss over ``batches`` with no gradient or optimizer work
        (under ``torch.no_grad``), through ``eval_fn(params, batch) ->
        scalar loss``; the model runs without a dropout generator, so
        attention dropout is off."""
        if self.eval_fn is None:
            raise ValueError(
                "Trainer.evaluate requires eval_fn (params, batch) -> "
                "loss; pass it at construction (e.g. lambda p, b: "
                "pm.module.loss(torch.as_tensor(b['input_ids']), "
                "torch.as_tensor(b['labels'])))")
        total, n = 0.0, 0
        with torch.no_grad():
            for batch in batches:
                total += float(self.eval_fn(self.state.params, batch))
                n += 1
        metrics = {"eval_loss": total / max(n, 1), "eval_batches": n}
        for cb in self.callbacks:
            cb.on_eval_end(self, metrics)
        return metrics
