"""Deterministic fault injection for checkpoint storage and serving
(counterpart of ``neuronx_distributed_tpu/resilience/chaos.py``: the same
DSL, and for the same seed and the same operations the same faults in the
same order).

:class:`ChaosCheckpointStorage` wraps any ``BaseCheckpointStorage`` and
injects faults according to a :class:`FaultPlan` — a small, seed-driven DSL
of :class:`FaultRule` entries. Faults are *deterministic* for a given
(seed, op sequence): the same plan replayed over the same operations injects
the same faults, so chaos tests are reproducible bit-for-bit.

Storage fault kinds:

* ``transient`` — raises :class:`InjectedFault` (a ``ConnectionError``
  subclass carrying a throttle marker) that ``_is_transient`` classifies as
  retriable; proves the retry/backoff path heals real hiccups.
* ``permanent`` — raises ``OSError(ENOSPC)``, a deterministic local
  condition that must surface immediately (no retries burned).
* ``latency`` — sleeps ``latency_s`` before the op (host-side only).

Serving fault kinds (a router's drills, where
``op`` is the lifecycle point — ``step`` — and ``path`` is the replica
name):

* ``crash`` — raises :class:`ReplicaCrashed`: the replica process/host is
  gone and every in-flight request on it must fail over.
* ``exhaust`` — a KV block-pool exhaustion storm signal (raised as
  ``CacheExhaustedError`` through :meth:`FaultPlan.apply`).
* ``preempt`` — a SIGTERM-style eviction notice mid-flight (spot/
  maintenance): unlike ``crash``, the replica gets a drain window, so the
  router *migrates* its live sessions instead of failing them over.
  Consult-only — :meth:`FaultPlan.apply` treats it as a no-op directive.
* ``scale_burst`` — a fleet-level load-spike signal (matched against the
  router's ``consult("scale", "fleet")`` tick) directing an immediate
  scale-up; also consult-only.
* ``bitflip`` — a silent-data-corruption event: the consulting layer
  flips one bit at the seeded position (``bit=<n>``, or drawn from the
  plan RNG when unset) in whatever it guards — a param leaf at an
  integrity cadence boundary (``consult_detail("integrity", "params")``),
  a decoded token on a serving replica, a wire payload. Consult-only like
  ``preempt``: corruption is injected by the caller, never raised. See
  ``resilience/integrity.py``.

Link fault kinds (a KV handoff link, where ``op`` is ``"link"`` and
``path`` is the route, e.g. ``p0->d0``; all consult-only — the carrier
enacts them on the chunk in transit):

* ``link_drop`` — the chunk vanishes in transit (never delivered); the
  sender heals it through ACK-timeout retransmission.
* ``link_corrupt`` — one bit of the chunk payload flips in transit
  (``bit=<n>`` or drawn from the plan RNG); the receiver's fingerprint
  check NACKs it and the sender retransmits.
* ``link_delay`` — the chunk arrives ``latency=<s>`` late (virtual time;
  out-of-order arrival at the receiver, duplicate retransmits possible).
* ``link_partition`` — the link goes down for ``latency=<s>`` seconds
  (indefinitely when unset): in-flight chunks are lost and later sends
  die silently, so the sender's bounded retransmit budget exhausts, the
  stream aborts, and the router falls back to local re-prefill.

A router consults the plan through :meth:`FaultPlan.consult`, which
*returns* the directive instead of raising/sleeping, so injected latency is
virtual (deterministic under fake clocks) and the caller decides how a
crash or an exhaustion storm manifests.

The plan is buildable programmatically or parsed from a compact spec
string::

    seed=7; save_text|*/checkpoint : transient, p=0.5, times=2; * : latency=0.01
    step|r1 : crash, after=6, times=1        # kill replica r1 at its 7th step

Each ``;``-separated clause is ``op[|pathglob] : kind-and-options`` where
options are ``p=<prob>``, ``after=<n calls>``, ``times=<max fires>``,
``latency=<seconds>``, ``bit=<position>`` (bitflip rules only). A leading
``seed=<int>`` clause seeds the RNG.

The port's router, transport and KV migration come later; the storage
kinds run against the port's checkpoint engine through
``checkpoint_storage.install_storage_wrapper(wrapper_for_plan(plan))``.
The engine writes and reads the payload itself, beside the storage (as
the reference's Orbax does), so faults land on the control plane: the
markers, the manifest, listings and the digests' reads.
"""

from __future__ import annotations

import dataclasses
import errno
import fnmatch
import random
import threading
import time
from typing import Any, List, Optional, Tuple

from ..trainer.checkpoint_storage import (BaseCheckpointStorage,
                                          retry_with_backoff)


class InjectedFault(ConnectionError):
    """A chaos-injected transient fault. The message carries a throttle
    marker so ``_is_transient`` classifies it exactly like a real S3
    503 slow-down."""


class ReplicaCrashed(RuntimeError):
    """A chaos-injected (or observed) serving-replica death: the engine
    behind it is gone and its in-flight requests must be resubmitted."""


@dataclasses.dataclass
class FaultRule:
    """One injection rule; all matching is AND-ed.

    ``op``/``path`` are ``fnmatch`` globs over the storage method name and
    its path argument. ``after`` skips the first N matching calls; ``times``
    caps how often the rule fires (-1 = unlimited); ``prob`` is the
    per-matching-call fire probability drawn from the plan's seeded RNG.
    """

    op: str = "*"
    path: str = "*"
    kind: str = "transient"  # transient|permanent|latency|crash|exhaust
    prob: float = 1.0        # |preempt|scale_burst|bitflip|link_*
    after: int = 0
    times: int = -1
    latency_s: float = 0.0
    bit: int = -1            # bitflip position; -1 = draw from plan RNG

    _KINDS = ("transient", "permanent", "latency", "crash", "exhaust",
              "preempt", "scale_burst", "bitflip",
              "link_drop", "link_corrupt", "link_delay", "link_partition")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"({' | '.join(self._KINDS)})")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")

    def matches(self, op: str, path: str) -> bool:
        return (fnmatch.fnmatch(op, self.op)
                and fnmatch.fnmatch(path, self.path))


class FaultPlan:
    """A seeded sequence of :class:`FaultRule` with per-rule fire state.

    Thread-safe: async commit threads and the training thread hit the same
    storage object concurrently, so match counting and the RNG draw are
    serialized under one lock.
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._matched = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)
        self.injected: List[str] = []  # audit log: "kind op path"

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the spec DSL (see module docstring)."""
        seed = 0
        rules: List[FaultRule] = []
        for clause in (c.strip() for c in spec.split(";")):
            if not clause:
                continue
            if clause.replace(" ", "").startswith("seed="):
                seed = int(clause.split("=", 1)[1])
                continue
            if ":" not in clause:
                raise ValueError(
                    f"bad fault clause {clause!r}: expected "
                    "'op[|pathglob] : kind-and-options'")
            target, opts = (s.strip() for s in clause.split(":", 1))
            op, _, path = (s.strip() for s in target.partition("|"))
            kw: dict = {"op": op or "*", "path": path or "*"}
            kind = None
            for item in (o.strip() for o in opts.split(",")):
                if not item:
                    continue
                if "=" in item:
                    k, v = (s.strip() for s in item.split("=", 1))
                    if k == "p":
                        kw["prob"] = float(v)
                    elif k == "after":
                        kw["after"] = int(v)
                    elif k == "times":
                        kw["times"] = int(v)
                    elif k == "latency":
                        kw["latency_s"] = float(v)
                        kind = kind or "latency"
                    elif k == "bit":
                        kw["bit"] = int(v)
                        kind = kind or "bitflip"
                    else:
                        raise ValueError(f"unknown fault option {k!r}")
                else:
                    kind = item
            kw["kind"] = kind or "transient"
            rules.append(FaultRule(**kw))
        return cls(rules, seed=seed)

    def fire_count(self) -> int:
        with self._lock:
            return sum(self._fired)

    def _fire(self, op: str, path: str) -> Tuple[Optional[str], float, dict]:
        """Match + fire every rule for (op, path) under the lock; returns
        ``(first_raising_kind_or_None, max_latency_s, detail)``. Fire
        bookkeeping (``after``/``times``/``prob`` draws, the audit log)
        happens here so :meth:`apply` and :meth:`consult` share one
        deterministic stream. ``detail`` carries rule payloads the caller
        needs to enact a directive (``bit`` for bitflips — pinned by the
        rule, or drawn from the seeded RNG so drills replay bit-for-bit)."""
        kind: Optional[str] = None
        latency_s = 0.0
        detail: dict = {}
        with self._lock:
            for i, rule in enumerate(self.rules):
                if not rule.matches(op, path):
                    continue
                self._matched[i] += 1
                if self._matched[i] <= rule.after:
                    continue
                if rule.times >= 0 and self._fired[i] >= rule.times:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                self._fired[i] += 1
                self.injected.append(f"{rule.kind} {op} {path}")
                if rule.kind == "latency":
                    latency_s = max(latency_s, rule.latency_s)
                elif kind is None:
                    kind = rule.kind
                    if rule.kind in ("bitflip", "link_corrupt"):
                        detail["bit"] = (rule.bit if rule.bit >= 0
                                         else self._rng.getrandbits(20))
                    if rule.kind in ("link_delay", "link_partition"):
                        # the rule's latency payload rides in detail: a
                        # delay's added transit time / a partition's
                        # healing window (0 = partitioned indefinitely)
                        detail["latency_s"] = rule.latency_s
        return kind, latency_s, detail

    def consult(self, op: str, path: str) -> Tuple[Optional[str], float]:
        """Like :meth:`apply` but *returns* the directive instead of
        raising/sleeping: ``(kind | None, latency_s)``. Serving chaos goes
        through here — the router interprets ``crash``/``exhaust`` itself
        and treats latency as virtual time, so drills stay deterministic
        under fake clocks."""
        kind, latency_s, _ = self._fire(op, path)
        return kind, latency_s

    def consult_detail(self, op: str, path: str) -> Tuple[Optional[str],
                                                          float, dict]:
        """:meth:`consult` plus the firing rule's payload — ``detail``
        holds ``{"bit": <position>}`` when a ``bitflip`` directive fires
        (the integrity monitor and the router's SDC drill need the seeded
        position to enact the flip deterministically)."""
        return self._fire(op, path)

    def apply(self, op: str, path: str) -> None:
        """Consult every rule for this (op, path); raise/sleep as directed.

        The first raising rule wins; latency rules sleep and keep going so a
        latency+transient combination behaves like a slow failing store.
        """
        kind, sleep_s, _ = self._fire(op, path)
        if sleep_s > 0:
            time.sleep(sleep_s)
        if kind == "transient":
            raise InjectedFault(
                f"chaos: injected transient fault on {op}({path!r}) "
                "— 503 slow down")
        if kind == "permanent":
            raise OSError(
                errno.ENOSPC,
                f"chaos: injected permanent fault on {op}({path!r})"
                " — no space left on device")
        if kind == "crash":
            raise ReplicaCrashed(
                f"chaos: injected replica crash on {op}({path!r})")
        if kind == "exhaust":
            # lazy import: resilience must not depend on inference at
            # module load (the router imports this package)
            from ..inference.paging import CacheExhaustedError

            raise CacheExhaustedError(
                f"chaos: injected pool-exhaustion storm on {op}({path!r})")
        # preempt / scale_burst / bitflip and the link_* kinds are
        # consult-only directives: they model orchestrator signals
        # (eviction notice, load spike) or in-band transit faults the
        # caller must enact itself (the DcnLink carrier), not storage
        # failures, so apply() has nothing to raise for them.


class ChaosCheckpointStorage(BaseCheckpointStorage):
    """Fault-injecting wrapper over any storage backend (``inner``).

    Every control-plane op consults the plan *before* delegating, then runs
    under the same ``retry_with_backoff`` policy the object-store backend
    uses — injected transients heal through real retries, injected
    permanents surface immediately, exercising the full classification
    path (``retries=False`` bypasses the retry layer to observe raw
    faults).
    """

    def __init__(self, inner: BaseCheckpointStorage, plan: FaultPlan,
                 retries: bool = True, **retry_kwargs: Any):
        super().__init__(inner.dirname())
        self.inner = inner
        self.plan = plan
        self._retries = retries
        self._retry_kwargs = retry_kwargs

    def _run(self, op: str, path: str, fn):
        def attempt():
            self.plan.apply(op, path)
            return fn()
        if self._retries:
            return retry_with_backoff(**self._retry_kwargs)(attempt)()
        return attempt()

    def dir_exists(self, dirname: str) -> bool:
        return self._run("dir_exists", dirname,
                         lambda: self.inner.dir_exists(dirname))

    def file_exists(self, filename: str) -> bool:
        return self._run("file_exists", filename,
                         lambda: self.inner.file_exists(filename))

    def create_dir(self, dirname: str) -> None:
        return self._run("create_dir", dirname,
                         lambda: self.inner.create_dir(dirname))

    def list_dirs(self, dirname: str) -> List[str]:
        return self._run("list_dirs", dirname,
                         lambda: self.inner.list_dirs(dirname))

    def list_files(self, dirname: str):
        return self._run("list_files", dirname,
                         lambda: self.inner.list_files(dirname))

    def file_size(self, filename: str):
        return self._run("file_size", filename,
                         lambda: self.inner.file_size(filename))

    def remove_dir(self, dirname: str) -> None:
        return self._run("remove_dir", dirname,
                         lambda: self.inner.remove_dir(dirname))

    def remove_file(self, filename: str) -> None:
        return self._run("remove_file", filename,
                         lambda: self.inner.remove_file(filename))

    def save_text(self, text: str, filename: str) -> None:
        return self._run("save_text", filename,
                         lambda: self.inner.save_text(text, filename))

    def load_text(self, filename: str) -> str:
        return self._run("load_text", filename,
                         lambda: self.inner.load_text(filename))

    def read_bytes(self, filename: str):
        return self._run("read_bytes", filename,
                         lambda: self.inner.read_bytes(filename))

    def save_bytes(self, data: bytes, filename: str) -> None:
        return self._run("save_bytes", filename,
                         lambda: self.inner.save_bytes(data, filename))


def wrapper_for_plan(plan: FaultPlan, retries: bool = True,
                     **retry_kwargs: Any):
    """A factory suitable for ``checkpoint_storage.install_storage_wrapper``
    — every storage the engine creates gets chaos-wrapped with ``plan``."""
    def wrap(inner: BaseCheckpointStorage) -> ChaosCheckpointStorage:
        if isinstance(inner, ChaosCheckpointStorage):
            return inner  # never stack chaos on chaos
        return ChaosCheckpointStorage(inner, plan, retries=retries,
                                      **retry_kwargs)
    return wrap
