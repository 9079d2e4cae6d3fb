"""Process-wide metrics registry: counters, gauges, histograms
(counterpart of ``neuronx_distributed_tpu/obs/metrics.py``, a copy of it:
the same names, the same seeded histogram reservoir and the same text
exposition, so the same calls give the same quantiles and the same
Prometheus text as the reference).

One registry serves the whole stack (trainer, engine, router) so every
subsystem reports health through the same pipe. Design constraints, in
order:

* **near-zero cost when disabled** — every record path checks a single
  ``enabled`` bool before touching a lock;
* **thread-safe** — the serving engine, async checkpoint commits and the
  threaded stall watchdog all record concurrently;
* **two export formats** — Prometheus text exposition for scraping, and a
  nested JSON snapshot.

Stdlib-only: importable from every layer of the package without an import
cycle.
"""

from __future__ import annotations

import math
import random
import re
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: quantiles reported for histograms in both exposition formats.
QUANTILES = (0.5, 0.9, 0.99)

#: samples kept per histogram child for quantile estimation. Beyond the
#: cap the reservoir switches to uniform replacement (Vitter's Algorithm
#: R): every observation ever recorded has the same retention probability,
#: so quantiles estimate the whole run's distribution instead of drifting
#: toward whatever the last window looked like. The replacement RNG is
#: seeded per child from the series identity, keeping long-run quantiles
#: reproducible across processes.
HISTOGRAM_RESERVOIR = 4096


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("_metric", "labels", "_value")

    def __init__(self, metric: "_MetricBase", labels: Dict[str, str]):
        self._metric = metric
        self.labels = labels
        self._value = 0.0

    # -- counter / gauge surface ------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        m = self._metric
        if not m._registry.enabled:
            return
        if m.kind == "counter" and amount < 0:
            raise ValueError("counters only go up; got inc(%r)" % amount)
        with m._registry._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._metric.kind != "gauge":
            raise TypeError("dec() is only valid on gauges")
        self.inc(-amount)

    def set(self, value: float) -> None:
        m = self._metric
        if m.kind != "gauge":
            raise TypeError("set() is only valid on gauges")
        if not m._registry.enabled:
            return
        with m._registry._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class _HistChild:
    """One histogram time series: count/sum plus a bounded reservoir."""

    __slots__ = ("_metric", "labels", "count", "sum", "min", "max",
                 "_reservoir", "_rng")

    def __init__(self, metric: "_MetricBase", labels: Dict[str, str]):
        self._metric = metric
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir: List[float] = []
        # deterministic per-series seed: quantiles over a long run are
        # reproducible, and the pinned-distribution test can assert them
        seed_key = metric.name + "|" + ",".join(
            "%s=%s" % kv for kv in sorted(labels.items()))
        self._rng = random.Random(zlib.crc32(seed_key.encode("utf-8")))

    def observe(self, value: float) -> None:
        m = self._metric
        if not m._registry.enabled:
            return
        v = float(value)
        with m._registry._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._reservoir) < HISTOGRAM_RESERVOIR:
                self._reservoir.append(v)
            else:
                # Vitter Algorithm R: keep each of the `count` samples
                # with equal probability RESERVOIR/count
                j = self._rng.randrange(self.count)
                if j < HISTOGRAM_RESERVOIR:
                    self._reservoir[j] = v

    def samples(self) -> List[float]:
        """Copy of the retained reservoir (uniform sample of the run)."""
        with self._metric._registry._lock:
            return list(self._reservoir)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the retained window (NaN if empty)."""
        with self._metric._registry._lock:
            data = sorted(self._reservoir)
        if not data:
            return math.nan
        if q <= 0:
            return data[0]
        if q >= 1:
            return data[-1]
        idx = max(0, min(len(data) - 1,
                         int(math.ceil(q * len(data))) - 1))
        return data[idx]


class _MetricBase:
    kind = "untyped"
    _child_cls: type = _Child

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: Tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.help = help
        self.label_names = label_names
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._default: Optional[Any] = None
        if not label_names:
            self._default = self._child_cls(self, {})
            self._children[()] = self._default

    def labels(self, **kv: str) -> Any:
        if set(kv) != set(self.label_names):
            raise ValueError(
                "metric %r takes labels %r, got %r"
                % (self.name, self.label_names, tuple(sorted(kv))))
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._registry._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._child_cls(
                        self, dict(zip(self.label_names, key)))
                    self._children[key] = child
        return child

    def _require_default(self) -> Any:
        if self._default is None:
            raise ValueError(
                "metric %r has labels %r; use .labels(...)"
                % (self.name, self.label_names))
        return self._default

    def children(self) -> List[Any]:
        with self._registry._lock:
            return list(self._children.values())


class Counter(_MetricBase):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._require_default().inc(amount)

    @property
    def value(self) -> float:
        return self._require_default().value


class Gauge(_MetricBase):
    kind = "gauge"

    def inc(self, amount: float = 1.0) -> None:
        self._require_default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._require_default().dec(amount)

    def set(self, value: float) -> None:
        self._require_default().set(value)

    @property
    def value(self) -> float:
        return self._require_default().value


class Histogram(_MetricBase):
    kind = "histogram"
    _child_cls = _HistChild

    def observe(self, value: float) -> None:
        self._require_default().observe(value)

    def quantile(self, q: float) -> float:
        return self._require_default().quantile(q)

    @property
    def count(self) -> int:
        return self._require_default().count

    @property
    def sum(self) -> float:
        return self._require_default().sum


class MetricsRegistry:
    """Get-or-create metric families keyed by name.

    Creation is idempotent as long as kind/labels agree — every call site
    can say ``REG.counter("nxd_x_total", labels=("kind",))`` without
    coordinating module import order.
    """

    def __init__(self, enabled: bool = True):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _MetricBase] = {}
        self.enabled = enabled
        #: bumped by :meth:`reset` — callers that cache child handles for
        #: hot-loop publishing key their cache on (registry, generation)
        #: so a reset invalidates them instead of orphaning writes.
        self.generation = 0

    # -- lifecycle --------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop all metric families (tests / fresh bench runs)."""
        with self._lock:
            self._metrics.clear()
            self.generation += 1

    # -- family constructors ----------------------------------------
    def _get_or_create(self, cls: type, name: str, help: str,
                       labels: Sequence[str]) -> Any:
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError("invalid label name %r" % ln)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != label_names:
                    raise ValueError(
                        "metric %r already registered as %s%r"
                        % (name, m.kind, m.label_names))
                return m
            m = cls(self, name, help, label_names)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    def get(self, name: str) -> Optional[_MetricBase]:
        with self._lock:
            return self._metrics.get(name)

    # -- export -----------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append("# HELP %s %s" % (m.name, m.help))
            ptype = "summary" if m.kind == "histogram" else m.kind
            lines.append("# TYPE %s %s" % (m.name, ptype))
            for child in m.children():
                base = _label_str(child.labels)
                if m.kind == "histogram":
                    if child.count == 0:
                        continue
                    for q in QUANTILES:
                        lbl = dict(child.labels)
                        lbl["quantile"] = str(q)
                        lines.append("%s%s %s" % (
                            m.name, _label_str(lbl),
                            _fmt_value(child.quantile(q))))
                    lines.append("%s_sum%s %s"
                                 % (m.name, base, _fmt_value(child.sum)))
                    lines.append("%s_count%s %s"
                                 % (m.name, base, _fmt_value(child.count)))
                else:
                    lines.append("%s%s %s"
                                 % (m.name, base, _fmt_value(child.value)))
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """Nested JSON-ready snapshot: metric -> samples with labels."""
        out: Dict[str, Any] = {}
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            samples = []
            for child in m.children():
                if m.kind == "histogram":
                    if child.count == 0:
                        continue
                    entry: Dict[str, Any] = {
                        "labels": child.labels,
                        "count": child.count,
                        "sum": child.sum,
                        "min": child.min,
                        "max": child.max,
                    }
                    for q in QUANTILES:
                        entry["p%g" % (q * 100)] = child.quantile(q)
                else:
                    entry = {"labels": child.labels, "value": child.value}
                samples.append(entry)
            out[m.name] = {"type": m.kind, "samples": samples}
        return out


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (k, _escape_label_value(str(v)))
                     for k, v in sorted(labels.items()))
    return "{%s}" % inner


#: the process-wide default registry; disabled until ``obs.enable()``
#: (or ``NXD_OBS=1``) so instrumented hot paths cost one bool check.
_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                import os

                _DEFAULT = MetricsRegistry(
                    enabled=os.environ.get("NXD_OBS", "0") == "1")
    return _DEFAULT
