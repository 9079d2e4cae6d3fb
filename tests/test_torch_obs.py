"""The port's ``obs`` package against the JAX package's: the same calls
give the same Prometheus text and snapshot (the seeded histogram
reservoir's quantiles included), the same span records and stats keys,
the same request traces, events, SLO evaluations and compile and wire
accounting. Each side uses registries and tracers of its own; the
process-wide defaults are reset and disabled after each test."""

import json
import logging
import math

import numpy as np
import pytest

from neuronx_distributed_tpu import obs as jobs
from neuronx_distributed_tpu.obs import accounting as jacc
from neuronx_distributed_tpu.obs import slo as jslo
from neuronx_distributed_tpu.obs import tracing as jtracing
from neuronx_distributed_tpu_torch import obs as tobs
from neuronx_distributed_tpu_torch.obs import accounting as tacc
from neuronx_distributed_tpu_torch.obs import metrics as tmetrics
from neuronx_distributed_tpu_torch.obs import slo as tslo
from neuronx_distributed_tpu_torch.obs import tracing as ttracing

BOTH = {"jax": jobs, "torch": tobs}


@pytest.fixture(autouse=True)
def _clean_defaults():
    for o in BOTH.values():
        o.reset()
    yield
    for o in BOTH.values():
        o.disable()
        o.reset()


def _drive_registry(o, n_hist=10_000):
    """The same sequence of calls on a fresh registry of package ``o``:
    counters with and without labels, a gauge, label values that need
    escaping, and histograms past the reservoir's 4096 samples."""
    reg = o.MetricsRegistry()
    c = reg.counter("nxd_a_total", "A counter.")
    c.inc()
    c.inc(2.5)
    lab = reg.counter("nxd_b_total", "By kind.", labels=("kind",))
    lab.labels(kind="x").inc(3)
    lab.labels(kind='q"uo\\te\nnl').inc()
    g = reg.gauge("nxd_g", "A gauge.")
    g.set(7)
    g.dec(0.25)
    h = reg.histogram("nxd_h_seconds", "A histogram.")
    rng = np.random.RandomState(0)
    for v in rng.lognormal(size=n_hist):
        h.observe(float(v))
    hl = reg.histogram("nxd_hl_seconds", "Labelled.", labels=("site",))
    for i, v in enumerate(rng.rand(5000)):
        hl.labels(site="s%d" % (i % 3)).observe(float(v))
    reg.histogram("nxd_empty_seconds", "Never observed.")
    reg.counter("nxd_nohelp_total").inc()
    return reg


def test_prometheus_text_and_snapshot_match_jax():
    regs = {k: _drive_registry(o) for k, o in BOTH.items()}
    assert regs["torch"].to_prometheus() == regs["jax"].to_prometheus()
    assert regs["torch"].snapshot() == regs["jax"].snapshot()
    text = regs["torch"].to_prometheus()
    assert "# TYPE nxd_h_seconds summary" in text
    assert 'kind="q\\"uo\\\\te\\nnl"' in text


@pytest.mark.parametrize("n", [100, 4096, 4097, 20_000])
def test_histogram_quantiles_match_jax(n):
    """Below, at and past the reservoir's size: the replacement draws come
    from ``random.Random(crc32(series))`` in both, so the retained samples,
    and with them every quantile, are equal."""
    hs = {k: _drive_registry(o, n).get("nxd_h_seconds")
          for k, o in BOTH.items()}
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert hs["torch"].quantile(q) == hs["jax"].quantile(q)
    assert hs["torch"]._default.samples() == hs["jax"]._default.samples()
    assert len(hs["torch"]._default.samples()) == min(
        n, tmetrics.HISTOGRAM_RESERVOIR)
    assert (hs["torch"].count, hs["torch"].sum) == (hs["jax"].count,
                                                    hs["jax"].sum)


def test_registry_rules_match_jax():
    for o in BOTH.values():
        reg = o.MetricsRegistry()
        reg.counter("nxd_x_total", labels=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("nxd_x_total")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")
        with pytest.raises(ValueError, match="takes labels"):
            reg.get("nxd_x_total").labels(b="1")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("nxd_y_total").inc(-1)
        with pytest.raises(ValueError, match="use .labels"):
            reg.get("nxd_x_total").inc()
        off = o.MetricsRegistry(enabled=False)
        off.counter("nxd_z_total").inc()
        off.histogram("nxd_h").observe(1.0)
        assert off.get("nxd_z_total").value == 0
        assert off.get("nxd_h").count == 0
        gen = reg.generation
        reg.reset()
        assert reg.generation == gen + 1 and reg.get("nxd_x_total") is None


def test_default_registry_follows_nxd_obs(monkeypatch):
    """Off by default; ``NXD_OBS=1`` turns the first default on."""
    monkeypatch.setattr(tmetrics, "_DEFAULT", None)
    monkeypatch.delenv("NXD_OBS", raising=False)
    assert not tmetrics.get_registry().enabled
    monkeypatch.setattr(tmetrics, "_DEFAULT", None)
    monkeypatch.setenv("NXD_OBS", "1")
    assert tmetrics.get_registry().enabled
    assert tmetrics.get_registry() is tmetrics.get_registry()


def _drive_tracer(t):
    with t.span("outer", step=1) as s:
        s.set_attribute("k", "v")
        with t.span("inner"):
            pass
        with t.span("inner", i=2):
            pass
    with pytest.raises(KeyError):
        with t.span("failing"):
            raise KeyError("x")
    t.mark_event_start("named")
    t.mark_event_end("named")
    t.mark_event_end("never_started")
    with t.event("ev"):
        pass
    t.mark_event_start("left_open")
    return t


def _records(trace):
    return [(e["name"], e["ph"], e.get("args"))
            for e in trace["traceEvents"]]


def test_span_records_and_stats_keys_match_jax():
    tr = {k: _drive_tracer(o.SpanTracer()) for k, o in BOTH.items()}
    recs = {k: _records(t.chrome_trace()) for k, t in tr.items()}
    # open_for_us is a duration; the rest of the records must agree
    for k in recs:
        for _, _, args in recs[k]:
            if args and "open_for_us" in args:
                args["open_for_us"] = 0
    assert recs["torch"] == recs["jax"]
    names = [r[0] for r in recs["torch"]]
    assert names == ["inner", "inner", "outer", "failing", "named", "ev",
                     "left_open"]
    assert recs["torch"][0][2] == {"parent": "outer"}
    assert recs["torch"][3][2] == {"error": "KeyError"}
    stats = {k: t.stats() for k, t in tr.items()}
    assert {n: sorted(s) for n, s in stats["torch"].items()} == {
        n: sorted(s) for n, s in stats["jax"].items()}
    assert {n: s["count"] for n, s in stats["torch"].items()} == {
        n: s["count"] for n, s in stats["jax"].items()}
    assert sorted(stats["torch"]["inner"]) == [
        "count", "max_us", "mean_us", "min_us", "p50_us", "p90_us",
        "p99_us", "total_us"]


def test_disabled_tracer_records_nothing():
    for o in BOTH.values():
        t = o.SpanTracer(enabled=False)
        with t.span("x") as s:
            s.set_attribute("a", 1)
        t.mark_event_start("y")
        t.mark_event_end("y")
        assert t.request_begin("r") is None
        assert t.chrome_trace() == {"traceEvents": []} and t.stats() == {}


def test_ring_buffer_keeps_the_newest_spans_in_order():
    for o in BOTH.values():
        t = o.SpanTracer(max_events=3)
        for i in range(5):
            with t.span("s%d" % i):
                pass
        assert [e["name"] for e in t.chrome_trace()["traceEvents"]] == [
            "s2", "s3", "s4"]
        assert t.stats()["s0"]["count"] == 1.0


def _drive_requests(t):
    out = [t.request_begin("a", tenant="t1"),
           t.request_begin("a", extra=1),
           t.request_begin("b", trace_id="tid-b")]
    t.request_annotate("a", note="n")
    t.request_phase_begin("a", "queue")
    t.request_phase_end("a", "queue")
    t.request_mark("a", "resubmit")
    t.request_slices([("a", "prefill", 5.0), ("a", "decode", 7.0),
                      ("b", "decode", 3.0), ("zz", "decode", 1.0)])
    t.request_phase_begin("b", "queue")
    out.append(t.request_trace_id("b"))
    ticket = t.request_export("b")
    out.append(sorted(ticket))
    out.append((ticket["phase_n"], ticket["migrations"], ticket["attrs"]))
    t.request_import(ticket)
    t.request_mark("b", "decode", 2.0)
    sa = t.request_end("a", outcome="completed", finish="eos")
    sb = t.request_end("b", outcome="failed")
    out.append(t.request_end("zz"))
    for s in (sa, sb):
        out.append((sorted(s), s["outcome"], s["trace_id"],
                    sorted(s["phase_us"])))
    ev = [e for e in t.chrome_trace()["traceEvents"]]
    for e in ev:
        args = e["args"]
        out.append((e["name"], e["tid"], sorted(args), args["phase_n"],
                    args["outcome"], args.get("migrations"),
                    args.get("finish")))
    out.append(sorted(t.stats()))
    return out


def test_request_traces_match_jax():
    got = {k: _drive_requests(o.SpanTracer()) for k, o in BOTH.items()}
    assert got["torch"] == got["jax"]
    assert ttracing.MAX_LIVE_REQUESTS == jtracing.MAX_LIVE_REQUESTS


def test_profile_step_writes_a_torch_profiler_trace(tmp_path):
    """``profile_step`` goes over ``torch.profiler``: the block's host span
    carries the logdir, and the trace handler writes a chrome trace
    there."""
    import torch

    t = ttracing.SpanTracer()
    logdir = str(tmp_path / "prof")
    with t.profile_step(logdir) as d:
        torch.ones(4).sum()
    assert d == logdir
    (ev,) = t.chrome_trace()["traceEvents"]
    assert ev["name"] == "profile_step" and ev["args"] == {"logdir": logdir}
    written = list((tmp_path / "prof").iterdir())
    assert written and json.loads(written[0].read_text())["traceEvents"]


def test_events_count_and_fan_out_like_jax(caplog):
    seen = {}
    for k, o in BOTH.items():
        o.enable()
        got = []
        unsub = o.subscribe(lambda e, f, got=got: got.append((e, f)))
        o.subscribe(lambda e, f: 1 / 0)  # a failing subscriber is logged
        o.emit_event("drill", step=3, why="x")
        o.emit_event("drill", step=4)
        unsub()
        o.emit_event("other")
        seen[k] = (got, o.get_registry().snapshot())
        from importlib import import_module

        events = import_module(o.__name__ + ".events")
        events._SUBSCRIBERS.clear()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1]["nxd_events_total"]["samples"] == [
        {"labels": {"event": "drill"}, "value": 2.0},
        {"labels": {"event": "other"}, "value": 1.0}]


def test_log_event_goes_through_the_event_channel(caplog):
    """The port's ``log_event`` writes the ``NXD_EVENT`` line and counts
    the event, as the reference's does."""
    from neuronx_distributed_tpu_torch.utils.logger import (get_logger,
                                                            log_event)

    tobs.enable()
    got = []
    unsub = tobs.subscribe(lambda e, f: got.append((e, f)))
    logger = get_logger("neuronx_distributed_tpu_torch.test_obs")
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            log_event(logger, "watchdog_anomaly", step=2, reason="r")
    finally:
        logger.propagate = False
        unsub()
    assert got == [("watchdog_anomaly", {"step": 2, "reason": "r"})]
    assert 'NXD_EVENT {"event": "watchdog_anomaly", "reason": "r", ' \
           '"step": 2}' in caplog.text
    assert tobs.get_registry().get("nxd_events_total").labels(
        event="watchdog_anomaly").value == 1


def _drive_slo(slo_mod, o):
    reg = o.MetricsRegistry()
    events = []
    unsub = o.subscribe(lambda e, f: events.append((e, f)))
    pol = slo_mod.slo_from_dict(dict(name="gold", ttft_p99_s=0.5,
                                     tpot_p99_s=0.05, availability=0.9,
                                     error_rate=0.1, window=9,
                                     min_samples=4, breach_patience=2,
                                     unknown_key=1))
    mon = slo_mod.SloMonitor(pol, registry=reg)
    out = [pol.targeted()]
    rng = np.random.RandomState(1)
    for i in range(16):
        bad = 4 <= i < 8
        for _ in range(3):
            mon.observe(ttft_s=float(rng.rand() * (2.0 if bad else 0.4)),
                        tpot_s=0.01, ok=not (bad and i % 2))
        st = mon.evaluate(availability=0.8 if i == 5 else 1.0)
        out.append((st.compliant, st.breached, st.samples,
                    {k: (None if math.isnan(v) else v)
                     for k, v in st.measured.items()},
                    st.targets, st.attainment("ttft_p99_s"),
                    st.attainment("availability"), mon.breached))
    unsub()
    out.append(events)
    out.append(reg.to_prometheus())
    return out


def test_slo_monitor_matches_jax():
    got = {k: _drive_slo(m, o) for k, m, o in (
        ("jax", jslo, jobs), ("torch", tslo, tobs))}
    assert got["torch"] == got["jax"]
    assert any(e == "slo_breach" for e, _ in got["torch"][-2])
    assert any(e == "slo_recovered" for e, _ in got["torch"][-2])


def _drive_accounting(acc, o):
    reg = o.MetricsRegistry()
    events = []
    unsub = o.subscribe(lambda e, f: events.append((e, sorted(f))))
    sizes = iter([None, 1, 1, 1, 2, 2, 4])
    tr = acc.CompileTracker("site/a", lambda: next(sizes), registry=reg)
    out = [tr.poll(wall_s=0.5) for _ in range(7)]
    quiet = acc.CompileTracker("site/b", lambda: 3, registry=reg,
                               alert=False)
    out.append(quiet.poll())
    out.append(acc.compile_events(reg))
    acc.record_wire_bytes("grad_all_reduce", "int8", 250.0, 1000.0,
                          registry=reg)
    acc.record_wire_bytes("grad_all_reduce", "int8", 250.0, 1000.0,
                          registry=reg)
    acc.record_collective_time("ici", 4096, 0.25, registry=reg)
    out.append(acc.wire_totals(reg))
    out.append(acc.wire_compression_ratio(reg))
    out.append(reg.to_prometheus())
    unsub()
    out.append(events)
    return out


def test_compile_and_wire_accounting_match_jax():
    got = {k: _drive_accounting(a, o) for k, a, o in (
        ("jax", jacc, jobs), ("torch", tacc, tobs))}
    assert got["torch"] == got["jax"]
    assert [e for e, _ in got["torch"][-1]] == ["recompile_detected"] * 2


def test_compile_tracker_reads_a_step_or_an_engine():
    """The port's ``cache_size`` reads ``cache_size()`` (the train step's
    count of batch shapes) or ``compile_count()`` (the serving engine's
    count of step shapes)."""
    class Step:
        def cache_size(self):
            return 1

    class Engine:
        def compile_count(self):
            return 2

    assert tacc.cache_size(Step()) == 1
    assert tacc.cache_size(Engine()) == 2
    assert tacc.cache_size(lambda: 0) is None
    tobs.enable()
    tr = tacc.CompileTracker.for_function("engine", Engine())
    assert tr.poll(wall_s=0.1) == 2
    text = tobs.get_registry().to_prometheus()
    assert 'nxd_compile_total{site="engine"} 2' in text
    assert 'nxd_recompile_total{site="engine"} 1' in text
