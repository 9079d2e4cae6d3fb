"""The PyTorch port's ReplicaRouter against the JAX package's
(``neuronx_distributed_tpu/inference/router.py``), mirroring the scenarios
of tests/test_router.py, the router tests of tests/test_prefix_sharing.py
and tests/test_obs_slo.py: each scenario runs in both packages on the same
weights, prompts and ``FaultPlan`` under ``clock=lambda: 0.0``, and every
``RouterResult`` field, ``RouterStats.to_dict()``, the event sequence
(``warm`` left out) and the ``nxd_router_*`` metrics must be equal.

Then what is the port's own: one copy of the weights for every replica,
a dropped replica's engine freed without a garbage collection, and the
refusal of ``RouterConfig.long_context_*`` and the executable cache's
leases under scaling."""

import dataclasses
import gc
import os
import signal
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import neuronx_distributed_tpu.obs as jobs
from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import router as jr
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.obs.events import subscribe as jsubscribe
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.resilience.chaos import FaultPlan as JPlan
from neuronx_distributed_tpu.resilience import preemption as jpre
from neuronx_distributed_tpu.obs.slo import SloPolicy as JSloPolicy
import neuronx_distributed_tpu_torch.obs as tobs
from neuronx_distributed_tpu_torch.inference import aot_cache as tac
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import router as tr
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.obs.events import subscribe as tsubscribe
from neuronx_distributed_tpu_torch.obs.slo import SloPolicy as TSloPolicy
from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan as TPlan
from neuronx_distributed_tpu_torch.resilience import preemption as tpre

SYS = list(range(1, 13))                 # 12 tokens = 3 full blocks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """tests/test_router.py's tiny model as JAX params and the port's state
    dict."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    return jcfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


class Pkg:
    """One package's router surface, so that a scenario is written once."""

    def __init__(self, name, models):
        self.name = name
        jcfg, params, tcfg, sd = models
        if name == "jax":
            self.eng, self.rt, self.Plan = je, jr, JPlan
            self.cfg, self.params = jcfg, params
            self.obs, self.subscribe, self.pre = jobs, jsubscribe, jpre
            self.SloPolicy = JSloPolicy
        else:
            self.eng, self.rt, self.Plan = te, tr, TPlan
            self.cfg, self.params = tcfg, sd
            self.obs, self.subscribe, self.pre = tobs, tsubscribe, tpre
            self.SloPolicy = TSloPolicy

    def ecfg(self, **kw):
        base = dict(block_size=4, num_blocks=16, max_slots=2,
                    max_blocks_per_seq=8, token_budget=8)
        base.update(kw)
        if self.name == "jax":
            base.setdefault("kv_dtype", jnp.float32)
        return self.eng.EngineConfig(**base)

    def router(self, rcfg=None, ecfg=None, **kw):
        kw.setdefault("clock", lambda: 0.0)
        if self.name == "jax":
            ps.initialize_model_parallel()
        else:
            kw.setdefault("device", "cpu")
        return self.rt.ReplicaRouter(
            self.cfg, self.params, ecfg or self.ecfg(),
            rcfg or self.rt.RouterConfig(num_replicas=2), **kw)

    def drill(self, fn, *args, **kw):
        kw.setdefault("clock", lambda: 0.0)
        if self.name == "jax":
            ps.initialize_model_parallel()
        else:
            kw.setdefault("device", "cpu")
        return getattr(self.rt, fn)(self.cfg, self.params, *args, **kw)


def _prompts(n, length=6, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (length,)).tolist() for _ in range(n)]


def _router_metrics(pkg):
    """The ``nxd_router_*`` lines of the registry's Prometheus text."""
    return [ln for ln in pkg.obs.get_registry().to_prometheus().splitlines()
            if ln.startswith("nxd_router_")]


def _both(models, scenario, obs_on=False):
    """Run ``scenario(pkg) -> router`` in each package; return per package
    the router, the events seen (``warm`` dropped) and the router metrics."""
    out = {}
    for name in ("jax", "torch"):
        pkg = Pkg(name, models)
        seen = []
        unsub = pkg.subscribe(lambda e, f: seen.append(
            (e, {k: v for k, v in f.items() if k != "warm"})))
        if obs_on:
            pkg.obs.reset()
            pkg.obs.enable()
        try:
            router = scenario(pkg)
            metrics = _router_metrics(pkg) if obs_on else []
        finally:
            unsub()
            if obs_on:
                pkg.obs.reset()
                pkg.obs.disable()
        out[name] = dict(router=router, events=seen, metrics=metrics)
    return out["jax"], out["torch"]


def _assert_same(j, t):
    jr_, tr_ = j["router"], t["router"]
    assert set(tr_.results) == set(jr_.results)
    for uid in jr_.results:
        assert dataclasses.asdict(tr_.results[uid]) == dataclasses.asdict(
            jr_.results[uid]), uid
    assert tr_.stats.to_dict() == jr_.stats.to_dict()
    assert tr_.stats_dict() == jr_.stats_dict()
    assert t["events"] == j["events"]
    assert t["metrics"] == j["metrics"]
    assert [(r.name, r.state, r.generation, r.tier)
            for r in tr_.replicas] == [(r.name, r.state, r.generation,
                                        r.tier) for r in jr_.replicas]


def _submit_run(router, prompts, n_new=4, **kw):
    for i, p in enumerate(prompts):
        router.submit(p, n_new, uid=f"req{i}", **kw)
    router.run()
    return router


# ---------------------------------------------------------------------------
# tests/test_router.py
# ---------------------------------------------------------------------------

def test_failover_drill_bit_identical(models):
    plan = "step|r1 : crash, after=3, times=1"
    j = Pkg("jax", models).drill("chaos_drill", Pkg("jax", models).ecfg(),
                                 plan_spec=plan)
    p = Pkg("torch", models)
    t = p.drill("chaos_drill", p.ecfg(), plan_spec=plan)
    assert t == j
    assert t["router_availability"] == 1.0
    assert t["router_completed"] == t["router_admitted"]
    assert t["router_failovers"] >= 1
    assert t["router_greedy_match_ref"] == 1.0
    assert t["router_resubmitted_tokens"] > 0
    assert t["router_resubmits"] >= 1


def test_failover_survivor_compiles_once(models):
    def scenario(pkg):
        return _submit_run(pkg.router(chaos=pkg.Plan.parse(
            "step|r1 : crash, after=2, times=1")), _prompts(5))

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    router = t["router"]
    assert all(r.status == "completed" for r in router.results.values())
    r0 = router.replicas[0]
    assert r0.state == "up" and r0.engine.compile_count() == 1
    assert router.stats.failovers == 1 and router.stats.revivals == 1


def test_latency_spike_trips_breaker_virtually(models):
    def scenario(pkg):
        rcfg = pkg.rt.RouterConfig(num_replicas=2, latency_zscore=8.0,
                                   latency_min_steps=4, probation_steps=4)
        plan = pkg.Plan.parse("step|r0 : latency=30.0, after=6, times=1")
        router = _submit_run(pkg.router(rcfg, chaos=plan),
                             _prompts(6, seed=1), n_new=6)
        assert plan.fire_count() == 1
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)
    assert t["router"].stats.failovers >= 1


def test_exhaust_storm_trips_breaker(models):
    def scenario(pkg):
        rcfg = pkg.rt.RouterConfig(num_replicas=2, exhaust_threshold=2,
                                   exhaust_window=4, probation_steps=4)
        plan = pkg.Plan.parse("step|r0 : exhaust, after=2, times=3")
        return _submit_run(pkg.router(rcfg, chaos=plan),
                           _prompts(4, seed=2))

    j, t = _both(models, scenario)
    _assert_same(j, t)
    assert t["router"].stats.failovers >= 1
    assert all(r.status == "completed"
               for r in t["router"].results.values())


def test_tenant_throttling_never_starves_others(models):
    def scenario(pkg):
        rcfg = pkg.rt.RouterConfig(
            num_replicas=2,
            tenants={"noisy": pkg.rt.TenantPolicy(rate_tokens_per_s=0.0,
                                                  burst_tokens=12.0),
                     "good": pkg.rt.TenantPolicy()})
        router = pkg.router(rcfg)
        throttled = []
        for i, p in enumerate(_prompts(8, seed=3)):
            tenant = "noisy" if i % 2 == 0 else "good"
            try:
                router.submit(p, 4, tenant=tenant, uid=f"req{i}")
            except pkg.eng.RequestRejected as exc:
                assert exc.reason == "tenant_throttled"
                throttled.append(tenant)
        assert throttled == ["noisy"] * 3
        router.run()
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    res = t["router"].results
    assert sum(r.tenant == "good" and r.status == "completed"
               for r in res.values()) == 4
    assert t["router"].stats.rejected_by_reason["tenant_throttled"] == 3


def test_overload_ladder_degrades_then_sheds(models):
    def scenario(pkg):
        rcfg = pkg.rt.RouterConfig(
            num_replicas=2, global_token_budget=40,
            degrade_threshold=0.55, shed_threshold=0.8, degrade_max_new=2,
            tenants={"vip": pkg.rt.TenantPolicy(priority=2),
                     "cheap": pkg.rt.TenantPolicy(priority=1)})
        router = pkg.router(rcfg)
        prompts = _prompts(6, seed=4)
        router.submit(prompts[0], 4, tenant="vip", uid="a")
        router.submit(prompts[1], 4, tenant="cheap", uid="b")
        router.submit(prompts[2], 4, tenant="vip", uid="c")
        with pytest.raises(pkg.eng.RequestRejected) as exc:
            router.submit(prompts[3], 4, tenant="cheap", uid="d")
        assert exc.value.reason == "over_budget"
        router.submit(prompts[4], 4, tenant="vip", uid="e")
        with pytest.raises(pkg.eng.RequestRejected) as exc:
            router.submit(prompts[5], 26, tenant="vip", uid="f")
        assert exc.value.reason == "over_budget"
        router.run()
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)
    res = t["router"].results
    assert res["c"].degraded and len(res["c"].tokens) == 2
    assert res["e"].degraded and len(res["e"].tokens) == 2
    assert res["a"].status == "completed" and len(res["a"].tokens) == 4
    assert t["router"].stats.degraded == 2
    assert t["router"].stats.tenant_shed == {"cheap": 1}


def test_never_fits_rejected_at_router_with_its_trace_id(models):
    def scenario(pkg):
        router = pkg.router(pkg.rt.RouterConfig(num_replicas=1))
        with pytest.raises(pkg.eng.RequestRejected) as exc:
            router.submit([1] * 40, 40, uid="huge")
        assert exc.value.reason == "never_fits"
        assert exc.value.trace_id == "trace-huge"
        ev = [e for e in pkg.obs.get_tracer().chrome_trace()[
            "traceEvents"] if e["name"] == "request:huge"]
        assert len(ev) == 1 and ev[0]["args"]["reason"] == "never_fits"
        assert not router.has_work()
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    assert t["router"].results["huge"].status == "rejected"


def test_session_affinity_sticks_while_healthy(models):
    def scenario(pkg):
        return _submit_run(pkg.router(), _prompts(4, seed=5),
                           session="sess-1")

    j, t = _both(models, scenario)
    _assert_same(j, t)
    assert len({r.replica for r in t["router"].results.values()}) == 1


def test_drain_on_sigterm_finishes_in_flight(models):
    def scenario(pkg):
        guard = pkg.pre.PreemptionGuard(grace_s=60.0).install()
        try:
            router = pkg.router(preemption_guard=guard)
            prompts = _prompts(3, seed=6)
            for i, p in enumerate(prompts[:2]):
                router.submit(p, 4, uid=f"req{i}")
            router.step()
            os.kill(os.getpid(), signal.SIGTERM)
            router.step()
            assert router.draining
            with pytest.raises(pkg.eng.RequestRejected) as exc:
                router.submit(prompts[2], 4, uid="late")
            assert exc.value.reason == "draining"
            with pytest.raises(pkg.rt.ServingPreempted) as exits:
                router.run()
            assert exits.value.code == pkg.pre.EXIT_PREEMPTED == 75
            assert exits.value.results["req0"].status == "completed"
            assert len(exits.value.results["req1"].tokens) == 4
        finally:
            guard.uninstall()
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)


def test_bounded_retries_fail_request(models):
    def scenario(pkg):
        rcfg = pkg.rt.RouterConfig(num_replicas=1, max_retries=2,
                                   probation_steps=1, probation_ok_steps=1,
                                   backoff_base_s=0.0)
        router = pkg.router(rcfg, chaos=pkg.Plan.parse("step|r0 : crash"))
        router.submit(_prompts(1, seed=7)[0], 4, uid="doomed")
        router.run()
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    res = t["router"].results["doomed"]
    assert res.status == "failed" and res.reason == "max_retries"
    assert res.resubmits == 2
    assert t["router"].stats.availability() == 0.0


def test_router_stats_to_dict(models):
    def scenario(pkg):
        return _submit_run(pkg.router(), _prompts(2, seed=8))

    j, t = _both(models, scenario)
    _assert_same(j, t)
    d = t["router"].stats.to_dict()
    assert d["availability"] == 1.0 and d["completed"] == 2
    assert "queue_depth" in t["router"].replicas[0].engine.stats.to_dict()


def test_sdc_serving_drill(models):
    j = Pkg("jax", models).drill("sdc_serving_drill",
                                 Pkg("jax", models).ecfg())
    p = Pkg("torch", models)
    t = p.drill("sdc_serving_drill", p.ecfg())
    assert t == j
    assert t["sdc_serving_availability"] == 1.0
    assert t["sdc_serving_completed"] == 6
    assert t["sdc_serving_mismatches"] == 1
    assert t["sdc_serving_greedy_match_ref"] == 1.0


def test_failover_trace_shows_resubmit_hop(models):
    def scenario(pkg):
        router = _submit_run(pkg.router(chaos=pkg.Plan.parse(
            "step|r1 : crash, after=2, times=1")), _prompts(5))
        evs = [e for e in pkg.obs.get_tracer().chrome_trace()[
            "traceEvents"] if e["name"].startswith("request:")]
        router.trace_args = sorted(
            (e["name"], e["args"]["outcome"], e["args"]["phase_n"])
            for e in evs)
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    assert t["router"].trace_args == j["router"].trace_args
    assert len(t["router"].trace_args) == 5
    assert {a[1] for a in t["router"].trace_args} == {"completed",
                                                      "resubmitted"}


# ---------------------------------------------------------------------------
# tests/test_prefix_sharing.py: prefix placement, budget credit, stats
# ---------------------------------------------------------------------------

def _pecfg(pkg, **kw):
    return pkg.ecfg(num_blocks=32, max_slots=4, max_blocks_per_seq=12,
                    token_budget=16, **kw)


def test_router_prefix_placement_failover_bit_identical(models):
    reqs = [(SYS + [20 + i], 4) for i in range(5)]

    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=2, placement="prefix"),
            _pecfg(pkg, prefix_sharing=True),
            chaos=pkg.Plan.parse("step|r0 : crash, after=4, times=1"))
        for i, (p, n) in enumerate(reqs):
            router.submit(p, n, uid=f"req{i}")
        router.run()
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    router = t["router"]
    assert router.stats.availability() == 1.0
    assert router.stats.failovers >= 1
    solo = te.ServingEngine(models[2], models[3],
                            _pecfg(Pkg("torch", models)), device="cpu",
                            clock=lambda: 0.0)
    for i, (p, n) in enumerate(reqs):
        solo.submit(p, n, uid=f"req{i}")
    ref = solo.run()
    assert [router.results[f"req{i}"].tokens for i in range(5)] == [
        ref[f"req{i}"].tokens for i in range(5)]


def test_router_prefix_placement_prefers_warm_replica(models):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=2, placement="prefix"),
            _pecfg(pkg, prefix_sharing=True))
        router.submit(SYS + [20], 3, uid="warm")
        router.run()
        for i in range(3):
            router.submit(SYS + [30 + i], 3, uid=f"s{i}")
        router.run()
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)
    res = t["router"].results
    assert {res[f"s{i}"].replica for i in range(3)} == {res["warm"].replica}
    with pytest.raises(ValueError, match="placement"):
        Pkg("torch", models).router(
            tr.RouterConfig(num_replicas=2, placement="wat"))


@pytest.mark.parametrize("sharing", [True, False])
def test_router_credits_prefix_shared_blocks_in_budget(models, sharing):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=1, global_token_budget=24),
            _pecfg(pkg, prefix_sharing=sharing))
        router.submit(SYS + [20, 21], 2, uid="seed")
        router.run()
        rejected = []
        for i in range(2):
            try:
                router.submit(SYS + [30 + i, 40 + i], 2, uid=f"b{i}")
            except pkg.eng.RequestRejected as exc:
                rejected.append(exc.reason)
        router.run()
        router.rejected = rejected
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)
    assert t["router"].rejected == j["router"].rejected
    if sharing:
        assert not t["router"].rejected
    else:
        assert t["router"].rejected == ["over_budget"]


def test_prefix_stats_surface_engine_and_router(models):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=2, placement="prefix"),
            _pecfg(pkg, prefix_sharing=True))
        router.submit(SYS + [20], 3, uid="r0")
        router.run()
        router.submit(SYS + [21], 3, uid="r1")
        router.run()
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)
    agg = t["router"].engine_aggregate()
    assert agg == j["router"].engine_aggregate()
    assert agg["prefix_hit_rate"] > 0
    assert t["router"].stats_dict()["prefix_hit_rate"] == \
        agg["prefix_hit_rate"]


# ---------------------------------------------------------------------------
# tests/test_obs_slo.py: the SLO breach drives the autoscaler
# ---------------------------------------------------------------------------

def test_sustained_breach_drives_scale_up(models):
    """On the real clock, as tests/test_obs_slo.py runs it (a fake clock
    gives every TTFT 0, which meets any target): each package breaches,
    scales up for the SLO, and serves the same tokens."""
    def scenario(pkg):
        rcfg = pkg.rt.RouterConfig(
            num_replicas=1,
            scale=pkg.rt.ScalePolicy(min_replicas=1, max_replicas=2,
                                     hysteresis_steps=1, cooldown_steps=0),
            slo=pkg.SloPolicy(name="unit", ttft_p99_s=1e-9, min_samples=1,
                              breach_patience=1, window=16))
        return _submit_run(pkg.router(rcfg, clock=None), _prompts(6))

    j, t = _both(models, scenario, obs_on=True)
    assert {u: (r.status, r.tokens) for u, r in t["router"].results.items()
            } == {u: (r.status, r.tokens)
                  for u, r in j["router"].results.items()}
    for out in (j, t):
        router = out["router"]
        assert router.stats.slo_breaches >= 1
        assert router.stats.slo_scale_ups >= 1
        assert len(router.replicas) == 2
        scale = [a for n, a in out["events"] if n == "router_scale_up"]
        assert any(a["reason"].startswith("slo:") for a in scale)
        breach = [a for n, a in out["events"] if n == "slo_breach"]
        assert breach and breach[0]["policy"] == "unit"


# ---------------------------------------------------------------------------
# the port's own: shared weights, freed engines, refusals
# ---------------------------------------------------------------------------

def test_replicas_share_one_copy_of_the_weights(models):
    p = Pkg("torch", models)
    router = p.router(p.rt.RouterConfig(num_replicas=2))
    router.scale_up("test")
    ptrs = [{n: t.data_ptr() for n, t in r.engine.model.state_dict().items()}
            for r in router.replicas]
    assert len(ptrs) == 3 and ptrs[0] == ptrs[1] == ptrs[2]
    # the caller's fp32 CPU dict is already in place: no copy at all
    assert ptrs[0] == {n: t.data_ptr() for n, t in models[3].items()}


def test_crashed_replica_engine_is_freed_without_gc(models):
    p = Pkg("torch", models)
    gc.disable()
    try:
        router = p.router(chaos=p.Plan.parse(
            "step|r1 : crash, after=2, times=1"))
        doomed = weakref.ref(router.replicas[1].engine)
        pool = weakref.ref(router.replicas[1].engine.cache.k)
        for i, pr in enumerate(_prompts(5)):
            router.submit(pr, 4, uid=f"req{i}")
        while router.stats.failovers == 0:
            router.step()
        assert router.replicas[1].engine is None
        assert doomed() is None and pool() is None
        router.run()
        live = weakref.ref(router.replicas[0].engine)
        del router
        assert live() is None
    finally:
        gc.enable()


def test_aot_warm_is_false_and_scale_up_reports_it(models):
    """Without a cache no engine is warm. With one, a scale-up while every
    capture is held by a live replica captures its own (``warm=False``),
    and one after a scale-down leases the retired replica's
    (``warm=True``); the events carry ``aot_warm()``."""
    p = Pkg("torch", models)
    seen = []
    unsub = tsubscribe(lambda e, f: seen.append((e, f)))
    try:
        router = p.router(p.rt.RouterConfig(
            num_replicas=1, scale=p.rt.ScalePolicy(max_replicas=2)))
        budget = router._budget
        assert router.scale_up("test") == "r1"
        assert router._budget == 2 * budget
        assert router.scale_up("test") is None
        assert all(not r.engine.aot_warm() for r in router.replicas)
        cache = tac.AotExecutableCache()
        cached = p.router(p.rt.RouterConfig(
            num_replicas=1, scale=p.rt.ScalePolicy(max_replicas=2)),
            aot_cache=cache)
        assert cached.scale_up("test") == "r1"
        assert not any(r.engine.aot_warm() for r in cached.replicas)
        assert cached.scale_down("test") == "r1"
        assert cached.scale_up("test") == "r2"
        assert cached.replicas[-1].engine.aot_warm()
    finally:
        unsub()
    evt = [f for e, f in seen if e == "router_scale_up"]
    assert [(f["replica"], f["fleet"], f["warm"]) for f in evt] == [
        ("r1", 2, False), ("r1", 2, False), ("r2", 2, True)]
    assert cache.stats() == {"hits": 1, "misses": 2, "puts": 2,
                             "evictions": 0, "serialize_skips": 0,
                             "mem_entries": 2}


def test_later_slice_router_options_raise(models):
    p = Pkg("torch", models)
    for kw in (dict(long_context_replicas=1),
               dict(long_context_engine=p.ecfg()),
               dict(long_context_threshold=64)):
        with pytest.raises(NotImplementedError, match="long_context"):
            p.router(p.rt.RouterConfig(num_replicas=1, **kw))


def test_injected_engines_and_entry_point_device(models):
    p = Pkg("torch", models)
    engines = [te.ServingEngine(models[2], models[3], p.ecfg(),
                                device="cpu", clock=lambda: 0.0)
               for _ in range(2)]
    router = p.router(engines=engines)
    assert [r.engine for r in router.replicas] == engines
    assert not any(e._standalone_obs for e in engines)
    with pytest.raises(ValueError, match="engines for num_replicas"):
        p.router(engines=engines[:1])
    with pytest.raises(ValueError, match="incompatible with a two-tier"):
        p.router(p.rt.RouterConfig(fabric=p.rt.FabricConfig()),
                 engines=engines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tr.ReplicaRouter(models[2], models[3], p.ecfg())
