"""The PyTorch port's elastic fleet against the JAX package's, mirroring
tests/test_elastic.py's router tests (scale up and down, hysteresis and
cooldown, preemption with migration and revival, the elastic kinds of the
chaos DSL), trie shipping to a newcomer (``warm_prefix_blocks``),
``elastic_chaos_drill`` (its dict equals JAX's but for the spin-up
timings and the misses of leased captures) and the SLO speculation toggle of
tests/test_router.py. Each scenario runs in both packages under
``clock=lambda: 0.0`` and compares results, stats, events (``warm`` left
out) and the ``nxd_router_*`` metrics, through tests/test_torch_router.py's
harness."""

import types

import pytest

from neuronx_distributed_tpu.resilience.chaos import FaultPlan as JPlan
from neuronx_distributed_tpu_torch.inference.speculative import (
    SpeculationConfig as TSpec)
from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan as TPlan

from test_torch_router import (Pkg, _assert_same, _both, _one_thread,  # noqa
                               _prompts, models)

#: the drill's spin-up timings and executable-cache counters
AOT_KEYS = ("bundle_cold_start_ms", "bundle_cold_start_warm_ms",
            "bundle_cold_start_speedup", "aot_warm_loaded",
            "aot_cache_hits", "aot_cache_misses")


def _prompt(seed, length=6):
    return _prompts(1, length=length, seed=seed)[0]


def test_scale_up_resizes_budget_and_stops_at_the_cap(models):
    def scenario(pkg):
        router = pkg.router(pkg.rt.RouterConfig(
            num_replicas=1, scale=pkg.rt.ScalePolicy(max_replicas=2)))
        budget1 = router._budget
        assert router.scale_up("test") == "r1"
        assert len(router.live_replicas()) == 2
        assert router._budget == 2 * budget1
        assert router.replicas[-1].engine.compile_count() <= 1
        assert router.scale_up("test") is None
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    assert t["router"].stats.scale_ups == 1
    evt = [f for e, f in t["events"] if e == "router_scale_up"]
    assert evt == [dict(replica="r1", reason="test", fleet=2)]


def test_scale_down_floor_and_migration(models):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=2, scale=pkg.rt.ScalePolicy(
                min_replicas=1, max_replicas=3)),
            pkg.ecfg(max_slots=4))
        for i in range(3):
            router.submit(_prompt(20 + i), 6, uid=f"req{i}")
        for _ in range(2):
            router.step()
        assert router.scale_down("test") is not None
        assert len(router.live_replicas()) == 1
        router.run()
        assert router.scale_down("test") is None   # min_replicas floor
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    stats = t["router"].stats
    assert stats.availability() == 1.0 and stats.reprefilled_tokens == 0
    assert stats.migrated_sessions > 0 and stats.migrated_tokens > 0


def test_autoscale_hysteresis_and_cooldown(models):
    def scenario(pkg):
        pol = pkg.rt.ScalePolicy(min_replicas=1, max_replicas=3,
                                 queue_high=2.0, queue_low=0.5,
                                 hysteresis_steps=2, cooldown_steps=3)
        router = pkg.router(pkg.rt.RouterConfig(num_replicas=1, scale=pol))
        for i in range(4):
            router.submit(_prompt(30 + i), 4, uid=f"f{i}",
                          arrival_time=1e9)
        ups = []
        router._tick_autoscale()
        ups.append(router.stats.scale_ups)
        router._tick_autoscale()
        ups.append(router.stats.scale_ups)
        for _ in range(pol.cooldown_steps):
            router._tick_autoscale()
        ups.append(router.stats.scale_ups)
        router._pending.clear()
        router._tick_autoscale()
        downs = [router.stats.scale_downs]
        router._tick_autoscale()
        downs.append(router.stats.scale_downs)
        assert ups == [0, 1, 1] and downs == [0, 1]
        assert len(router.live_replicas()) == 1
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)


def test_preempt_migrates_and_revives(models):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=2, probation_steps=2),
            pkg.ecfg(max_slots=4),
            chaos=pkg.Plan.parse("step|r0 : preempt, after=2, times=1"))
        for i in range(4):
            router.submit(_prompt(40 + i), 4, uid=f"req{i}")
        router.run()
        return router

    j, t = _both(models, scenario, obs_on=True)
    _assert_same(j, t)
    router = t["router"]
    assert router.stats.preemptions == 1
    assert router.stats.availability() == 1.0
    assert router.stats.reprefilled_tokens == 0
    assert any(e == "router_preempt" for e, _ in t["events"])
    r0 = router.replicas[0]
    assert r0.engine is not None and r0.generation == 1
    # a step shape counts once a step ran it (the revived engine may not
    # have stepped yet: 0, where JAX's compiled-at-construction gives 1)
    assert r0.engine.compile_count() <= 1 and not r0.engine.aot_warm()
    assert any('replica="r0"' in ln and 'generation="1"' in ln
               for ln in t["metrics"]
               if ln.startswith("nxd_router_replica_engine"))


def test_scale_up_ships_the_hottest_trie(models):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(num_replicas=1, warm_prefix_blocks=4),
            pkg.ecfg(num_blocks=32, max_slots=4, max_blocks_per_seq=12,
                     token_budget=16, prefix_sharing=True))
        sys_prompt = list(range(1, 13))
        router.submit(sys_prompt + [20], 3, uid="warm")
        router.run()
        name = router.scale_up("test")
        newcomer = router.replicas[-1]
        assert newcomer.name == name
        assert newcomer.engine.prefix_cache.size > 0
        # the newcomer serves a prefix hit from its first request
        router.replicas[0].state = "down"
        router.replicas[0].down_steps = 10 ** 6
        router.submit(sys_prompt + [21], 3, uid="hit")
        router.run()
        assert router.results["hit"].replica == name
        assert newcomer.engine.stats.prefix_hit_tokens > 0
        return router

    j, t = _both(models, scenario)
    _assert_same(j, t)
    warm = [f for e, f in t["events"] if e == "router_prefix_warm"]
    assert warm and warm[0]["donor"] == "r0" and warm[0]["nodes"] > 0


def test_chaos_plan_parses_elastic_kinds():
    for Plan in (TPlan, JPlan):
        plan = Plan.parse(
            "step|r1 : preempt, after=2, times=1 ; "
            "scale|fleet : scale_burst, after=5, times=1")
        assert [r.kind for r in plan.rules] == ["preempt", "scale_burst"]
        for _ in range(3):
            plan.apply("step", "r1")
        assert plan.injected == ["preempt step r1"]
        kind, _ = plan.consult("scale", "fleet")
        assert kind is None
        with pytest.raises(ValueError, match="unknown fault kind"):
            Plan.parse("step : reboot")


def test_scale_burst_consult_does_not_perturb_step_rules():
    for Plan in (TPlan, JPlan):
        plan = Plan.parse(
            "step|r1 : crash, after=3, times=1 ; "
            "scale|fleet : scale_burst, after=0, times=1")
        for _ in range(10):
            plan.consult("scale", "fleet")
        for _ in range(3):
            assert plan.consult("step", "r1")[0] is None
        assert plan.consult("step", "r1")[0] == "crash"


def test_elastic_chaos_drill_matches_jax(models, tmp_path):
    """The dict equals JAX's on the same seed, the executable cache's keys
    included: the same lookups, the same warm probe; the timings are each
    package's own. Two divergences, both stated: a capture is leased to
    one live engine, so the port misses where a second replica is built
    while the first holds the capture (the elastic fleet's ``r1`` beside
    ``r0``, and ``r1``'s revival beside ``r0`` and ``r3``) where JAX's
    replicas share one executable; and with a ``cache_dir`` the warm probe
    (a fresh cache over the directory) misses, since a captured graph is
    not written to disk."""
    j = Pkg("jax", models)
    jd = j.drill("elastic_chaos_drill", j.ecfg(max_slots=4))
    p = Pkg("torch", models)
    td = p.drill("elastic_chaos_drill", p.ecfg(max_slots=4))
    assert set(td) == set(jd)
    timed = AOT_KEYS[:3]
    same = [k for k in jd if k not in AOT_KEYS]
    assert {k: td[k] for k in same} == {k: jd[k] for k in same}
    assert all(td[k] > 0 for k in timed)
    assert td["aot_warm_loaded"] == jd["aot_warm_loaded"] == 1.0
    assert (td["aot_cache_hits"] + td["aot_cache_misses"]
            == jd["aot_cache_hits"] + jd["aot_cache_misses"])
    assert td["aot_cache_misses"] == jd["aot_cache_misses"] + 2
    assert td["elastic_availability"] == 1.0
    assert td["elastic_completed"] == td["elastic_admitted"]
    assert td["elastic_greedy_match_ref"] == 1.0
    assert td["reprefilled_tokens"] == 0
    assert td["migrated_sessions"] >= 1
    assert td["elastic_preemptions"] == 1
    assert td["elastic_scale_ups"] >= 1 and td["elastic_scale_downs"] >= 1
    assert td["elastic_revivals"] >= 1
    assert td["max_compile_count"] == 1
    assert td["elastic_slo_breaches"] >= 1
    assert td["elastic_slo_scale_ups"] >= 1
    on_disk = p.drill("elastic_chaos_drill", p.ecfg(max_slots=4),
                      cache_dir=str(tmp_path))
    assert on_disk["aot_warm_loaded"] == 0.0
    assert {k: on_disk[k] for k in same} == {k: td[k] for k in same}
    # the warm probe looked up its own fresh cache, not the drill's
    assert (on_disk["aot_cache_hits"], on_disk["aot_cache_misses"]) == (
        td["aot_cache_hits"] - 1, td["aot_cache_misses"])
    assert not list(tmp_path.iterdir())


def test_slo_auto_toggle_flips_speculation_and_prices_admission(models):
    """tests/test_router.py's SLO-adaptive speculation (slow-marked there),
    on the port alone and on the real clock (TPOT under a fake clock is 0,
    which meets any target): a sustained TPOT breach toggles speculation on
    fleet-wide with no new step shape, the rounds aggregate, and the
    admission surcharge follows the fleet's accept rate."""
    p = Pkg("torch", models)
    k = 2
    router = p.router(
        p.rt.RouterConfig(num_replicas=1, slo=p.SloPolicy(
            name="unit", tpot_p99_s=1e-9, min_samples=1, breach_patience=1,
            window=16)),
        p.ecfg(num_blocks=32, speculation=TSpec(
            speculation_length=k, slo_adaptive=True, start_on=False)),
        clock=None)
    eng = router.replicas[0].engine
    assert not eng.speculating
    for i, pr in enumerate(_prompts(4, seed=11)):
        router.submit(pr, 6, uid=f"req{i}")
    res = router.run()
    assert all(r.status == "completed" for r in res.values())
    assert router.stats.spec_toggles >= 1
    assert eng.speculating
    assert eng.compile_count() == 1
    agg = router.engine_aggregate()
    assert agg["spec_rounds"] > 0
    assert agg["spec_accept_mean"] == float(k)   # self-draft: full accept
    req = types.SimpleNamespace(max_new_tokens=8)
    assert router._spec_draft_surcharge(req) == 0
    router._eng_acc["spec_rounds"] += 10 ** 6
    assert router._spec_draft_surcharge(req) == 8 * k - 1
    # the tokens are the plain router's
    plain = p.router(p.rt.RouterConfig(num_replicas=1),
                     p.ecfg(num_blocks=32))
    for i, pr in enumerate(_prompts(4, seed=11)):
        plain.submit(pr, 6, uid=f"req{i}")
    assert {u: r.tokens for u, r in plain.run().items()} == {
        u: r.tokens for u, r in res.items()}
