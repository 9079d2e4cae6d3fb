"""The PyTorch port's two-tier serving fabric against the JAX package's:
``fabric_chaos_drill`` under the five link fault sets of
tests/test_transport.py, on an int8 pool (shipped raw) and an fp32 pool
(through the int8 wire codec), with dicts equal to JAX's; the router's
handoff accounting and request traces; per-tier autoscaling.

Two stated divergences (ROADMAP §C): ``handoff_bytes`` counts chunk
headers, which carry fingerprints of each package's own K/V (their last
bits differ), so it is held to a few bytes a send; and a decode replica
that never stepped counts 0 step shapes where JAX's engine, compiled at
construction, counts 1."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.obs import tracing as jtracing
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.obs import tracing as ttracing
from neuronx_distributed_tpu_torch.models.convert import params_from_jax

from test_torch_router import Pkg, _both, _one_thread  # noqa

FAULTS = {
    "none": "",
    "link_corrupt": "seed=3; link|* : link_corrupt, p=0.2, times=4",
    "link_drop": "seed=3; link|* : link_drop, p=0.3, times=5",
    "link_delay": "seed=3; link|* : link_delay, p=0.5, times=6, "
                  "latency=0.03",
    "link_partition": "seed=3; link|* : link_partition, after=8, times=1",
}


@pytest.fixture(scope="module")
def models():
    """tests/test_transport.py's tiny model: one head at head_dim 64."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2, num_heads=1, num_kv_heads=1)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2, num_heads=1,
                          num_kv_heads=1)
    return jcfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


def _fecfg(pkg, quantized=True):
    return pkg.ecfg(num_blocks=32, max_slots=6, quantized=quantized)


def _stream(pkg):
    return pkg.rt.StreamConfig(bandwidth=50e3, latency_s=1e-3)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("kind", list(FAULTS))
def test_fabric_drill_matches_jax(models, kind, quantized):
    out = {}
    for name in ("jax", "torch"):
        pkg = Pkg(name, models)
        out[name] = pkg.drill("fabric_chaos_drill",
                              _fecfg(pkg, quantized),
                              plan_spec=FAULTS[kind], seed=0)
    j, t = out["jax"], out["torch"]
    jb, tb = j.pop("handoff_bytes"), t.pop("handoff_bytes")
    assert abs(tb - jb) <= 0.001 * jb
    if t["handoffs"] == 0:
        # the decode tier never stepped: no step shape yet
        assert t.pop("decode_compile_count") == 0
        assert j.pop("decode_compile_count") == 1
    assert t == j
    # the availability contract: every admitted request completes, and
    # greedy decoding makes the fault story invisible in the tokens
    assert t["fabric_availability"] == 1.0
    assert t["fabric_completed"] == t["fabric_admitted"]
    assert t["fabric_greedy_match_ref"] == 1.0
    assert t["handoff_wire_ratio"] >= 3.5
    assert t.get("decode_compile_count", 1) == 1
    assert t["pool_leak_blocks"] == 0
    if kind == "link_partition":
        assert t["handoff_aborts"] > 0 and t["handoffs"] == 0
        assert t["reprefilled_tokens"] > 0
    else:
        assert t["handoff_aborts"] == 0 and t["handoffs"] > 0
        assert t["reprefilled_tokens"] == 0
    if kind in ("link_corrupt", "link_drop"):
        assert t["handoff_retries"] > 0


def _drive_fabric(router):
    while router.has_work():
        stepped = router.step()
        if stepped:
            router._t0 -= 0.05
        elif router.has_work():
            gap = router._idle_gap()
            if gap > 0:
                router._t0 -= gap
    return router


def _prompt8():
    return np.random.RandomState(7).randint(0, 256, (8,)).tolist()


def _bytes_free(d):
    d = dict(d)
    return d.pop("handoff_bytes"), d


@pytest.fixture
def fake_trace_clock(monkeypatch):
    """The scenario's fake clock (``clock=lambda: 0.0``) for both
    packages' request tracers too. A session's meta chunk carries its
    trace (``phase_us``, ``elapsed_us``), which the tracers take from
    ``time.perf_counter_ns``: on the host's clock the floats, and with
    them the chunk's JSON length and ``handoff_bytes``, followed the
    timing of the run."""
    fake = types.SimpleNamespace(perf_counter_ns=lambda: 0)
    for mod in (jtracing, ttracing):
        monkeypatch.setattr(mod, "time", fake)


def test_fabric_router_stats_expose_handoff_accounting(models,
                                                       fake_trace_clock):
    def scenario(pkg):
        router = pkg.router(
            pkg.rt.RouterConfig(fabric=pkg.rt.FabricConfig(
                stream=_stream(pkg))), _fecfg(pkg))
        assert sorted((r.name, r.tier) for r in router.replicas) == [
            ("d0", "decode"), ("p0", "prefill")]
        router.submit(_prompt8(), 4, uid="req0")
        _drive_fabric(router)
        evs = [e for e in pkg.obs.get_tracer().chrome_trace()[
            "traceEvents"] if e["name"] == "request:req0"]
        router.trace = [(e["args"]["outcome"], sorted(e["args"]["phase_n"]))
                        for e in evs]
        return router

    j, t = _both(models, scenario, obs_on=True)
    jb, jd = _bytes_free(j["router"].stats.to_dict())
    tb, td = _bytes_free(t["router"].stats.to_dict())
    assert td == jd and abs(tb - jb) <= 0.001 * jb
    assert t["router"].results["req0"].tokens == \
        j["router"].results["req0"].tokens
    assert t["events"] == j["events"]
    assert t["router"].trace == j["router"].trace
    assert "handoff" in t["router"].trace[0][1]
    assert td["handoffs"] == 1 and td["handoff_chunks"] > 0
    assert tb > 0 and td["handoff_wire_ratio"] >= 3.5
    assert t["router"].stats.migrated_sessions == 1
    assert t["router"].results["req0"].replica == "d0"


def test_fabric_tiers_scale_independently(models):
    def scenario(pkg):
        up = pkg.rt.ScalePolicy(min_replicas=1, max_replicas=2,
                                queue_high=1.0, queue_low=0.0,
                                hysteresis_steps=1, cooldown_steps=2)
        fab = pkg.rt.FabricConfig(stream=_stream(pkg), prefill_scale=up,
                                  decode_scale=up)
        router = pkg.router(
            pkg.rt.RouterConfig(fabric=fab, global_token_budget=10 ** 6),
            _fecfg(pkg))
        rng = np.random.RandomState(3)
        for i in range(6):
            router.submit(rng.randint(0, 256, (8,)).tolist(), 5,
                          uid=f"req{i}")
        _drive_fabric(router)
        # manual scaling names the tier's next replica
        router.scale_up("test", tier="decode")
        return router

    j, t = _both(models, scenario, obs_on=True)
    jr_, tr_ = j["router"], t["router"]
    assert {u: dataclasses.asdict(r) for u, r in tr_.results.items()} == {
        u: dataclasses.asdict(r) for u, r in jr_.results.items()}
    assert _bytes_free(tr_.stats.to_dict())[1] == _bytes_free(
        jr_.stats.to_dict())[1]
    assert t["events"] == j["events"]
    assert [(r.name, r.tier, r.state) for r in tr_.replicas] == [
        (r.name, r.tier, r.state) for r in jr_.replicas]
    ups = [f["replica"] for e, f in t["events"] if e == "router_scale_up"]
    # both tiers grew on their own signals before the manual decode one
    assert ups[-1].startswith("d")
    assert any(n.startswith("p") for n in ups[:-1])
    assert any(n.startswith("d") for n in ups[:-1])
