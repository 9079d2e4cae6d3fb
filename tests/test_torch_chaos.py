"""The port's chaos fault injection against the JAX package's: the spec
DSL parses to the same rules, and for the same seed and the same
operations a plan fires the same faults in the same order (kinds,
latencies, drawn bit positions, the audit log); ``apply`` raises the same
faults, and the storage wrapper heals transients, surfaces permanents and
never stacks. Then the reference's chaos scenarios run against the port's
checkpoint engine through ``install_storage_wrapper``: a transient fault
on the done-marker heals and the tag loads bit for bit, a permanent one
fails the commit, and resume through a faulty store equals the
uninterrupted run."""

import errno
import time

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.resilience import chaos as jchaos
from neuronx_distributed_tpu.trainer import checkpoint_storage as jcs
from neuronx_distributed_tpu_torch.inference.paging import CacheExhaustedError
from neuronx_distributed_tpu_torch.resilience import chaos as tchaos
from neuronx_distributed_tpu_torch.resilience.chaos import (
    ChaosCheckpointStorage, FaultPlan, FaultRule, InjectedFault,
    ReplicaCrashed, wrapper_for_plan)
from neuronx_distributed_tpu_torch.trainer import checkpoint as ckpt
from neuronx_distributed_tpu_torch.trainer import checkpoint_storage as cs

BOTH = {"jax": jchaos, "torch": tchaos}

SPECS = [
    "seed=7; save_text|*/checkpoint : transient, p=0.5, times=2; "
    "load_text : permanent, after=1; * : latency=0.01",
    "step|r1 : crash, after=6, times=1",
    "seed=3; integrity|params : bitflip, after=1; x : bit=3",
    "seed=11; link|p0->d0 : link_delay, latency=0.2, p=0.4; "
    "link|* : link_corrupt, p=0.3; link|* : link_partition; "
    "scale|fleet : scale_burst, times=2; step|* : preempt, p=0.2; "
    "step|r2 : exhaust, after=3",
    " ; seed = 5 ;  save_text :  ; read_bytes|*/a* : transient ,times=1 ",
]


def _rules(plan):
    return [(r.op, r.path, r.kind, r.prob, r.after, r.times, r.latency_s,
             r.bit) for r in plan.rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_gives_the_rules_of_jax(spec):
    t, j = tchaos.FaultPlan.parse(spec), jchaos.FaultPlan.parse(spec)
    assert t.seed == j.seed and _rules(t) == _rules(j)


def test_parse_refuses_what_jax_refuses():
    for mod in BOTH.values():
        with pytest.raises(ValueError, match="bad fault clause"):
            mod.FaultPlan.parse("nonsense")
        with pytest.raises(ValueError, match="unknown fault option"):
            mod.FaultPlan.parse("save_text : transient, bogus=1")
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultRule(kind="bogus")
        with pytest.raises(ValueError, match="prob"):
            mod.FaultRule(prob=1.5)


def _ops(seed, n=400):
    """A random sequence of (op, path) calls across every rule's target."""
    rng = np.random.RandomState(seed)
    ops = [("save_text", "/c/1/checkpoint"), ("save_text", "/c/newest"),
           ("load_text", "/c/newest"), ("step", "r1"), ("step", "r2"),
           ("integrity", "params"), ("x", "y"), ("link", "p0->d0"),
           ("link", "p1->d1"), ("scale", "fleet"), ("read_bytes", "/c/ab")]
    return [ops[i] for i in rng.randint(0, len(ops), n)]


@pytest.mark.parametrize("spec", SPECS)
def test_same_seed_same_ops_fire_the_same_faults_in_order(spec):
    out = {}
    for name, mod in BOTH.items():
        plan = mod.FaultPlan.parse(spec)
        fires = [plan.consult_detail(op, path) for op, path in _ops(1)]
        fires += [plan.consult(op, path) for op, path in _ops(2, 100)]
        out[name] = (fires, plan.injected, plan.fire_count())
    assert out["torch"] == out["jax"]
    assert out["torch"][2] > 0


def test_apply_raises_the_faults_of_jax():
    kinds = {"transient": InjectedFault, "permanent": OSError,
             "crash": ReplicaCrashed, "exhaust": CacheExhaustedError}
    for kind, exc in kinds.items():
        plan = FaultPlan([FaultRule(op="op", kind=kind)])
        with pytest.raises(exc, match="chaos: injected") as ei:
            plan.apply("op", "/p")
        jplan = jchaos.FaultPlan([jchaos.FaultRule(op="op", kind=kind)])
        try:
            jplan.apply("op", "/p")
        except Exception as e:  # noqa: BLE001 - compared below
            assert str(e) == str(ei.value)
    assert plan.fire_count() == 1
    for kind in ("preempt", "scale_burst", "bitflip", "link_drop"):
        FaultPlan([FaultRule(kind=kind)]).apply("op", "/p")  # consult-only
    assert cs._is_transient(InjectedFault("503 slow down"))
    assert not cs._is_transient(OSError(errno.ENOSPC, "full"))
    latency = FaultPlan([FaultRule(kind="latency", latency_s=0.05)])
    t0 = time.perf_counter()
    latency.apply("save_text", "/f")
    assert time.perf_counter() - t0 >= 0.04


def test_after_and_times_and_seeded_draws():
    plan = FaultPlan([FaultRule(op="save_text", after=2, times=1)])
    outcomes = []
    for i in range(5):
        try:
            plan.apply("save_text", f"/f{i}")
            outcomes.append("ok")
        except InjectedFault:
            outcomes.append("fault")
    assert outcomes == ["ok", "ok", "fault", "ok", "ok"]
    plan.apply("load_text", "/f")
    spec = "seed=9; save_text : transient, p=0.3"

    def run(plan):
        out = []
        for i in range(50):
            try:
                plan.apply("save_text", f"/x/{i}")
                out.append("ok")
            except InjectedFault:
                out.append("fault")
        return out

    a, b = FaultPlan.parse(spec), FaultPlan.parse(spec)
    assert run(a) == run(b) and a.injected == b.injected
    assert run(FaultPlan.parse("seed=10; save_text : transient, p=0.3")) \
        != run(FaultPlan.parse(spec))


def test_chaos_storage_direct(tmp_path):
    inner = cs.create_checkpoint_storage(str(tmp_path))
    f = str(tmp_path / "f.txt")
    healing = ChaosCheckpointStorage(
        inner, FaultPlan([FaultRule(op="save_text", times=1)]),
        base_delay=0.001)
    healing.save_text("hi", f)
    assert open(f).read() == "hi" and healing.plan.fire_count() == 1
    raw = ChaosCheckpointStorage(
        inner, FaultPlan([FaultRule(op="load_text")]), retries=False)
    with pytest.raises(InjectedFault, match="503"):
        raw.load_text(f)
    perm_plan = FaultPlan([FaultRule(op="file_exists", kind="permanent")])
    perm = ChaosCheckpointStorage(inner, perm_plan, base_delay=0.001)
    with pytest.raises(OSError) as ei:
        perm.file_exists(f)
    assert ei.value.errno == errno.ENOSPC and perm_plan.fire_count() == 1
    wrap = wrapper_for_plan(FaultPlan([]))
    once = wrap(inner)
    assert wrap(once) is once and once.inner is inner
    assert once.dirname() == inner.dirname()
    assert once.list_files(str(tmp_path)) == inner.list_files(
        str(tmp_path))
    assert once.read_bytes(f) == b"hi" and once.file_size(f) == 2


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.zeros(4)}, "step": 7}


def test_chaos_transient_heals_full_save(tmp_path):
    """Transient faults on the done-marker write heal through the real
    retry path — the async commit still completes and loads bit for
    bit."""
    path = str(tmp_path / "ckpt")
    plan = FaultPlan([FaultRule(op="save_text", path="*/checkpoint",
                                times=2)], seed=1)
    cs.install_storage_wrapper(wrapper_for_plan(plan, base_delay=0.001,
                                                max_delay=0.01))
    try:
        ckpt.save_checkpoint(path, 1, _state(), async_save=True)
        ckpt.finalize_checkpoint()
        assert ckpt.has_checkpoint(path, 1)
        loaded, _ = ckpt.load_checkpoint(path, 1, device="cpu")
    finally:
        cs.clear_storage_wrapper()
    assert plan.fire_count() == 2
    assert torch.equal(loaded["params"]["w"], _state()["params"]["w"])


def test_chaos_permanent_fails_commit(tmp_path):
    """A permanent (ENOSPC) fault on the done-marker write fails the async
    commit without burning retries; the tag stays incomplete and the error
    surfaces at finalize."""
    path = str(tmp_path / "ckpt")
    plan = FaultPlan([FaultRule(op="save_text", path="*/checkpoint",
                                kind="permanent")])
    cs.install_storage_wrapper(wrapper_for_plan(plan, base_delay=0.001))
    try:
        ckpt.save_checkpoint(path, 1, _state(), async_save=True)
        with pytest.raises(ckpt.CheckpointSaveError):
            ckpt.finalize_checkpoint()
    finally:
        cs.clear_storage_wrapper()
    assert not ckpt.has_checkpoint(path, 1)
    assert plan.fire_count() == 1


def test_the_done_marker_faults_fire_as_in_jax(tmp_path):
    """The same plan over both engines' commit of one tag: the done-marker
    rule fires the same faults (the engines' other control-plane calls
    differ, so the rule targets the marker alone)."""
    import jax

    from neuronx_distributed_tpu.trainer import checkpoint as jckpt

    spec = "seed=4; save_text|*/checkpoint : transient, p=0.7, times=3"
    out = {}
    for name, mod, store, eng, state in (
            ("jax", jchaos, jcs, jckpt,
             {"w": jax.numpy.ones((4, 4)), "step": 1}),
            ("torch", tchaos, cs, ckpt, {"w": torch.ones(4, 4), "step": 1})):
        plan = mod.FaultPlan.parse(spec)
        store.install_storage_wrapper(mod.wrapper_for_plan(
            plan, base_delay=0.001, max_delay=0.01))
        try:
            for tag in (1, 2, 3):
                eng.save_checkpoint(str(tmp_path / name), tag, state,
                                    async_save=False)
            eng.finalize_checkpoint()
        finally:
            store.clear_storage_wrapper()
        out[name] = [line.split(" ")[0] + " " + line.rsplit("/", 2)[-2]
                     for line in plan.injected]
    assert out["torch"] == out["jax"] and out["torch"]


def test_resume_through_a_faulty_store_is_bit_for_bit(tmp_path):
    """``Trainer.fit`` with async checkpoints every 2 steps while the store
    throws transients on ``save_text`` and the manifest's reads: the
    commits heal, and a resume from the newest tag under the same plan
    ends bit for bit where the uninterrupted run ends."""
    from neuronx_distributed_tpu_torch import trainer as ttr
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.models import llama as tl

    cfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    ids = np.random.RandomState(0).randint(0, 256, (6, 2, 17))
    batches = [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]

    def run(batches, callbacks=(), resume=None, seed=0):
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), cfg, seed=seed, device="cpu")
        tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
        ttr.Trainer(ttr.make_train_step(pm, tx), state,
                    callbacks=list(callbacks), resume_path=resume).fit(
                        iter(batches), max_steps=6)
        return state

    want = run(batches)
    path = str(tmp_path / "ck")
    plan = FaultPlan.parse("seed=2; save_text : transient, p=0.5; "
                           "read_bytes : transient, p=0.3, times=4")
    cs.install_storage_wrapper(wrapper_for_plan(plan, base_delay=0.001,
                                                max_delay=0.01))
    try:
        run(batches[:4], [ttr.CheckpointCallback(path, every=2)])
        got = run(batches[4:], resume=path, seed=1)
    finally:
        cs.clear_storage_wrapper()
    assert plan.fire_count() > 0
    assert ckpt.list_complete_tags(path) == ["2", "4"]
    assert got.step == 6
    for name, p in want.params.items():
        assert torch.equal(got.params[name], p), name
