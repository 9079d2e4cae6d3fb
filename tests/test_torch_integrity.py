"""The port's silent-data-corruption fingerprints against the JAX
package's: ``fingerprint_array`` equal to JAX's and to both numpy mirrors
bit for bit (fp32, bf16, fp16, int32, bool, empty; 1, 3 and 7 blocks; the
words at 0, 2**31 - 1, 2**31 and 2**32 - 1; leaves folded in several
chunks), the tree, payload, per-block and majority-vote helpers, the
train step's ``integrity_every`` metric, and the ``IntegrityMonitor``
drill (no false positive, raise without a watchdog, rewind with one),
mirroring ``tests/test_integrity.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuronx_distributed_tpu.resilience import integrity as ji
from neuronx_distributed_tpu.resilience.chaos import FaultPlan as JFaultPlan
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.resilience import integrity as ti
from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan
from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog
from neuronx_distributed_tpu_torch.trainer.loop import (CheckpointCallback,
                                                        Trainer)
from neuronx_distributed_tpu_torch.trainer.trainer import TrainState

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16),
          "int32": (torch.int32, jnp.int32),
          "bool": (torch.bool, jnp.bool_)}


def _pair(name, shape, seed=0):
    """The same values as a torch tensor and a JAX array."""
    tdt, jdt = DTYPES[name]
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 100
    if name == "bool":
        t = torch.from_numpy(x > 0)
    elif name == "int32":
        t = torch.from_numpy(x.astype(np.int32))
    else:
        t = torch.from_numpy(x).to(tdt)
    host = t.float().numpy() if t.is_floating_point() else t.numpy()
    return t, jnp.asarray(host).astype(jdt), host


@pytest.mark.parametrize("blocks", [1, 3, 7])
@pytest.mark.parametrize("shape", [(37, 5), (0, 3)], ids=["dense", "empty"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_fingerprint_matches_jax_and_both_mirrors(name, shape, blocks):
    t, j, host = _pair(name, shape)
    got = ti.fingerprint_array(t, blocks)
    assert got.dtype == torch.int32 and got.shape == (blocks,)
    want = np.asarray(ji.fingerprint_array(j, blocks))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ti.fingerprint_array_np(host, blocks), want)
    np.testing.assert_array_equal(
        ji.fingerprint_array_np(np.asarray(j), blocks), want)


@pytest.mark.parametrize("view", ["int32", "fp32"])
def test_fingerprint_of_the_extreme_words(view):
    """The uint32 words 0, 2**31 - 1, 2**31 and 2**32 - 1 (as int32 values,
    and as fp32 bit patterns: 0, the largest NaN, -0 and a NaN) fold as
    JAX folds them: int32 products and xors keep the low 32 bits, the
    int64 sum is masked, the avalanche shifts logically."""
    words = np.array([0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1] * 9,
                     np.uint32)
    arr = words.view(np.int32 if view == "int32" else np.float32)
    for blocks in (1, 3, 7):
        want = np.asarray(ji.fingerprint_array(jnp.asarray(arr), blocks))
        np.testing.assert_array_equal(
            ti.fingerprint_array(torch.from_numpy(arr.copy()),
                                 blocks).numpy(), want)
        np.testing.assert_array_equal(ti.fingerprint_array_np(arr, blocks),
                                      want)


@pytest.mark.parametrize("chunk", [1 << 24, 1000, 4096])
def test_a_long_leaf_folds_in_chunks_to_the_same_bits(monkeypatch, chunk):
    """A leaf longer than 2**20 (the numpy mirror's chunk) and 2**16,
    folded whole and in chunks (each chunk's positions carried by its
    offset), gives JAX's bits on the device path and in the mirror."""
    monkeypatch.setattr(ti, "CHUNK", chunk)
    x = np.random.RandomState(2).randn((1 << 20) + 3 * (1 << 16)
                                       + 11).astype(np.float32)
    for blocks in (1, 3, 7):
        want = ji.fingerprint_array_np(x, blocks)
        np.testing.assert_array_equal(
            ti.fingerprint_array(torch.from_numpy(x), blocks).numpy(), want)
        np.testing.assert_array_equal(ti.fingerprint_array_np(x, blocks),
                                      want)
        np.testing.assert_array_equal(
            ti.fingerprint_array(torch.from_numpy(x).bfloat16(),
                                 blocks).numpy(),
            np.asarray(ji.fingerprint_array(
                jnp.asarray(torch.from_numpy(x).bfloat16().float().numpy())
                .astype(jnp.bfloat16), blocks)))


def test_one_flipped_bit_changes_the_fingerprint_of_its_block():
    x = np.random.RandomState(1).randn(64).astype(np.float32)
    bad = x.copy()
    bad.view(np.uint32)[40] ^= np.uint32(1 << 3)
    a = ti.fingerprint_array(torch.from_numpy(x), 4).numpy()
    b = ti.fingerprint_array(torch.from_numpy(bad), 4).numpy()
    assert list(np.nonzero(a != b)[0]) == [2]


def test_tree_payload_and_block_helpers_match_jax():
    rng = np.random.RandomState(3)
    tree = {"b": rng.randn(5).astype(np.float32),
            "a": rng.randn(2, 3).astype(np.float32),
            "c": (rng.rand(4) > 0.5)}
    got = ti.fingerprint_tree({k: torch.from_numpy(v)
                               for k, v in tree.items()}).numpy()
    # the port keeps the dict's order; JAX's tree_leaves sorts the keys
    want = {k: int(ji.fingerprint_array(jnp.asarray(v))[0])
            for k, v in tree.items()}
    assert list(got) == [want[k] for k in tree]
    np.testing.assert_array_equal(
        np.asarray(ji.fingerprint_tree({k: jnp.asarray(v)
                                        for k, v in tree.items()})),
        [want[k] for k in sorted(tree)])
    assert ti.fingerprint_tree({}).shape == (0,)
    fps = rng.randint(-2 ** 31, 2 ** 31 - 1, 9).astype(np.int32)
    assert int(ti.combine_fingerprints(torch.from_numpy(fps))) == int(
        ji.combine_fingerprints(jnp.asarray(fps)))
    q = rng.randint(-128, 127, (6, 8)).astype(np.int8)
    s = rng.rand(6).astype(np.float32)
    for scales in (None, s):
        assert int(ti.payload_fingerprint(
            torch.from_numpy(q), None if scales is None
            else torch.from_numpy(scales))) == int(ji.payload_fingerprint(
                jnp.asarray(q), None if scales is None
                else jnp.asarray(scales)))
    payload = {"k": rng.randn(2, 5, 4, 3).astype(np.float32),
               "pos": rng.randint(0, 99, (5, 4)).astype(np.int32)}
    axes = {"k": 1, "pos": 0}
    assert ti.kv_payload_fingerprints(payload, axes) == \
        ji.kv_payload_fingerprints(payload, axes)


def test_majority_vote_matches_jax_and_dp_is_one_replica():
    fps = np.array([[1, 2, 3], [1, 9, 3], [1, 2, 4], [1, 2, 3]], np.int32)
    cons, div = ti.majority_vote(torch.from_numpy(fps))
    jcons, jdiv = ji.majority_vote(fps)
    np.testing.assert_array_equal(cons, jcons)
    assert div == jdiv == {1: [1], 2: [2]}
    with pytest.raises(ValueError, match="replicas"):
        ti.majority_vote(np.zeros(3))
    params = {"w": torch.ones(4), "v": torch.zeros(2)}
    mat = ti.dp_consensus_fingerprints(params)
    assert mat.shape == (1, 2)
    assert ti.majority_vote(mat)[1] == {}
    with pytest.raises(ValueError, match="blocks"):
        ti.fingerprint_array(torch.ones(2), 0)


def test_train_step_reports_the_updated_params_fingerprint():
    """``integrity_every=2``: zeros on steps 1 and 3, on steps 2 and 4 the
    fingerprint of the updated parameters, in ``state.params``' order,
    equal to the numpy mirror of a host copy and, leaf by leaf, to JAX's
    fold of the same array; the batch shape never changes, so the step
    counts one shape."""
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), cfg, device="cpu")
    tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
    step = ttr.make_train_step(pm, tx, integrity_every=2)
    ids = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    for k in range(1, 5):
        _, m = step(state, batch)
        fp = m["integrity_fp"]
        assert fp.dtype == torch.int32 and fp.shape == (len(params),)
        if k % 2:
            assert not fp.any()
            continue
        host = [p.detach().numpy().copy() for p in state.params.values()]
        np.testing.assert_array_equal(
            fp.numpy(), [ti.fingerprint_array_np(h)[0] for h in host])
        np.testing.assert_array_equal(
            fp.numpy(), [int(ji.fingerprint_array(jnp.asarray(h))[0])
                         for h in host])
    assert step.cache_size() == 1
    with pytest.raises(ValueError, match="integrity_every"):
        ttr.make_train_step(pm, tx, integrity_every=0)


# ---------------------------------------------------------------------------
# IntegrityMonitor: detection -> watchdog verified rewind
# ---------------------------------------------------------------------------

def _fake_state(step=0):
    return TrainState(step=step, params={"w": torch.zeros(64)},
                      opt_state={"m": torch.zeros(64)})


def _fp_step_fn(s, batch):
    """Fake step with the in-step fingerprint metric the monitor needs."""
    s.params["w"] += 1.0
    s.step += 1
    return s, {"loss": torch.tensor(0.1), "grad_norm": torch.tensor(1.0),
               "integrity_fp": ti.fingerprint_tree(s.params)}


def _batches(n):
    return iter([{"input_ids": np.zeros((1, 2), np.int32)}] * n)


def test_monitor_validation():
    with pytest.raises(ValueError, match="cadence"):
        ti.IntegrityMonitor(every=0)


def test_monitor_requires_step_metric():
    mon = ti.IntegrityMonitor(every=1)

    def step(s, b):
        s.step += 1
        return s, {"loss": torch.tensor(0.1)}

    trainer = Trainer(step, _fake_state(), callbacks=[mon])
    with pytest.raises(ti.IntegrityError, match="integrity_every"):
        trainer.fit(_batches(3), max_steps=3)


def test_monitor_clean_run_no_false_positives():
    mon = ti.IntegrityMonitor(every=2)
    trainer = Trainer(_fp_step_fn, _fake_state(), callbacks=[mon])
    st, _ = trainer.fit(_batches(6), max_steps=6)
    assert st.step == 6
    assert mon.checks == 3 and mon.mismatches == 0


def test_monitor_detects_flip_and_raises_without_watchdog():
    chaos = FaultPlan.parse("integrity|params : bitflip, times=1")
    mon = ti.IntegrityMonitor(every=2, chaos=chaos)
    trainer = Trainer(_fp_step_fn, _fake_state(), callbacks=[mon])
    with pytest.raises(ti.IntegrityError, match="mismatch at step 2"):
        trainer.fit(_batches(6), max_steps=6)
    assert mon.flips_injected == 1 and mon.mismatches == 1


def test_monitor_mismatch_rewinds_to_verified_checkpoint(tmp_path):
    """Chaos flips a param bit at a cadence boundary; the monitor detects
    it within that window and the watchdog's rewind restores the newest
    content-verified checkpoint. With identical per-step batches the
    replayed run ends at the fault-free final state bit for bit."""
    path = str(tmp_path / "ckpt")
    wd = Watchdog(policy="rewind", checkpoint_path=path)
    chaos = FaultPlan.parse(
        "seed=5; integrity|params : bitflip, after=1, times=1")
    mon = ti.IntegrityMonitor(every=2, watchdog=wd, chaos=chaos)
    # checkpoint BEFORE monitor: the boundary's save happens before the
    # (injected) corruption, so the rewind target is always clean
    trainer = Trainer(_fp_step_fn, _fake_state(), callbacks=[
        CheckpointCallback(path, every=2), mon])
    st, _ = trainer.fit(_batches(12), max_steps=6)
    assert mon.flips_injected == 1  # fired at the step-4 boundary
    assert mon.mismatches == 1      # detected at the same boundary
    assert wd.anomalies == 1        # recovery delegated to the watchdog
    assert st.step == 6
    assert torch.equal(st.params["w"], torch.full((64,), 6.0))


def test_the_drill_flips_the_bit_jax_flips():
    """For the same plan the port's flip lands on the same byte and bit of
    the largest parameter as the reference's, in fp32 and bf16."""
    from neuronx_distributed_tpu.resilience.integrity import (
        IntegrityMonitor as JMonitor)
    from neuronx_distributed_tpu.trainer.trainer import TrainState as JState

    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        w = torch.randn(8, 16).to(dt)
        spec = "seed=3; integrity|params : bitflip"
        tplan, jplan = FaultPlan.parse(spec), JFaultPlan.parse(spec)
        kind, _, detail = tplan.consult_detail("integrity", "params")
        jkind, _, jdetail = jplan.consult_detail("integrity", "params")
        assert (kind, detail) == (jkind, jdetail) and kind == "bitflip"

        class T:
            pass

        tt, jt = T(), T()
        tt.state = TrainState(step=0, params={"s": torch.zeros(2),
                                              "w": w.clone()},
                              opt_state={})
        jt.state = JState(step=jnp.zeros((), jnp.int32), params={
            "s": jnp.zeros(2), "w": jnp.asarray(w.float().numpy())
            .astype(jdt)}, opt_state={})
        ti.IntegrityMonitor(2)._flip_param_bit(tt, detail["bit"])
        JMonitor(2)._flip_param_bit(jt, jdetail["bit"])
        got = tt.state.params["w"]
        assert not torch.equal(got, w)
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jt.state.params["w"]).astype(np.float32))
