"""The port's ``Trainer`` loop against the JAX package's: a 6-step
``Trainer.fit`` curve, the callbacks' order with ``evaluate`` and
``eval_every``, then what the port must show on its own: resume equal to
the uninterrupted run bit for bit, SIGTERM to ``TrainingPreempted`` with a
tag that resumes, the watchdog's halt / skip_step / rewind (skip_step
restoring the pre-step parameters bit for bit), and a subprocess that runs
the whole path while refusing JAX. Weights cross with ``params_from_jax``;
batches are numpy int32 arrays, as the token loader yields them."""

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED, PreemptionGuard, TrainingPreempted)
from neuronx_distributed_tpu_torch.resilience.watchdog import (Watchdog,
                                                               WatchdogHalt)
from neuronx_distributed_tpu_torch.trainer import checkpoint as tck
from neuronx_distributed_tpu_torch.trainer import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _batches(seed, n, b=2, s=16, vocab=256):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """A tiny fp32 Llama (flash attention) in JAX, its step and its
    initial params as numpy arrays."""
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          use_flash_attention=True)
    cfg = nxd.neuronx_distributed_config(tensor_parallel_size=1,
                                         devices=jax.devices()[:1])
    try:
        model = jl.LlamaForCausalLM(jcfg)
        pm, params = jtr.initialize_parallel_model(
            cfg, model, jax.random.key(0), jnp.zeros((2, 16), jnp.int32))
        tx, state, sh = jtr.initialize_parallel_optimizer(
            pm, params, learning_rate=LR)
        step = jtr.make_train_step(pm, tx, sh, donate=False)
        eval_fn = jax.jit(lambda p, b: model.apply(
            p, b["input_ids"], b["labels"], method="loss"))
        init = jax.tree.map(np.array, meta.unbox(state.params))
        yield {"step": step, "state": state, "eval_fn": eval_fn,
               "params": init}
    finally:
        ps.destroy_model_parallel()


def _port(jax_run, **cfg_kw):
    tcfg = tl.tiny_config(dtype=torch.float32, use_flash_attention=True,
                          **cfg_kw)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), tcfg,
        state_dict=params_from_jax(tcfg, jax_run["params"]), device="cpu")
    tx, state = ttr.initialize_parallel_optimizer(pm, params,
                                                  learning_rate=LR)
    step = ttr.make_train_step(pm, tx)

    def eval_fn(params, batch):
        return pm.module.loss(torch.as_tensor(batch["input_ids"]),
                              torch.as_tensor(batch["labels"]))

    return pm, state, step, eval_fn


class Record:
    """Logs the hooks in order (duck-typed, so either package's Trainer
    takes it)."""

    def __init__(self):
        self.events, self.losses, self.eval_losses = [], [], []

    def on_train_start(self, trainer):
        self.events.append(("start", trainer.host_step))

    def on_step_end(self, trainer, metrics):
        self.events.append(("step", trainer.host_step))
        self.losses.append(float(metrics["loss"]))

    def on_eval_end(self, trainer, metrics):
        self.events.append(("eval", trainer.host_step,
                            metrics["eval_batches"]))
        self.eval_losses.append(metrics["eval_loss"])

    def on_train_end(self, trainer):
        self.events.append(("end", trainer.host_step))


def test_fit_curve_and_hooks_match_jax(jax_run):
    batches = _batches(0, 6)
    evals = _batches(9, 2)
    runs = {}
    for name in ("jax", "torch"):
        if name == "jax":
            step, state, eval_fn = (jax_run["step"], jax_run["state"],
                                    jax_run["eval_fn"])
            trainer_cls = jloop.Trainer
        else:
            _, state, step, eval_fn = _port(jax_run)
            trainer_cls = tloop.Trainer
        rec = Record()
        trainer = trainer_cls(step, state, callbacks=[rec], eval_fn=eval_fn)
        final, metrics = trainer.fit(iter(batches), max_steps=6,
                                     eval_batches=iter(evals), eval_every=4)
        runs[name] = (rec, int(final.step), metrics)
    (jrec, jstep, jm), (trec, tstep, tm) = runs["jax"], runs["torch"]
    assert trec.events == jrec.events
    assert trec.events[-3:] == [("step", 6), ("eval", 6, 2), ("end", 6)]
    assert tstep == jstep == 6
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-4)
    np.testing.assert_allclose(trec.eval_losses, jrec.eval_losses,
                               rtol=1e-4)
    assert tm["eval_batches"] == jm["eval_batches"] == 2
    assert trec.losses[-1] < trec.losses[0]


def test_eval_needs_eval_fn_in_both(jax_run):
    _, state, step, _ = _port(jax_run)
    for trainer in (tloop.Trainer(step, state),
                    jloop.Trainer(jax_run["step"], jax_run["state"])):
        with pytest.raises(ValueError, match="eval_fn"):
            trainer.fit(iter(_batches(0, 1)), eval_batches=[{}])
        with pytest.raises(ValueError, match="eval_fn"):
            trainer.evaluate([{}])


def _snapshot(state):
    return tck.state_to_tree(state, lambda t: t.detach().clone())


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_resume_equals_the_uninterrupted_run_bit_for_bit(jax_run, tmp_path):
    batches = _batches(1, 6)
    path = str(tmp_path / "ck")
    _, state, step, _ = _port(jax_run)
    rec_a = Record()
    tloop.Trainer(step, state, callbacks=[rec_a]).fit(iter(batches))
    want = _snapshot(state)

    _, state, step, _ = _port(jax_run)
    tloop.Trainer(step, state, callbacks=[
        tloop.CheckpointCallback(path, every=2, num_kept=1)]).fit(
            iter(batches[:4]))
    assert tck.list_complete_tags(path) == ["4"]
    _, fresh, step, _ = _port(jax_run)
    trainer = tloop.Trainer(step, fresh, resume_path=path)
    assert trainer.host_step == 4 and fresh.opt_state.count == 4
    rec_b = Record()
    trainer.callbacks = [rec_b]
    final, _ = trainer.fit(iter(batches[4:]), max_steps=6)
    assert rec_b.losses == rec_a.losses[4:]
    _assert_same(_snapshot(final), want)


def test_sigterm_saves_a_tag_that_resumes(jax_run, tmp_path):
    batches = _batches(2, 5)
    path = str(tmp_path / "ck")
    _, state, step, _ = _port(jax_run)
    tloop.Trainer(step, state).fit(iter(batches))
    want = _snapshot(state)

    class Kill(tloop.Callback):
        def on_step_end(self, trainer, metrics):
            if trainer.host_step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    guard = PreemptionGuard(grace_s=60.0)
    _, state, step, _ = _port(jax_run)
    trainer = tloop.Trainer(step, state, callbacks=[
        tloop.CheckpointCallback(path, every=100), Kill()],
        preemption_guard=guard)
    try:
        with pytest.raises(TrainingPreempted) as ei:
            trainer.fit(iter(batches), max_steps=5)
    finally:
        guard.uninstall()
    assert ei.value.code == EXIT_PREEMPTED == 75
    assert ei.value.step == 3 and ei.value.saved_tag == "3"
    _, fresh, step, _ = _port(jax_run)
    resumed = tloop.Trainer(step, fresh, resume_path=path)
    assert resumed.host_step == 3
    final, _ = resumed.fit(iter(batches[3:]), max_steps=5)
    _assert_same(_snapshot(final), want)


def test_preemption_past_the_grace_flushes_only(jax_run, tmp_path,
                                                monkeypatch):
    """The emergency save is still running at the deadline: it is
    abandoned and no tag is reported. The save is held until the test
    ends, since a tiny state's save could otherwise finish before the
    zero-second deadline is read."""
    path = str(tmp_path / "ck")
    guard = PreemptionGuard(checkpoint_path=path, grace_s=0.0,
                            signals=(signal.SIGUSR1,))
    _, state, step, _ = _port(jax_run)
    release = threading.Event()
    monkeypatch.setattr(tloop.ckpt, "save_checkpoint",
                        lambda *a, **kw: release.wait(60))

    class Kill(tloop.Callback):
        def on_step_end(self, trainer, metrics):
            os.kill(os.getpid(), signal.SIGUSR1)

    trainer = tloop.Trainer(step, state, callbacks=[Kill()],
                            preemption_guard=guard)
    try:
        with pytest.raises(TrainingPreempted) as ei:
            trainer.fit(iter(_batches(0, 3)))
    finally:
        guard.uninstall()
        release.set()
    assert ei.value.saved_tag is None and not tck.has_checkpoint(path)


def _nan_at(step, call):
    """``step`` whose loss reads NaN on the ``call``-th call (1-based),
    after its update has landed."""
    calls = [0]

    def wrapped(state, batch):
        state, metrics = step(state, batch)
        calls[0] += 1
        if calls[0] == call:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return state, metrics

    return wrapped


def test_watchdog_halt(jax_run):
    _, state, step, _ = _port(jax_run)
    wd = Watchdog(policy="halt")
    assert not wd.needs_prev_state
    trainer = tloop.Trainer(_nan_at(step, 2), state, callbacks=[wd])
    assert trainer._track_prev is False
    with pytest.raises(WatchdogHalt, match="non-finite"):
        trainer.fit(iter(_batches(0, 5)))
    assert wd.anomalies == 1 and trainer.host_step == 2


def test_watchdog_skip_step_restores_the_pre_step_state(jax_run):
    batches = _batches(3, 5)
    _, state, step, _ = _port(jax_run)
    seen = {}

    class Keep(tloop.Callback):
        def on_step_end(self, trainer, metrics):
            if trainer.host_step == 2:
                seen["before_bad"] = _snapshot(trainer.state)

    wd = Watchdog(policy="skip_step")
    assert wd.needs_prev_state
    trainer = tloop.Trainer(_nan_at(step, 3), state,
                            callbacks=[Keep(), wd])
    final, _ = trainer.fit(iter(batches), max_steps=4)
    assert wd.anomalies == 1 and trainer.host_step == 4
    assert final.step == 4 and final.opt_state.count == 4
    # the run equals one that never took the third batch
    _, other, step, _ = _port(jax_run)
    tloop.Trainer(step, other).fit(iter(batches[:2] + batches[3:]))
    _assert_same(_snapshot(final), _snapshot(other))


def test_watchdog_skip_step_copies_back_bit_for_bit(jax_run):
    _, state, step, _ = _port(jax_run)
    before = {}

    def bad_step(s, batch):
        before.update(_snapshot(s))
        s, m = step(s, batch)
        return s, dict(m, loss=torch.tensor(float("inf")))

    trainer = tloop.Trainer(bad_step, state,
                            callbacks=[Watchdog(policy="skip_step")])
    params = list(state.params.values())
    trainer.fit(iter(_batches(4, 1)))
    _assert_same(_snapshot(trainer.state), before)
    assert list(trainer.state.params.values()) == params


def test_watchdog_rewind(jax_run, tmp_path):
    path = str(tmp_path / "ck")
    _, state, step, _ = _port(jax_run)
    seen = {}

    class Keep(tloop.Callback):
        def on_step_end(self, trainer, metrics):
            seen.setdefault(trainer.host_step, _snapshot(trainer.state))

    wd = Watchdog(policy="rewind", checkpoint_path=path)
    trainer = tloop.Trainer(_nan_at(step, 4), state, callbacks=[
        tloop.CheckpointCallback(path, every=2), wd, Keep()])
    trainer.fit(iter(_batches(5, 8)), max_steps=5)
    assert wd.anomalies == 1
    # call 4 rewound to the tag-2 state, then steps 3-5 ran again
    assert trainer.host_step == 5
    tree, _ = tck.load_checkpoint(path, tag=2, device="cpu")
    _assert_same(tree, seen[2])


@pytest.mark.parametrize("policy", ["halt", "skip_step"])
def test_finished_trainer_frees_its_model_without_gc(jax_run, tmp_path,
                                                     policy):
    """A finished ``Trainer`` with a ``Watchdog`` holds no reference cycle:
    dropping the trainer, the state and the model frees the parameters at
    once, with the garbage collector off (on the card, a cycle kept a
    finished run's weights and moments allocated into the next model)."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        pm, state, step, _eval = _port(jax_run)
        wd = Watchdog(policy=policy, stall_timeout_s=60.0)
        trainer = tloop.Trainer(step, state, callbacks=[
            tloop.MetricsLogger(every=1), wd,
            tloop.CheckpointCallback(str(tmp_path / "ck"), every=1)])
        trainer.fit(iter(_batches(0, 2)))
        refs = [weakref.ref(t) for t in trainer.state.params.values()]
        refs.append(weakref.ref(pm.module))
        del pm, state, step, _eval, trainer
        assert not any(r() is not None for r in refs)
        assert wd.stalls == 0  # the watchdog itself lives on
    finally:
        gc.enable()


_LOOP_ISOLATED = """
import os, sys, tempfile

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "neuronx_distributed_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import (
    ActivationCheckpointConfig, configure_model, neuronx_distributed_config)
from neuronx_distributed_tpu_torch.data import TokenBatchLoader
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog

ncfg = neuronx_distributed_config(
    activation_checkpoint_config=ActivationCheckpointConfig(mode="full"))
cfg = configure_model(ncfg, tl.tiny_config(
    num_layers=1, use_flash_attention=True, remat_policy="save_attention",
    loss_chunk=8))
tmp = tempfile.mkdtemp(dir=os.environ["NXD_TEST_TMP"])
np.random.RandomState(0).randint(0, 256, 4000).astype(np.uint32).tofile(
    tmp + "/tokens.bin")
loader = TokenBatchLoader(tmp + "/tokens.bin", 2, 16, dtype="uint32")
assert loader.native
pm, params = ttr.initialize_parallel_model(ncfg, cfg, device="cpu")
tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
step = ttr.make_train_step(pm, tx)
trainer = ttr.Trainer(step, state, callbacks=[
    ttr.MetricsLogger(every=2), Watchdog(policy="halt"),
    ttr.CheckpointCallback(tmp + "/ck", every=2, num_kept=1)])
final, m = trainer.fit(loader, max_steps=3)
pm2, params2 = ttr.initialize_parallel_model(ncfg, cfg, seed=1,
                                             device="cpu")
tx2, state2 = ttr.initialize_parallel_optimizer(pm2, params2, 1e-3)
resumed = ttr.Trainer(ttr.make_train_step(pm2, tx2), state2,
                      resume_path=tmp + "/ck")
assert all(torch.equal(params[k], params2[k]) for k in params)
loader.close()
print("fit", final.step, resumed.host_step)
"""


def test_trainer_path_imports_nothing_of_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, NXD_TEST_TMP=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _LOOP_ISOLATED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == ["fit 3 3"]


_FIRST_MODEL_FREED = """
import gc, weakref
import numpy as np
import torch
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog

gc.disable()
cfg = tl.tiny_config(dtype=torch.float32, use_flash_attention=True,
                     remat=True, remat_policy="save_attention")
pm, params = ttr.initialize_parallel_model(neuronx_distributed_config(),
                                           cfg, device="cpu")
tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
ids = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)
trainer = ttr.Trainer(ttr.make_train_step(pm, tx), state,
                      callbacks=[Watchdog(policy="skip_step")])
trainer.fit([{"input_ids": ids[:, :-1], "labels": ids[:, 1:]}] * 2)
refs = [weakref.ref(t) for t in params.values()] + [weakref.ref(pm.module)]
del pm, params, tx, state, trainer
print("alive", sum(r() is not None for r in refs))
"""


def test_first_model_of_a_process_is_freed_without_gc():
    """The first forward of a process imports the operator machinery of
    ``torch`` (``torch._dynamo``) unless the port imported it already; an
    import made under a forward would keep that forward's stack, and the
    model with it, alive until a garbage collection."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _FIRST_MODEL_FREED],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == ["alive 0"]
