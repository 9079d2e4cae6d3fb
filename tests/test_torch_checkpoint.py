"""The port's checkpoint engine against the JAX package's commit protocol,
and what is the port's own: the payload's round trip, the snapshot that an
in-place step cannot reach, and the object-store backend.

The same sequence of saves, an overwrite, an incomplete tag, a truncated
and a flipped payload, and retention runs through both packages, which
must agree on ``list_complete_tags``, the ``newest`` pointer, the
fallback of auto-resume and what raises. The payloads differ (Orbax in
JAX, one ``torch.save`` in the port), so the values loaded are compared
with the values saved.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuronx_distributed_tpu.trainer import checkpoint as jck
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.trainer import checkpoint as tck
from neuronx_distributed_tpu_torch.trainer import checkpoint_storage as tcs


def _values(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(8, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


def _jax_state(seed, step):
    v = _values(seed)
    return {"params": {k: jnp.asarray(a) for k, a in v.items()},
            "step": jnp.asarray(step, jnp.int32)}


def _torch_state(seed, step):
    v = _values(seed)
    return {"params": {k: torch.from_numpy(a) for k, a in v.items()},
            "step": step}


def _payload_files(path, tag):
    sdir = os.path.join(path, str(tag), "state")
    return [os.path.join(r, f) for r, _, fs in os.walk(sdir) for f in fs]


def _truncate(path, tag):
    victim = max(_payload_files(path, tag), key=os.path.getsize)
    with open(victim, "r+b") as fh:
        fh.truncate(os.path.getsize(victim) // 2)


def _flip(path, tag):
    victim = max(_payload_files(path, tag), key=os.path.getsize)
    with open(victim, "r+b") as fh:
        fh.seek(os.path.getsize(victim) // 2)
        byte = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([byte[0] ^ 0xFF]))


def _run_protocol(ck, root, state, **load_kw):
    """One sequence of saves, damage and loads; what a caller can see."""
    path = os.path.join(root, "ck")
    seen = {}
    # one async commit at a time: the reference's storage publishes
    # ``newest`` through one shared temporary name, which two commit
    # threads at once can race on (the port's gives each writer its own)
    ck.save_checkpoint(path, 1, state(1, 1), async_save=False)
    ck.save_checkpoint(path, 2, state(2, 2), async_save=True)
    ck.finalize_checkpoint()
    ck.save_checkpoint(path, 3, state(3, 3), user_content={"lr": 0.5},
                       async_save=True)
    ck.finalize_checkpoint()
    ck.save_checkpoint(path, 2, state(22, 2), async_save=False)  # overwrite
    seen["after_saves"] = ck.list_complete_tags(path)
    seen["newest"] = open(os.path.join(path, "newest")).read()
    # an incomplete save: the tag's files without the done-marker
    ck.save_checkpoint(path, 4, state(4, 4), async_save=False)
    os.remove(os.path.join(path, "4", "checkpoint"))
    seen["with_incomplete"] = ck.list_complete_tags(path)
    seen["has_4"] = ck.has_checkpoint(path, "4")
    _flip(path, 3)
    seen["verify"] = {t: ck.verify_checkpoint(path, t)[0]
                      for t in ck.list_complete_tags(path)}
    loaded, uc = ck.load_checkpoint(path, tag=None, **load_kw)
    seen["resumed_w"] = np.asarray(loaded["params"]["w"])
    seen["resumed_step"] = int(loaded["step"])
    seen["resumed_uc"] = uc
    with pytest.raises(ck.CheckpointCorruptionError, match="corrupt"):
        ck.load_checkpoint(path, tag=3, **load_kw)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(path, tag=4, **load_kw)
    _truncate(path, 2)
    ok, why = ck.verify_checkpoint(path, 2)
    seen["truncated"] = (ok, "size mismatch" in why)
    loaded, _ = ck.load_checkpoint(path, tag="-1", **load_kw)
    seen["fallback_w"] = np.asarray(loaded["params"]["w"])
    _truncate(path, 1)
    with pytest.raises(ck.CheckpointCorruptionError, match="no intact"):
        ck.load_checkpoint(path, tag=None, **load_kw)
    # retention keeps the newest complete tags, whatever else is there
    for t in (5, 6, 7):
        ck.save_checkpoint(path, t, state(t, t), async_save=True,
                           num_kept=2)
        ck.finalize_checkpoint()
    seen["retained"] = ck.list_complete_tags(path)
    seen["dirs"] = sorted(d for d in os.listdir(path)
                          if os.path.isdir(os.path.join(path, d)))
    return seen


def test_commit_protocol_matches_jax(tmp_path):
    got = _run_protocol(tck, str(tmp_path / "torch"), _torch_state,
                        device="cpu")
    ref = _run_protocol(jck, str(tmp_path / "jax"), _jax_state)
    assert got.keys() == ref.keys()
    for key in got:
        if key.endswith("_w"):
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            assert got[key] == ref[key], key
    assert got["after_saves"] == ["1", "2", "3"] and got["newest"] == "2"
    assert got["verify"] == {"1": True, "2": True, "3": False}
    np.testing.assert_array_equal(got["resumed_w"], _values(22)["w"])
    np.testing.assert_array_equal(got["fallback_w"], _values(1)["w"])
    assert got["retained"] == ["6", "7"]


def test_concurrent_async_commits_keep_the_protocol(tmp_path):
    """Eight async saves in flight at once, each with retention: every
    commit succeeds, the newest two complete tags survive, and ``newest``
    names one of the committed tags."""
    path = str(tmp_path / "ck")
    for t in range(1, 9):
        tck.save_checkpoint(path, t, _torch_state(t, t), async_save=True,
                            num_kept=2)
    tck.finalize_checkpoint()
    assert tck.list_complete_tags(path) == ["7", "8"]
    assert open(os.path.join(path, "newest")).read() in {
        str(t) for t in range(1, 9)}
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]


def _train_state(seed, steps=2, device="cpu"):
    cfg = tl.tiny_config(dtype=torch.float32, num_layers=1,
                         use_flash_attention=True)
    pm, params = ttr.initialize_parallel_model(
        neuronx_distributed_config(), cfg, seed=seed, device=device)
    tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-2)
    step = ttr.make_train_step(pm, tx)
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (2, 9)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    for _ in range(steps):
        state, _ = step(state, batch)
    return pm, state, step, batch


def _tensors(state):
    return tck.state_to_tree(state, lambda t: t.detach().clone())


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a == b


def test_train_state_round_trips_bit_for_bit(tmp_path):
    path = str(tmp_path / "ck")
    pm, state, _, _ = _train_state(0)
    saved = _tensors(state)
    tck.save_checkpoint(path, state.step, state, async_save=False)
    pm2, other, _, _ = _train_state(1, steps=1)
    params_before = [p for p in pm2.module.parameters()]
    loaded, uc = tck.load_checkpoint(path, target=other)
    assert loaded is other and uc is None
    assert other.step == 2 and other.opt_state.count == 2
    _assert_trees_equal(_tensors(other), saved)
    # in place: the model's own parameters now hold the saved values
    assert [p for p in pm2.module.parameters()] == params_before
    for name, p in pm2.module.named_parameters():
        assert torch.equal(p, saved["params"][name])
    tree, _ = tck.load_checkpoint(path, tag=2, device="cpu")
    _assert_trees_equal(tree, saved)
    # a target of another shape refuses
    _, small, _, _ = _train_state(0, steps=0)
    small.params.pop(next(iter(small.params)))
    with pytest.raises(ValueError, match="holds"):
        tck.load_checkpoint(path, tag=2, target=small)


def test_async_save_holds_the_pre_step_values(tmp_path, monkeypatch):
    """The step right after an async save updates the parameters and
    moments in place while the commit thread writes; the checkpoint holds
    the values of the save. The commit's write waits here until the step
    is done, so a save that wrote the live tensors would hold the
    post-step values."""
    path = str(tmp_path / "ck")
    _, state, step, batch = _train_state(0)
    saved = _tensors(state)
    stepped = threading.Event()
    write = tck._write_payload

    def late_write(*args):
        assert stepped.wait(timeout=60)
        write(*args)

    monkeypatch.setattr(tck, "_write_payload", late_write)
    tck.save_checkpoint(path, state.step, state, async_save=True)
    state, _ = step(state, batch)
    stepped.set()
    tck.finalize_checkpoint()
    after = _tensors(state)
    assert not torch.equal(after["params"]["embed.embedding"],
                           saved["params"]["embed.embedding"])
    tree, _ = tck.load_checkpoint(path, tag=2, device="cpu")
    _assert_trees_equal(tree, saved)


def test_async_commit_failure_raises_at_the_next_save(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "ck")

    def fail(*args):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tck, "_write_payload", fail)
    tck.save_checkpoint(path, 1, _torch_state(1, 1), async_save=True)
    with pytest.raises(tck.CheckpointSaveError, match="1"):
        tck.finalize_checkpoint()
    assert not tck.has_checkpoint(path)


def test_object_store_backend_round_trips():
    """``memory://`` goes through ``ObjectStoreCheckpointStorage``
    (fsspec), payload included."""
    path = "memory://nxd-torch-ckpt-test"
    assert isinstance(tcs.create_checkpoint_storage(path),
                      tcs.ObjectStoreCheckpointStorage)
    try:
        for t in (1, 2):
            tck.save_checkpoint(path, t, _torch_state(t, t),
                                user_content={"t": t}, async_save=True,
                                num_kept=1)
        tck.finalize_checkpoint()
        assert tck.list_complete_tags(path) == ["2"]
        assert tck.verify_checkpoint(path, 2)[0]
        tree, uc = tck.load_checkpoint(path, device="cpu")
        np.testing.assert_array_equal(tree["params"]["w"].numpy(),
                                      _values(2)["w"])
        assert uc == {"t": 2} == tck.user_content(path, 2)
    finally:
        tcs.create_checkpoint_storage(path).remove_dir(path)


def test_storage_wrapper_sees_every_storage(tmp_path):
    seen = []

    def wrap(storage):
        seen.append(type(storage).__name__)
        return storage

    tcs.install_storage_wrapper(wrap)
    try:
        tck.save_checkpoint(str(tmp_path / "ck"), 1, _torch_state(1, 1),
                            async_save=False)
    finally:
        tcs.clear_storage_wrapper()
    assert seen == ["FilesysCheckpointStorage"]


def test_load_refuses_the_card_without_one(tmp_path):
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, 1, _torch_state(1, 1), async_save=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tck.load_checkpoint(path)
