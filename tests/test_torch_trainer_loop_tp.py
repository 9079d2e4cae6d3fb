"""The ``Trainer`` loop across ranks: the port's world of four gloo ranks
on the CPU (``utils.cpu_mesh.run_ranks``) against the JAX package's
``Trainer.fit`` over its GSPMD step at the same ``tensor_parallel_size`` on
a 4-device mesh, from the same weights (``params_from_jax``) and global
batches. One world runs every part at its own layout of the same ranks
(``tests/torch_ranks.py:loop_world``): the fit at tp=2 x dp=2 with
sequence parallelism, ZeRO-1, ``integrity_every`` and async sharded
checkpoints; resume at the same layout (bit for bit), at tp=4, and at
tp=1 through ``scripts/reshard_checkpoint.py``; a corrupt rank file; the
bit-flip drill; SIGTERM to one rank; dropout at global coordinates; and
the reference's ``test_sharded_save_resharded_restore``.

Tolerances are ``tests/test_torch_train_tp.py``'s: the loss before any
update within 1e-6 relative, later losses 1e-4, grad norms 1e-3, updated
parameters 1e-3 x max|p|; a resume at another layout holds losses within
1e-5. Fingerprints, masks and same-layout resumes are bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.ops import flash_attention as jfa
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.resilience import integrity as jint
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import (MixedPrecisionConfig,
                                                  neuronx_distributed_config)
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.resilience.integrity import (
    fingerprint_array_np)
from neuronx_distributed_tpu_torch.scripts import reshard_checkpoint
from neuronx_distributed_tpu_torch.trainer import checkpoint as tck
from neuronx_distributed_tpu_torch.trainer import loop as tloop
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ranks

LR = 1e-3
DROP_SEED = 5


def _batches(seed, n, b=4, s=16, vocab=256):
    """Global batches whose data rank 0 rows ignore more labels than data
    rank 1's."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
        labels = ids[:, 1:].copy()
        labels[:b // 2, :4] = -100
        out.append({"input_ids": ids[:, :-1], "labels": labels})
    return out


def _jax_fit(batches, tp=2):
    """JAX ``Trainer.fit`` over the GSPMD step at ``tp`` on 4 devices
    (sequence parallel, ZeRO-1): each step's loss and grad norm, the
    initial and final params as numpy arrays."""
    cfg = nxd.neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=True,
        optimizer_config=nxd.OptimizerConfig(zero_one_enabled=True),
        devices=jax.devices()[:4],
        mixed_precision_config=nxd.MixedPrecisionConfig(
            compute_dtype="float32"))
    try:
        jcfg = nxd.configure_model(cfg, jl.tiny_config(
            dtype=jnp.float32, param_dtype=jnp.float32, num_layers=2,
            use_flash_attention=True))
        pm, params = jtr.initialize_parallel_model(
            cfg, jl.LlamaForCausalLM(jcfg), jax.random.key(0),
            jnp.zeros((4, 16), jnp.int32))
        init = jax.tree.map(np.array, params)
        tx, state, sh = jtr.initialize_parallel_optimizer(
            pm, params, learning_rate=LR)
        step = jtr.make_train_step(pm, tx, sh, donate=False)
        metrics = []

        class Rec:
            def on_train_start(self, trainer): ...

            def on_eval_end(self, trainer, m): ...

            def on_train_end(self, trainer): ...

            def on_step_end(self, trainer, m):
                metrics.append((float(m["loss"]), float(m["grad_norm"])))

        final, _ = jloop.Trainer(step, state, callbacks=[Rec()]).fit(
            iter([{k: jnp.asarray(v) for k, v in b.items()}
                  for b in batches]), max_steps=len(batches))
        return metrics, init, jax.tree.map(np.asarray, final.params)
    finally:
        jmesh.destroy_model_parallel()


def _cfg(**kw):
    return tl.tiny_config(dtype=torch.float32, num_layers=2,
                          use_flash_attention=True, **kw)


def _gather(outs, part, tp, cfg=None):
    """The whole params from data rank 0's tp shards of ``part``."""
    first = sorted((o[part] for o in outs if o[part]["coords"]["dp"] == 0),
                   key=lambda o: o["coords"]["tp"])
    return convert.gather_state_dict(
        dataclasses.replace(cfg or _cfg(), tp_size=tp),
        [o["params"] for o in first])


def _port_world1(sd, cfg, batches, resume=None, **step_kw):
    """The port's one-rank ``Trainer.fit`` (held to JAX by
    ``tests/test_torch_trainer_loop.py``): its metrics and final params."""
    ncfg = neuronx_distributed_config(
        mixed_precision_config=MixedPrecisionConfig(compute_dtype="float32"))
    pm, params = ttr.initialize_parallel_model(ncfg, cfg, state_dict=sd,
                                               device="cpu")
    tx, state = ttr.initialize_parallel_optimizer(pm, params, LR)
    step = ttr.make_train_step(pm, tx, **step_kw)
    rec = torch_ranks._Record()
    trainer = tloop.Trainer(step, state, callbacks=[rec], resume_path=resume)
    start = trainer.host_step
    trainer.fit(iter(batches[start:]), max_steps=len(batches))
    return rec.metrics, torch_ranks._params(state), start


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    batches = _batches(3, 4)
    jmetrics, init, jfinal = _jax_fit(batches)
    sd = convert.params_from_jax(_cfg(), init)
    tmp = tmp_path_factory.mktemp("loop_world")
    store = tmp / "store"
    store.mkdir()
    tck.save_checkpoint(str(tmp / "one"), 1,
                        {"w": torch.arange(32.0).reshape(8, 4)},
                        async_save=False)
    outs = run_ranks(torch_ranks.loop_world, 4, backend="gloo", device="cpu",
                     store_dir=str(store), args=(
                         _cfg(), sd, batches, str(tmp),
                         _cfg(attention_dropout=0.3), DROP_SEED),
                     timeout=400)
    return dict(batches=batches, jax=jmetrics, sd=sd, tmp=tmp,
                jfinal=convert.params_from_jax(_cfg(), jfinal), outs=outs)


def test_fit_at_tp2_dp2_matches_jax_trainer_fit_over_gspmd(world):
    """Every rank reports JAX ``Trainer.fit``'s losses and grad norms; the
    tp shards gathered equal JAX's final params; the data-parallel twins
    end equal; ZeRO-1 halves the moments; tags 2 and 4 were committed and
    the monitor checked both boundaries without a mismatch."""
    outs = world["outs"]
    for r, o in enumerate(outs):
        assert o["jax_modules"] == [], o["jax_modules"]
        for i, ((loss, norm), (jl_, jn)) in enumerate(zip(
                o["fit"]["metrics"], world["jax"])):
            np.testing.assert_allclose(loss, jl_, rtol=1e-6 if i == 0
                                       else 1e-4, err_msg=f"rank {r} {i}")
            np.testing.assert_allclose(norm, jn, rtol=1e-3,
                                       err_msg=f"rank {r} {i}")
        assert o["fit"]["tags"] == ["2", "4"]
        assert (o["fit"]["checks"], o["fit"]["mismatches"]) == (2, 0)
    got = _gather(outs, "fit", 2)
    for name, p in got.items():
        w = world["jfinal"][name].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
    for o in outs:
        twin = next(t for t in outs if t["fit"]["coords"]["tp"]
                    == o["fit"]["coords"]["tp"]
                    and t["fit"]["coords"]["dp"] == 0)
        for name, p in o["fit"]["params"].items():
            assert torch.equal(p, twin["fit"]["params"][name]), name
    shapes = [tuple(p.shape) for p in outs[0]["fit"]["params"].values()]
    assert any(m != s for m, s in zip(outs[0]["fit"]["moments"], shapes))


def test_integrity_fp_across_ranks_is_each_whole_leafs_fingerprint(world):
    """``integrity_fp`` at step 4, on every rank, equals the numpy
    fingerprint of each whole parameter (the tp shards gathered), bit for
    bit: the shards' folds summed over tp are the whole tensor's."""
    got = _gather(world["outs"], "fit", 2)
    want = np.array([int(fingerprint_array_np(t.numpy())[0])
                     for t in got.values()], np.int32)
    for o in world["outs"]:
        assert np.array_equal(o["fit"]["fps"][4].numpy(), want)
        assert not np.array_equal(o["fit"]["fps"][2].numpy(), want)


def test_resume_at_the_same_layout_is_bit_for_bit(world):
    """Tag 2 loaded into a fresh state at tp=2 x dp=2: steps 3-4 give the
    uninterrupted run's losses and parameters bit for bit."""
    for o in world["outs"]:
        assert o["same"]["step"] == 4
        assert o["same"]["metrics"] == o["fit"]["metrics"][2:]
        for name, p in o["same"]["params"].items():
            assert torch.equal(p, o["fit"]["params"][name]), name


def test_resume_at_tp4_holds_the_losses(world):
    """Tag 2 (saved at tp=2 x dp=2 with ZeRO-1) loaded at tp=4 x dp=1
    without ZeRO-1: steps 3-4 within 1e-5 of the uninterrupted losses,
    each parameter's update over the four steps within 1e-3 of its norm
    (Adam moves an element whose gradient is within rounding of zero by
    any fraction of lr, so no element-wise limit holds)."""
    outs = world["outs"]
    ref = outs[0]["fit"]["metrics"][2:]
    for o in outs:
        for (loss, _), (want, _) in zip(o["tp4"]["metrics"], ref):
            np.testing.assert_allclose(loss, want, rtol=1e-5)
    got = _gather(outs, "tp4", 4)
    fit = _gather(outs, "fit", 2)
    for name, p in got.items():
        upd = fit[name] - world["sd"][name]
        assert ((p - fit[name]).norm() / upd.norm()).item() <= 1e-3, name


def test_reshard_cli_merges_and_the_one_rank_step_resumes(world, tmp_path):
    """``reshard_checkpoint`` merges tag 2 into a one-rank checkpoint, and
    writes it out again as tp=2 x dp=2 ranks would; the port's tp=1
    ``Trainer`` resumes from either, and steps 3-4 hold the uninterrupted
    losses within 1e-5."""
    src = str(world["tmp"] / "a")
    merged, relaid = str(tmp_path / "merged"), str(tmp_path / "relaid")
    out = reshard_checkpoint.main(["--input", src, "--tag", "2", "--output",
                                   merged, "--device", "cpu"])
    assert out.endswith("2")
    table = tck.saved_shard_table(merged, "2")
    assert (table["tp"], table["dp"]) == (1, 1)
    reshard_checkpoint.main(["--input", src, "--tag", "2", "--output",
                             relaid, "--device", "cpu", "--tp", "2", "--dp",
                             "2"])
    assert tck.saved_shard_table(relaid, "2")["tp"] == 2
    ref = world["outs"][0]["fit"]["metrics"][2:]
    for path in (merged, relaid):
        assert tck.verify_checkpoint(path, "2")[0]
        metrics, _, start = _port_world1(world["sd"], _cfg(),
                                         world["batches"], resume=path)
        assert start == 2
        for (loss, _), (want, _) in zip(metrics, ref):
            np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_a_corrupt_rank_file_falls_back_on_every_rank(world):
    """One byte of rank (tp=1, dp=1)'s file of tag 4 flipped: every rank's
    auto-resume falls back to tag 2, and an explicit load of tag 4 raises
    ``CheckpointCorruptionError`` on every rank."""
    for o in world["outs"]:
        assert o["corrupt"]["step"] == 2
        assert "corrupt" in o["corrupt"]["explicit"], o["corrupt"]


def test_bitflip_in_one_data_ranks_shard_rewinds_every_rank(world):
    """The drill: a bit flipped in data rank 1's shard at the step-4
    boundary, after that boundary's save. Every rank sees the mismatch
    there, its watchdog rewinds to tag 4, and the rewound parameters'
    fingerprint is step 4's own. With two replicas the vote ties: one of
    them is outvoted (detection without localization)."""
    for o in world["outs"]:
        d = o["drill"]
        flipped = o["fit"]["coords"]["dp"] == 1 and o["fit"][
            "coords"]["tp"] == 0
        assert d["flips"] == int(flipped)
        assert (d["mismatches"], d["checks"], d["rewinds"],
                d["host_step"]) == (1, 2, 1, 4)
        assert torch.equal(d["rewound"], d["step4"])
        assert len(d["divergent"]) == 1


def test_sigterm_to_one_rank_saves_one_tag_and_loses_no_step(world):
    """SIGTERM to rank 3 at step 3: every rank stops there with
    ``TrainingPreempted`` (exit code 75) after saving tag 3; a fresh state
    resumes from it, trains step 4, and ends bit for bit where the
    uninterrupted run did."""
    for o in world["outs"]:
        s = o["sigterm"]
        assert s["preempted"] == (3, "3", 75)
        assert s["tags"] == ["3"] and s["resumed_at"] == 3
        for name, p in s["params"].items():
            assert torch.equal(p, o["fit"]["params"][name]), name


def test_dropout_across_ranks_matches_the_one_rank_step(world):
    """Attention dropout at tp=2 x dp=2 with a generator seeded alike on
    every rank: each rank draws the masks at its rows and heads of the
    global array, so the losses are the one-rank step's with the same
    generator (within 1e-6 before any update, 1e-4 after)."""
    cfg = _cfg(attention_dropout=0.3)
    metrics, _, _ = _port_world1(
        world["sd"], cfg, world["batches"][:3],
        dropout_generator=torch.Generator().manual_seed(DROP_SEED))
    plain, _, _ = _port_world1(world["sd"], cfg, world["batches"][:3])
    for o in world["outs"]:
        for i, ((loss, _), (want, _)) in enumerate(zip(
                o["dropout"]["metrics"], metrics)):
            np.testing.assert_allclose(loss, want,
                                       rtol=1e-6 if i == 0 else 1e-4)
    assert metrics[0][0] != plain[0][0]


def test_masks_gathered_over_ranks_equal_jax_at_global_coordinates(world):
    """Each rank's keep mask at its offsets (rows 2 x its data index,
    heads 2 x its tp index of 4), gathered, equals JAX's
    ``dropout_keep_mask`` over the global batch x heads, bit for bit."""
    s = 16
    want = np.asarray(jfa.dropout_keep_mask(
        jnp.uint32(DROP_SEED), jfa.flat_bh(4, 4),
        jnp.arange(s)[:, None], jnp.arange(s)[None, :], s, 0.3))
    got = np.zeros_like(want)
    for o in world["outs"]:
        c = o["dropout"]["coords"]
        b_off, n_global, h_off = o["dropout"]["offsets"]
        assert (b_off, n_global, h_off) == (2 * c["dp"], 4, 2 * c["tp"])
        got[b_off:b_off + 2, h_off:h_off + 2] = o["dropout"]["mask"].numpy()
    assert want.shape == (4, 4, s, s)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_sharded_save_resharded_restore(world):
    """The counterpart of the reference's test: ``w [8, 4]`` saved at tp=4
    sharded along dim 1, restored at tp=2 sharded along dim 0: each rank
    holds its rows of the whole. A tag one process saved (one payload,
    every tensor whole) loads onto the ranks the same way."""
    whole = torch.arange(32.0).reshape(8, 4)
    for o in world["outs"]:
        r = o["restore"]["coords"]["tp"]
        assert torch.equal(o["restore"]["w"], whole[4 * r:4 * r + 4])
        assert torch.equal(o["restore"]["one"], whole[4 * r:4 * r + 4])


def test_fingerprint_fold_over_shards_at_chunk_edges(monkeypatch):
    """The sharded fold on one process, the tp shards folded in turn at
    their global positions and summed: equal to the whole tensor's
    fingerprint for shards along every dim, with chunks smaller than a
    row and than a shard (the position terms cross chunk and row
    edges)."""
    from neuronx_distributed_tpu_torch.resilience import integrity as ti

    monkeypatch.setattr(ti, "CHUNK", 5)
    gen = torch.Generator().manual_seed(0)
    for shape, dim, tp in (((8, 6), 1, 2), ((8, 6), 0, 4),
                           ((3, 4, 10), 2, 5), ((6, 4, 2), 1, 2)):
        x = torch.randn(shape, generator=gen)
        n = shape[dim] // tp
        pos = ti._pos_terms(8, x.device)
        total = sum(ti._shard_fold_sum(x.narrow(dim, r * n, n).contiguous(),
                                       shape, dim, r * n, pos)
                    for r in range(tp))
        got = ti._to_int32(ti._avalanche(total[None],
                                         torch.tensor([x.numel()])))
        assert int(got[0]) == int(jint.fingerprint_array_np(x.numpy())[0])
