"""Sharded checkpoints across expert-parallel layouts of the port, on four
gloo ranks on the CPU (one world, each part at its own layout): a Mixtral
train state saved at tp=2 x dp=2 x ep=2 (ZeRO-1) loads at tp=2 x dp=2 x
ep=1, merges through ``scripts/reshard_checkpoint.py`` into one rank's
tag that tp=1 x dp=4 loads, and loads back at ep=2; a tag saved at ep=1
loads at ep=2; a tag saved at tp=1 x dp=4 x ep=2, whose expert moments
ZeRO-1 shards over dp_exp=2, loads at tp=2 x dp=2 x ep=1 and at its own
layout. Each load gives the saved tensors bit for bit (parameters, both
moments, the step), each rank holding its part by its layout's specs;
after a load at the saved layout the next step equals the uninterrupted
run's bit for bit, and at another layout within 1e-5 (its sums run in
another order)."""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ep_ranks

LR = 1e-3
LOADS = [("saved", "ep1"), ("saved", "merged"), ("saved", "back"),
         ("saved_ep1", "ep2"), ("saved_dpexp", "dpexp_ep1"),
         ("saved_dpexp", "dpexp_same")]


def _batches(n, b=4, s=16, vocab=256):
    rng = np.random.RandomState(21)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, s + 1))
        labels = ids[:, 1:].copy()
        labels[:b // 2, :3] = -100
        out.append({"input_ids": torch.from_numpy(ids[:, :-1]),
                    "labels": torch.from_numpy(labels)})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = tm.tiny_moe_config(dtype=torch.float32, num_layers=1,
                             moe_dispatch="blockwise", moe_block_size=16)
    sd = tm.init_state_dict(cfg, seed=3, device="cpu")
    tmp = tmp_path_factory.mktemp("ckpt_ep")
    return run_ranks(torch_ep_ranks.checkpoint_ep_world, 4, backend="gloo",
                     device="cpu", store_dir=str(tmp),
                     args=(cfg, sd, _batches(3), str(tmp), LR), timeout=400)


_AXIS = {"tp": "tp", "dp": "dp", "ep": "ep", "dp_exp": "dp_exp"}


def _whole(outs, name):
    """Each tensor of part ``name`` made whole from the ranks' parts, each
    placed by its spec (per dim ``"tp"``, ``"dp"``, ``"ep"`` or
    ``"dp_exp"``) at its rank's coords; every rank's copy of a part checked
    equal."""
    sizes = {a: 1 + max(o[name]["coords"][a] for o in outs) for a in _AXIS}
    whole = {}
    for o in outs:
        part = o[name]
        for path, t in part["state"].items():
            spec = tuple(part["specs"].get(path) or ()) + (None,) * t.dim()
            shape, box = [], []
            for d, n in enumerate(t.shape):
                a = spec[d]
                if a in ("dp", ("dp", "cp")):
                    a = "dp"
                k = sizes[a] if a in _AXIS else 1
                i = part["coords"][a] if a in _AXIS else 0
                shape.append(n * k)
                box.append(slice(n * i, n * (i + 1)))
            if path not in whole:
                whole[path] = torch.full(shape, float("nan"),
                                         dtype=torch.float64)
            region = whole[path][tuple(box)]
            got = t.double()
            seen = ~torch.isnan(region)
            assert torch.equal(region[seen], got[seen]), (name, path)
            region.copy_(got)
    return whole


def test_ranks_import_no_jax(world):
    for o in world:
        assert o["jax_modules"] == [], o["jax_modules"]


@pytest.mark.parametrize("saved,loaded", LOADS)
def test_resharded_load_is_bit_for_bit(world, saved, loaded):
    """Every tensor of the loaded state, made whole from its layout's
    parts, equals the saved one's bit for bit: the parameters, both Adam
    moments and the step."""
    want, got = _whole(world, saved), _whole(world, loaded)
    assert set(want) == set(got)
    assert any("/mu/" in p for p in got) and any("/nu/" in p for p in got)
    for path, w in want.items():
        assert not torch.isnan(w).any(), path
        assert torch.equal(got[path], w), path
    assert {o[loaded]["step"] for o in world} == {o[saved]["step"]
                                                  for o in world} == {2}


def test_sharded_fingerprint_across_ep_layouts(world):
    """The integrity fingerprint of the whole parameters, folded from each
    rank's shards over tp and ep (``fingerprint_tree_sharded``), is the
    same on every rank, and equal wherever the same whole state is held:
    at ep=2 saved, at ep=1 loaded, at one rank's layout merged (where it
    is ``fingerprint_tree`` of the whole tensors) and back at ep=2."""
    fps = {}
    for name in ("saved", "ep1", "merged", "back", "saved_dpexp",
                 "dpexp_ep1"):
        got = {tuple(o[name]["fingerprint"].tolist()) for o in world}
        assert len(got) == 1, name
        fps[name] = got.pop()
    assert fps["saved"] == fps["ep1"] == fps["merged"] == fps["back"]
    assert fps["saved_dpexp"] == fps["dpexp_ep1"] != fps["saved"]


def test_layouts_shard_the_experts_as_saved(world):
    """At ep=2 each rank holds two of the four experts; the ZeRO-1 moments
    of an expert bank at tp=1 x dp=4 x ep=2 are sharded over dp_exp, at
    tp=2 x dp=2 x ep=2 (dp_exp=1) not at all; at ep=1 over the data
    ranks."""
    name = "layers.0.moe.experts.gate_up"
    for o in world:
        saved = o["saved"]
        assert saved["state"][f"params/{name}"].shape[0] == 2
        assert saved["specs"][f"params/{name}"][0] == "ep"
        idx = list(p for p in saved["specs"] if p.startswith("params/")
                   ).index(f"params/{name}")
        assert "dp_exp" in o["saved_dpexp"]["specs"][f"opt_state/mu/{idx}"]
        assert "dp_exp" not in saved["specs"][f"opt_state/mu/{idx}"]
        assert "dp" in o["ep1"]["specs"][f"opt_state/mu/{idx}"]
        assert o["ep1"]["state"][f"params/{name}"].shape[0] == 4


def test_next_step_after_load(world):
    """The step after loading equals the uninterrupted run's third step:
    bit for bit at the saved layout, within 1e-5 at tp=2 x dp=2 x ep=1."""
    want = world[0]["dpexp_run"]
    for o in world:
        assert o["dpexp_same"]["next"] == want
        np.testing.assert_allclose(o["dpexp_ep1"]["next"], want, rtol=1e-5)
