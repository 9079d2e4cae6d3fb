"""The port's pipeline schedules (``neuronx_distributed_tpu_torch/
pipeline/schedules.py``, a copy of the JAX package's host data) against
the JAX package's: every task list of ``make_schedule`` for each schedule
over M in 1..9, S in {1, 2, 4}, each stage and C in {1, 2}, dataclass by
dataclass; the interleaved layer order and ring size of the 1F1B
executor; and the validation errors."""

import numpy as np
import pytest

from neuronx_distributed_tpu.pipeline import engine_1f1b as je1
from neuronx_distributed_tpu.pipeline import schedules as jsch
from neuronx_distributed_tpu_torch.pipeline import engine_1f1b as te1
from neuronx_distributed_tpu_torch.pipeline import schedules as tsch


def _as_tuples(tasks):
    return [[(type(t).__name__, tuple(vars(t).values())) for t in tick]
            for tick in tasks]


@pytest.mark.parametrize("name,chunks", [("inference", 1), ("gpipe", 1),
                                         ("1f1b", 1), ("interleaved", 1),
                                         ("interleaved", 2)])
def test_task_lists_equal_jax(name, chunks):
    kw = {"num_chunks": chunks} if name == "interleaved" else {}
    for S in (1, 2, 4):
        for M in range(1, 10):
            for stage in range(S):
                want = jsch.make_schedule(name, M, S, stage, **kw)
                got = tsch.make_schedule(name, M, S, stage, **kw)
                assert type(got).__name__ == type(want).__name__
                assert _as_tuples(got.tasks()) == _as_tuples(want.tasks())
                assert got.num_ticks == want.num_ticks
                assert (got.is_first_stage, got.is_last_stage) == (
                    want.is_first_stage, want.is_last_stage)


def test_task_dataclasses_equal_jax():
    """The same task types, fields, defaults and equality."""
    for cls in ("PipeTask", "RecvActivation", "SendActivation", "RecvGrad",
                "SendGrad", "ForwardStep", "BackwardStep", "ReduceGrads"):
        t, j = getattr(tsch, cls), getattr(jsch, cls)
        assert [f.name for f in t.__dataclass_fields__.values()] == [
            f.name for f in j.__dataclass_fields__.values()]
        assert t(3) == t(3) and t(3) != t(4)
    assert tsch.ForwardStep(2).chunk == jsch.ForwardStep(2).chunk == 0


@pytest.mark.parametrize("L,S,C", [(4, 2, 1), (4, 2, 2), (8, 2, 2),
                                   (8, 4, 2), (12, 2, 3), (16, 4, 1)])
def test_interleaved_layer_order_and_ring_equal_jax(L, S, C):
    np.testing.assert_array_equal(te1.interleaved_layer_order(L, S, C),
                                  je1.interleaved_layer_order(L, S, C))
    assert te1.ring_buffer_slots(S, C) == je1.ring_buffer_slots(S, C)


@pytest.mark.parametrize("args,kw", [
    (("gpipe", 4, 2, 5), {}), (("gpipe", 4, 2, -1), {}),
    (("nope", 4, 2, 0), {}), (("1f1b", 0, 2, 0), {}),
    (("interleaved", 4, 2, 0), {"num_chunks": 0}),
])
def test_validation_errors_equal_jax(args, kw):
    with pytest.raises(ValueError) as want:
        jsch.make_schedule(*args, **kw)
    with pytest.raises(ValueError) as got:
        tsch.make_schedule(*args, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        je1.interleaved_layer_order(6, 2, 2)
    with pytest.raises(ValueError) as got:
        te1.interleaved_layer_order(6, 2, 2)
    assert str(got.value) == str(want.value)


def test_slot_decoding_is_the_schedule_order():
    """The executor's clock (slot -> (microbatch, chunk)) injects the
    microbatches in groups of S, chunk by chunk: each slot once, and every
    (f, c) at ``slot_of(f, c)``."""
    for S, C, M in ((2, 1, 5), (2, 2, 4), (4, 2, 8), (2, 3, 6)):
        seen = {}
        for slot in range(M * C):
            valid, f, c = te1.slot_decode(slot, M, S, C)
            assert valid and te1.slot_of(f, c, S, C) == slot
            seen[(f, c)] = slot
        assert sorted(seen) == [(f, c) for f in range(M) for c in range(C)]
        assert not te1.slot_decode(M * C, M, S, C)[0]
        assert not te1.slot_decode(-1, M, S, C)[0]


def test_pipeline_modules_import_nothing_of_jax():
    """The pipeline package and the pipeline models import no JAX and
    nothing of the JAX package, in a fresh interpreter that refuses
    them."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'ml_dtypes', 'neuronx_distributed_tpu'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "from neuronx_distributed_tpu_torch.pipeline import ("
        "schedules, spmd_engine, engine_1f1b)\n"
        "from neuronx_distributed_tpu_torch.models import ("
        "llama_pipeline, mixtral_pipeline)\n"
        "from neuronx_distributed_tpu_torch import pipeline\n"
        "assert pipeline.make_schedule('1f1b', 4, 2, 0).num_ticks == 6\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
