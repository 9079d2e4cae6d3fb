"""Pipeline schedules as data (counterpart of
``neuronx_distributed_tpu/pipeline/schedules.py``).

A schedule is a pure function (stage, num_microbatches, num_stages) -> list
of task lists, one per clock tick, as in the reference's
``pipeline/scheduler.py`` (task dataclasses ``:4-70``, ``PipeSchedule:73``,
``InferenceSchedule:144``, ``Train1F1BSchedule:157``, ``TrainSchedule:545``
GPipe, ``TrainInterleavedSchedule:256``). It is host data with no backend,
kept here as the port's own copy: the task lists are the specification the
executors (:mod:`.spmd_engine`, :mod:`.engine_1f1b`) are held to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence


@dataclass(frozen=True)
class PipeTask:
    """One unit of pipeline work (reference task dataclasses
    ``scheduler.py:4-70``)."""

    microbatch: int


@dataclass(frozen=True)
class RecvActivation(PipeTask):
    pass


@dataclass(frozen=True)
class SendActivation(PipeTask):
    pass


@dataclass(frozen=True)
class RecvGrad(PipeTask):
    pass


@dataclass(frozen=True)
class SendGrad(PipeTask):
    pass


@dataclass(frozen=True)
class ForwardStep(PipeTask):
    # which model chunk (virtual pipeline); 0 for non-interleaved
    chunk: int = 0


@dataclass(frozen=True)
class BackwardStep(PipeTask):
    chunk: int = 0


@dataclass(frozen=True)
class ReduceGrads(PipeTask):
    pass


class PipeSchedule:
    """ABC (reference ``PipeSchedule:73``): iterate per-clock-tick task
    lists for one stage."""

    def __init__(self, num_microbatches: int, num_stages: int, stage: int):
        if not (0 <= stage < num_stages):
            raise ValueError(f"stage {stage} out of range [0, {num_stages})")
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        self.num_microbatches = num_microbatches
        self.num_stages = num_stages
        self.stage = stage

    @property
    def is_first_stage(self) -> bool:
        return self.stage == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage == self.num_stages - 1

    def steps(self) -> Iterator[List[PipeTask]]:
        raise NotImplementedError

    def tasks(self) -> List[List[PipeTask]]:
        return list(self.steps())

    @property
    def num_ticks(self) -> int:
        return len(self.tasks())


class InferenceSchedule(PipeSchedule):
    """Forward-only streaming (reference ``InferenceSchedule:144``)."""

    def steps(self):
        for mb in range(self.num_microbatches):
            tasks: List[PipeTask] = []
            if not self.is_first_stage:
                tasks.append(RecvActivation(mb))
            tasks.append(ForwardStep(mb))
            if not self.is_last_stage:
                tasks.append(SendActivation(mb))
            yield tasks


class TrainGPipeSchedule(PipeSchedule):
    """All forwards, then all backwards, then grad reduce (reference
    ``TrainSchedule:545``)."""

    def steps(self):
        for mb in range(self.num_microbatches):
            tasks: List[PipeTask] = []
            if not self.is_first_stage:
                tasks.append(RecvActivation(mb))
            tasks.append(ForwardStep(mb))
            if not self.is_last_stage:
                tasks.append(SendActivation(mb))
            yield tasks
        for mb in range(self.num_microbatches):
            tasks = []
            if not self.is_last_stage:
                tasks.append(RecvGrad(mb))
            tasks.append(BackwardStep(mb))
            if not self.is_first_stage:
                tasks.append(SendGrad(mb))
            yield tasks
        yield [ReduceGrads(self.num_microbatches - 1)]


class Train1F1BSchedule(PipeSchedule):
    """Warmup fwds, steady 1F1B, cooldown bwds (reference
    ``Train1F1BSchedule:157``). Peak live activations on stage s is
    ``num_stages - s`` instead of ``num_microbatches``."""

    def steps(self):
        s, S, M = self.stage, self.num_stages, self.num_microbatches
        warmup = min(S - s - 1, M)
        fwd = 0
        bwd = 0
        for _ in range(warmup):
            tasks: List[PipeTask] = []
            if not self.is_first_stage:
                tasks.append(RecvActivation(fwd))
            tasks.append(ForwardStep(fwd))
            if not self.is_last_stage:
                tasks.append(SendActivation(fwd))
            yield tasks
            fwd += 1
        # steady state: 1 forward + 1 backward per tick
        while fwd < M:
            tasks = []
            if not self.is_first_stage:
                tasks.append(RecvActivation(fwd))
            tasks.append(ForwardStep(fwd))
            if not self.is_last_stage:
                tasks.append(SendActivation(fwd))
                tasks.append(RecvGrad(bwd))
            tasks.append(BackwardStep(bwd))
            if not self.is_first_stage:
                tasks.append(SendGrad(bwd))
            yield tasks
            fwd += 1
            bwd += 1
        # cooldown
        while bwd < M:
            tasks = []
            if not self.is_last_stage:
                tasks.append(RecvGrad(bwd))
            tasks.append(BackwardStep(bwd))
            if not self.is_first_stage:
                tasks.append(SendGrad(bwd))
            yield tasks
            bwd += 1
        yield [ReduceGrads(M - 1)]


class TrainInterleavedSchedule(PipeSchedule):
    """Virtual-pipeline (model chunks per stage) interleaved 1F1B
    (reference ``TrainInterleavedSchedule:256``). Simplified: chunk-major
    warmup then alternating fwd/bwd across chunks."""

    def __init__(self, num_microbatches: int, num_stages: int, stage: int,
                 num_chunks: int = 2):
        super().__init__(num_microbatches, num_stages, stage)
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        self.num_chunks = num_chunks

    def steps(self):
        S, M, C = self.num_stages, self.num_microbatches, self.num_chunks
        # forward order: for each chunk, all microbatches (chunk-major,
        # matching the reference's get_model_chunk_id logic with groups of S)
        fwd_order = [(mb, c) for c in range(C) for mb in range(M)]
        bwd_order = [(mb, c) for c in reversed(range(C))
                     for mb in range(M)]
        warmup = min((S - self.stage - 1) + (C - 1) * S, len(fwd_order))
        fi = bi = 0
        for _ in range(warmup):
            mb, c = fwd_order[fi]
            yield [ForwardStep(mb, chunk=c)]
            fi += 1
        while fi < len(fwd_order):
            mb, c = fwd_order[fi]
            bmb, bc = bwd_order[bi]
            yield [ForwardStep(mb, chunk=c), BackwardStep(bmb, chunk=bc)]
            fi += 1
            bi += 1
        while bi < len(bwd_order):
            bmb, bc = bwd_order[bi]
            yield [BackwardStep(bmb, chunk=bc)]
            bi += 1
        yield [ReduceGrads(M - 1)]


def make_schedule(name: str, num_microbatches: int, num_stages: int,
                  stage: int, **kw) -> PipeSchedule:
    """Factory mirroring the reference's ``create_schedule``
    (``pipeline/model.py:690``)."""
    table = {
        "inference": InferenceSchedule,
        "gpipe": TrainGPipeSchedule,
        "1f1b": Train1F1BSchedule,
        "interleaved": TrainInterleavedSchedule,
    }
    if name not in table:
        raise ValueError(f"unknown schedule {name!r}; options {list(table)}")
    return table[name](num_microbatches, num_stages, stage, **kw)
