"""Pipeline parallelism (counterpart of ``neuronx_distributed_tpu/pipeline``):
the schedules as data, the GPipe executor (:mod:`.spmd_engine`) and the
1F1B / interleaved one (:mod:`.engine_1f1b`), over ``torch.distributed``
ranks."""

from . import engine_1f1b
from . import schedules
from . import spmd_engine
from .schedules import make_schedule
from .spmd_engine import microbatch, pipeline_spmd

__all__ = ["engine_1f1b", "schedules", "spmd_engine", "make_schedule",
           "microbatch", "pipeline_spmd"]
