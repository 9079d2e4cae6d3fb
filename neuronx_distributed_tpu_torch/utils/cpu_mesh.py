"""Run a function of the port on ``world`` ranks (the counterpart of
``neuronx_distributed_tpu/utils/cpu_mesh.py``, JAX ``:23``).

The reference pins JAX to a virtual multi-device CPU mesh, one process for
every device. The port has one process per rank, so its counterpart
starts them: :func:`run_ranks` spawns ``world`` processes, joins each to a
``torch.distributed`` process group over the given backend (gloo on the
CPU; gloo with CUDA tensors where several ranks share one card, which NCCL
refuses) through a ``file://`` store in a directory of the caller's, and
returns each rank's result. A file store needs no free port, so many
worlds may start side by side (the test workers do).

Each rank is a fresh interpreter started with this process's
``sys.path``, which unpickles the function by import path: it must live in
a module that imports no JAX, and take and return only what pickles
(tensors are handed back on the CPU). The caller's main module is never
imported again, so a script needs no ``__main__`` guard for it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch


class RankError(RuntimeError):
    """A rank raised, or did not finish within the timeout."""


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _child(job: str, rank: int) -> None:
    """A rank's process: join the group, run the function, write its
    result (or the traceback) beside the job file."""
    import torch.distributed as dist

    spec = torch.load(job, weights_only=False)
    torch.set_num_threads(spec["threads"])
    result = os.path.join(os.path.dirname(job), f"result_{rank}.pt")
    try:
        device = spec["device"]
        if device is not None and device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(spec["backend"],
                                init_method=f"file://{spec['store']}",
                                rank=rank, world_size=spec["world"])
        try:
            out = ("ok", _to_cpu(spec["fn"](*spec["args"])))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which re-raises
        out = ("error", traceback.format_exc())
    torch.save(out, result + ".tmp")
    os.replace(result + ".tmp", result)


def run_ranks(fn: Callable, world: int, *, backend: str,
              device: Optional[str], store_dir: str,
              args: Sequence[Any] = (), timeout: float = 300.0,
              threads: int = 1) -> List[Any]:
    """``[fn(*args) on rank r for r in range(world)]``, each in a process
    of its own joined to a ``world``-rank group over ``backend`` (e.g.
    ``"gloo"``) through the store file ``store_dir/store``; ``store_dir``
    must exist and hold nothing else of another call. ``device``:
    ``"cpu"``, or a CUDA device every rank sets as its current one (all
    ranks on one card). Each rank is a fresh interpreter (this process's
    ``sys.path``, torch with ``threads`` intra-op threads). Raises
    :class:`RankError` with the traceback of a rank that raised or the
    end of the output of one that died, or when the ranks have not all
    returned within ``timeout`` seconds; no process outlives the call."""
    job = os.path.join(store_dir, "job.pt")
    torch.save({"fn": fn, "args": tuple(args), "world": world,
                "backend": backend, "device": device, "threads": threads,
                "store": os.path.join(store_dir, "store")}, job)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in sys.path if p and os.path.isdir(p)))
    code = ("import sys; from neuronx_distributed_tpu_torch.utils.cpu_mesh "
            "import _child; _child(sys.argv[1], int(sys.argv[2]))")
    logs = [open(os.path.join(store_dir, f"rank_{r}.log"), "w+b")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, job, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    out: List[Any] = [None] * world
    done = set()
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world:
            for r in range(world):
                path = os.path.join(store_dir, f"result_{r}.pt")
                if r in done or not os.path.exists(path):
                    continue
                status, value = torch.load(path, weights_only=False)
                if status == "error":
                    raise RankError(f"rank {r} raised:\n{value}")
                out[r] = value
                done.add(r)
            dead = [r for r, p in enumerate(procs) if r not in done
                    and p.poll() is not None and not os.path.exists(
                        os.path.join(store_dir, f"result_{r}.pt"))]
            if dead:
                r = dead[0]
                logs[r].seek(0)
                tail = logs[r].read()[-3000:].decode(errors="replace")
                raise RankError(f"rank {r} died with exit code "
                                f"{procs[r].returncode}:\n{tail}")
            if time.monotonic() > deadline:
                raise RankError(f"ranks did not finish within {timeout} s")
            time.sleep(0.05)
        for p in procs:
            p.wait(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for f in logs:
            f.close()
    return out
