"""Executable cache of the port: serving replicas lease captured steps
(counterpart of ``neuronx_distributed_tpu/inference/aot_cache.py``).

The reference keeps compiled XLA executables behind a content key so that
the first replica of a program compiles and every later one loads. Eager
PyTorch compiles nothing; the port's executable is a fixed-shape serving
step captured in a ``torch.cuda.CUDAGraph`` (:class:`CapturedStep`),
together with the device buffers it reads and writes by address: its
input buffers, the KV pool and the model whose weights it reads. Capturing
a step costs a warm-up run and the capture; a revived replica, a scale-up
after a scale-down or a fresh engine of the same geometry instead *leases*
an entry that no live engine holds.

A graph writes the pool it was captured over, so two live engines cannot
share one: :meth:`AotExecutableCache.get` hands out only entries that no
one holds, and an engine returns its entries when it is freed
(:meth:`AotExecutableCache.release`). A live second replica with the same
key misses and captures its own. The cache owns its entries' buffers:
freeing the cache frees them, freeing an engine frees nothing the cache
holds.

A CUDA graph cannot be written to disk. ``put`` with a ``cache_dir``
therefore takes the reference's path for a runtime that cannot serialize
(``serialize_skips`` and an ``aot_cache_serialize_skipped`` event), and
the read path keeps the reference's file layout and checks (magic line,
environment header): a file in ``cache_dir`` is evicted with an
``aot_cache_evicted`` event and reported as a miss. The port's kernels
load warm in a fresh process from the build directory of
:mod:`..ops._build`, which is keyed by source.

On the CPU an entry holds the same buffers, with the eager step in place
of the graph, so the bookkeeping runs (and is tested) without a card. On
the card a failed capture raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

from ..obs.events import emit_event

#: disk entry layout of the reference: magic line, env-header JSON line,
#: payload
_MAGIC = b"NXDAOT1\n"
_SUFFIX = ".aotx"


def runtime_environment() -> Dict[str, str]:
    """Everything that invalidates a captured step: the torch and CUDA
    versions, the backend, the device count, the card's name and compute
    capability, and the mesh (``"none"``: the port runs one device)."""
    cuda = torch.cuda.is_available()
    env = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": "cuda" if cuda else "cpu",
        "devices": str(torch.cuda.device_count() if cuda else 1),
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "capability": (".".join(map(str, torch.cuda.get_device_capability(0)))
                       if cuda else "none"),
        "mesh": "none",
    }
    return env


def source_fingerprint(*fns: Any) -> str:
    """sha256 over the source text of ``fns`` (the reference's digest):
    objects without retrievable source fall back to ``repr``."""
    h = hashlib.sha256()
    for fn in fns:
        try:
            h.update(inspect.getsource(fn).encode())
        except (OSError, TypeError):
            h.update(repr(fn).encode())
    return h.hexdigest()


_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per card for every warm-up and capture: cuBLAS keeps
    a workspace per stream for the life of the process, so a new stream a
    capture would hold a new workspace each."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class CapturedStep:
    """One fixed-shape step over buffers that keep their addresses.

    ``fn(*inputs)`` is the step; ``inputs`` are device tensors the caller
    overwrites before each :meth:`run` (and tensors the step reads or
    writes in place, bound by address); ``holds`` keeps alive what the step
    reads by address besides them (the model, the KV pool). On CUDA the
    step is captured in a ``torch.cuda.CUDAGraph`` after one warm-up run
    on a side stream (``warm_inputs``, default ``inputs``; the warm-up
    runs the kernels once outside the capture), and :meth:`run` replays it
    into the same ``outputs``. On the CPU :meth:`run` runs ``fn`` eagerly.
    A failed capture raises."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[Any],
                 holds: Optional[Dict[str, Any]] = None,
                 warm_inputs: Optional[Sequence[Any]] = None):
        self.fn = fn
        self.inputs = tuple(inputs)
        self.holds = dict(holds or {})
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        devs = {t.device for t in self.inputs if isinstance(t, torch.Tensor)}
        if len(devs) != 1:
            raise ValueError(f"a step's inputs live on one device; got "
                             f"{sorted(map(str, devs))}")
        self.device = devs.pop()
        if self.device.type == "cuda":
            self._capture(tuple(warm_inputs) if warm_inputs is not None
                          else self.inputs)

    def _capture(self, warm_inputs) -> None:
        dev = self.device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            self.fn(*warm_inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, stream=side):
            self.outputs = self.fn(*self.inputs)
        self.graph = graph

    def run(self) -> Any:
        """Replay the graph (CUDA) or run the step (CPU) on the current
        contents of the buffers; returns ``outputs``."""
        if self.graph is not None:
            self.graph.replay()
        else:
            with torch.no_grad():
                self.outputs = self.fn(*self.inputs)
        return self.outputs


class AotWorker:
    """A serving worker backed by one executable (a :class:`CapturedStep`).

    ``_cache_size()`` reports 1, so ``compile_count()`` and the obs
    compile tracker read it as the reference's; ``from_cache`` records
    whether the engine leased it from a cache instead of capturing it.
    Kernel wrappers count launches in Python, so a replay adds to no
    kernel's count: ``replays`` counts them here."""

    def __init__(self, executable: CapturedStep, from_cache: bool):
        self.executable = executable
        self.from_cache = from_cache
        self.replays = 0

    def __call__(self) -> Any:
        out = self.executable.run()
        self.replays += 1
        return out

    def _cache_size(self) -> int:
        return 1


class AotExecutableCache:
    """Memory cache of captured steps, leased one holder at a time, with
    the reference's disk read path (which, for the port, always evicts);
    see the module docstring. Read failures degrade to a miss (evict and
    warn), never an exception."""

    def __init__(self, cache_dir: Optional[str] = None, *,
                 env: Optional[Mapping[str, str]] = None):
        self.cache_dir = cache_dir
        # injectable for version-skew tests; None = live environment
        self._env_override = dict(env) if env is not None else None
        self._mem: Dict[str, List[Any]] = {}
        self._leased: Dict[int, Any] = {}
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.serialize_skips = 0
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    # -- keys -------------------------------------------------------------

    def environment(self) -> Dict[str, str]:
        return (dict(self._env_override) if self._env_override is not None
                else runtime_environment())

    def key_for(self, *parts: Any) -> str:
        """Content key: the runtime environment plus caller parts —
        ``bytes`` parts hash raw, anything else through ``repr``."""
        h = hashlib.sha256()
        for k, v in sorted(self.environment().items()):
            h.update(f"{k}={v}\n".encode())
        for part in parts:
            h.update(b"\x00")
            h.update(part if isinstance(part, bytes) else repr(part).encode())
        return h.hexdigest()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "puts": self.puts, "evictions": self.evictions,
                "serialize_skips": self.serialize_skips,
                "mem_entries": sum(len(v) for v in self._mem.values())}

    # -- leases -----------------------------------------------------------

    def _lease(self, executable: Any) -> Any:
        self._leased[id(executable)] = executable
        return executable

    def release(self, *executables: Any) -> None:
        """Return leased entries: a later :meth:`get` may hand them out
        again. An engine calls this when it is freed."""
        for ex in executables:
            self._leased.pop(id(ex), None)

    def leased(self) -> int:
        """Entries held by a live engine now."""
        return len(self._leased)

    # -- read path --------------------------------------------------------

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, key + _SUFFIX)

    def _evict(self, key: str, why: str) -> None:
        self.evictions += 1
        try:
            os.remove(self._path(key))
        except OSError:
            pass
        emit_event("aot_cache_evicted", key=key[:16], error=why)

    def get(self, key: str, *,
            match: Optional[Callable[[Any], bool]] = None) -> Optional[Any]:
        """Lease an entry for ``key`` that no one holds (and that
        ``match`` accepts, when given), or None. A file for ``key`` in
        ``cache_dir`` is read as the reference reads it and then evicted:
        a captured graph does not load from disk."""
        for ex in self._mem.get(key, ()):
            if id(ex) not in self._leased and (match is None or match(ex)):
                self.hits += 1
                return self._lease(ex)
        if not self.cache_dir or not os.path.exists(self._path(key)):
            self.misses += 1
            return None
        try:
            with open(self._path(key), "rb") as fh:
                blob = fh.read()
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic (truncated or foreign file)")
            header_end = blob.index(b"\n", len(_MAGIC))
            header = json.loads(blob[len(_MAGIC):header_end])
            if header != self.environment():
                raise ValueError(
                    f"environment skew: entry built under {header}")
            raise ValueError("a captured CUDA graph does not load from disk")
        except Exception as e:  # any read failure degrades to a miss
            self._evict(key, f"{type(e).__name__}: {e}")
            self.misses += 1
            return None

    # -- write path -------------------------------------------------------

    def put(self, key: str, executable: Any) -> None:
        """Publish ``executable`` under ``key``, free for the next
        :meth:`get`. With a ``cache_dir`` the disk write is skipped with a
        warn event: a captured graph cannot be serialized."""
        entries = self._mem.setdefault(key, [])
        if all(ex is not executable for ex in entries):
            entries.append(executable)
        self.puts += 1
        if not self.cache_dir:
            return
        self.serialize_skips += 1
        emit_event("aot_cache_serialize_skipped", key=key[:16],
                   error="TypeError: a captured CUDA graph cannot be "
                         "serialized")

    # -- the one capture site ---------------------------------------------

    def compile_or_load(self, key: str, capture: Callable[..., Any],
                        example_args: Sequence[Any] = (), *,
                        match: Optional[Callable[[Any], bool]] = None):
        """``(executable, loaded_from_cache)`` for ``key``, leased to the
        caller. A miss calls ``capture(*example_args)`` and publishes the
        result."""
        got = self.get(key, match=match)
        if got is not None:
            return got, True
        executable = capture(*example_args)
        self.put(key, executable)
        return self._lease(executable), False
