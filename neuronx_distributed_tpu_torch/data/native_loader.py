"""ctypes bindings for the native C++ token-batch loader (the port's copy of
``neuronx_distributed_tpu/data/native_loader.py``).

The loader mmaps a binary token stream and prefetches shuffled
``[batch, seq+1]`` int32 batches on background C++ threads (bounded ring
buffer) — the training loop's IO runs off the Python GIL entirely. Both
packages build the one source the repository keeps for it,
``csrc/data_loader.cpp``, with ``g++`` at first use; the port builds it
into ``build/data_loader/`` at the repository root (git-ignored), named by
a hash of the source and flags, never beside the source. Without a
toolchain the loader falls back to the reference's numpy path with a
warning, as it does with ``force_python=True``; ``native`` says which runs.
The two paths draw sequences from different generators (``std::mt19937_64``
per producer thread, numpy's ``RandomState``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "csrc" / "data_loader.cpp"
BUILD_DIR = REPO / "build" / "data_loader"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_BUILD_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


class DataLoaderStallError(RuntimeError):
    """``next_batch`` produced nothing within ``stall_timeout_s`` — the
    producer threads are wedged (dead filesystem, mmap fault) rather than
    slow. The resilience watchdog treats this as a stall, not a crash."""


def library_path() -> Path:
    """Where the source builds to: keyed by the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnxd_data_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = library_path()
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            if tmp.exists():
                tmp.unlink()
    return so


def _load_native():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.nxd_loader_create.restype = ctypes.c_void_p
            lib.nxd_loader_create.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.c_int, ctypes.c_int]
            lib.nxd_loader_num_sequences.restype = ctypes.c_long
            lib.nxd_loader_num_sequences.argtypes = [ctypes.c_void_p]
            lib.nxd_loader_next.restype = ctypes.c_int
            lib.nxd_loader_next.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_int32)]
            lib.nxd_loader_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            logger.warning("native token loader unavailable (%r %s); using "
                           "the numpy path", e,
                           detail.decode(errors="replace")[-2000:])
            _LIB_FAILED = True
            _LIB = None
    return _LIB


class TokenBatchLoader:
    """Iterator of ``{"input_ids": [B,S], "labels": [B,S]}`` int32 batches
    from a flat binary token file (uint16 or uint32)."""

    def __init__(self, path: str, batch: int, seqlen: int, seed: int = 0,
                 dtype: str = "uint16", nthreads: int = 2,
                 capacity: int = 8, force_python: bool = False,
                 stall_timeout_s: Optional[float] = None):
        self.path = path
        self.batch = batch
        self.seqlen = seqlen
        self.seed = seed
        # wall-clock budget per next_batch (None = block forever); the
        # blocking produce runs on a helper thread so a wedged native ring
        # buffer surfaces as DataLoaderStallError instead of a silent hang
        self.stall_timeout_s = stall_timeout_s
        # heartbeat for external stall detection (resilience.Watchdog)
        self.last_batch_at = time.monotonic()
        self.dtype = np.dtype(dtype)
        if self.dtype.itemsize not in (2, 4):
            raise ValueError("token dtype must be uint16 or uint32")
        if nthreads < 1:
            raise ValueError("nthreads must be >= 1 (zero producer threads "
                             "would deadlock next_batch)")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._handle = None
        self._lib = None if force_python else _load_native()
        if self._lib is not None:
            self._handle = self._lib.nxd_loader_create(
                path.encode(), self.dtype.itemsize, batch, seqlen, seed,
                nthreads, capacity)
            if not self._handle:
                raise ValueError(
                    f"native loader rejected {path!r} (missing, or fewer "
                    f"than {batch} sequences of length {seqlen + 1})")
            self.num_sequences = int(
                self._lib.nxd_loader_num_sequences(self._handle))
            self.native = True
        else:
            self._tokens = np.memmap(path, dtype=self.dtype, mode="r")
            self.num_sequences = len(self._tokens) // (seqlen + 1)
            if self.num_sequences < batch:
                raise ValueError(
                    f"{path!r} has fewer than {batch} sequences of length "
                    f"{seqlen + 1}")
            self._rng = np.random.RandomState(seed)
            self.native = False

    def _produce(self) -> np.ndarray:
        n = self.batch * (self.seqlen + 1)
        if self._handle is not None:
            out = np.empty((n,), np.int32)
            rc = self._lib.nxd_loader_next(
                self._handle, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)))
            if rc != 0:
                raise RuntimeError("native loader stopped")
            return out.reshape(self.batch, self.seqlen + 1)
        idx = self._rng.randint(0, self.num_sequences, self.batch)
        per = self.seqlen + 1
        return np.stack([
            np.asarray(self._tokens[i * per:(i + 1) * per],
                       dtype=np.int32) for i in idx])

    def next_batch(self) -> dict:
        if self.stall_timeout_s is None:
            ids = self._produce()
        else:
            box = {}

            def run():
                try:
                    box["ids"] = self._produce()
                except BaseException as e:  # re-raised on the caller
                    box["err"] = e

            # daemon: a wedged producer blocked in C must not pin the
            # interpreter open after the caller gave up on it
            t = threading.Thread(target=run, daemon=True,
                                 name="nxd-loader-next")
            t.start()
            t.join(timeout=self.stall_timeout_s)
            if t.is_alive():
                raise DataLoaderStallError(
                    f"data loader produced no batch within "
                    f"{self.stall_timeout_s:.1f}s (native={self.native})")
            if "err" in box:
                raise box["err"]
            ids = box["ids"]
        self.last_batch_at = time.monotonic()
        return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.nxd_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
