"""Checkpoint storage backends (the port's copy of
``neuronx_distributed_tpu/trainer/checkpoint_storage.py``).

One abstraction over the files of a checkpoint, so that the engine
(:mod:`.checkpoint`) never touches ``os.path`` directly: the payload, the
done-markers, the ``newest`` pointer, retention listings and small JSON
metadata. :class:`FilesysCheckpointStorage` serves local and network
filesystems; :class:`ObjectStoreCheckpointStorage` serves ``s3://`` or
``gs://`` URIs through ``fsspec`` and raises at construction without it.
Transient errors of a backend are retried with backoff
(:func:`retry_with_backoff`); deterministic ones surface at once.
"""

from __future__ import annotations

import errno
import functools
import json
import logging
import os
import random
import re
import shutil
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)


# Deterministic failure modes: retrying these burns max_attempts x sleeps
# before surfacing the same bug. JSONDecodeError is a ValueError subclass.
_NON_RETRIABLE = (FileNotFoundError, PermissionError, IsADirectoryError,
                  NotADirectoryError, FileExistsError, TypeError, ValueError,
                  KeyError, AttributeError, NotImplementedError)

# Fragments marking a throttling/transient server response even when the
# fsspec backend surfaces it as a generic exception type. HTTP status codes
# match as whole words only — a bare substring ('503' inside 'shard size
# 5035') would turn a deterministic bug into 5 retries with sleeps.
_TRANSIENT_MARKERS = ("slowdown", "slow down", "throttl", "timed out",
                      "timeout", "connection reset", "connection aborted",
                      "temporarily unavailable", "too many requests",
                      "internal error")
_TRANSIENT_STATUS_RE = re.compile(r"\b(?:429|500|502|503|504)\b")

# OSError errnos that describe a deterministic local condition, not an
# environment hiccup: no amount of backoff frees the disk or remounts the
# filesystem writable.
_DETERMINISTIC_ERRNOS = frozenset(
    getattr(errno, name) for name in
    ("ENOSPC", "EDQUOT", "EROFS", "ENAMETOOLONG", "EISDIR", "ENOTDIR")
    if hasattr(errno, name))


def _is_transient(e: Exception) -> bool:
    if isinstance(e, _NON_RETRIABLE):
        return False
    if isinstance(e, OSError) and e.errno in _DETERMINISTIC_ERRNOS:
        # disk full / quota / read-only fs: retrying with backoff burns
        # minutes before surfacing the same condition (advisor r3)
        return False
    if isinstance(e, (ConnectionError, TimeoutError, OSError)):
        # network errors plus remaining OSErrors (EIO, ENETDOWN, stale NFS
        # handles, ...) are environment hiccups worth retrying
        return True
    msg = str(e).lower()
    return (any(m in msg for m in _TRANSIENT_MARKERS)
            or _TRANSIENT_STATUS_RE.search(msg) is not None)


def retry_with_backoff(max_attempts: int = 5, base_delay: float = 0.5,
                       max_delay: float = 8.0):
    """Retry transient storage errors with exponential backoff and
    *decrementing* jitter (reference ``checkpoint_storage.py:236-286``:
    tenacity retry tuned for S3 503 slow-down — early attempts spread out
    randomly, later attempts converge to the full deterministic delay).
Only errors classified transient by :func:`_is_transient` are retried;
    deterministic bugs (TypeError, JSON decode errors, missing files)
    surface immediately (reference retries only classified slow-down
    errors, ``checkpoint_storage.py:250``).
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last = None
            for attempt in range(max_attempts):
                try:
                    return fn(*args, **kwargs)
                except Exception as e:
                    if not _is_transient(e):
                        raise  # deterministic, not transient
                    last = e
                    if attempt == max_attempts - 1:
                        break
                    delay = min(base_delay * 2 ** attempt, max_delay)
                    # decrementing jitter: subtract up to (remaining
                    # fraction) of the delay, so retries decorrelate early
                    # and back off fully late
                    frac = 1.0 - attempt / max(max_attempts - 1, 1)
                    delay -= random.uniform(0, delay * 0.5 * frac)
                    logger.warning(
                        "storage op %s failed (%r), retry %d/%d in %.2fs",
                        fn.__name__, e, attempt + 1, max_attempts - 1,
                        delay)
                    time.sleep(delay)
            raise last
        return wrapper
    return deco


class BaseCheckpointStorage(ABC):
    """Reference: ``BaseCheckpointStorage`` (``checkpoint_storage.py:46``)."""

    def __init__(self, dirname: str):
        self._dirname = dirname

    def dirname(self) -> str:
        return self._dirname

    @abstractmethod
    def dir_exists(self, dirname: str) -> bool: ...

    @abstractmethod
    def file_exists(self, filename: str) -> bool: ...

    @abstractmethod
    def create_dir(self, dirname: str) -> None: ...

    @abstractmethod
    def list_dirs(self, dirname: str) -> List[str]: ...

    @abstractmethod
    def remove_dir(self, dirname: str) -> None: ...

    @abstractmethod
    def remove_file(self, filename: str) -> None: ...

    @abstractmethod
    def save_text(self, text: str, filename: str) -> None: ...

    @abstractmethod
    def load_text(self, filename: str) -> str: ...

    def save_object(self, obj: Any, filename: str) -> None:
        self.save_text(json.dumps(obj), filename)

    def load_object(self, filename: str) -> Any:
        return json.loads(self.load_text(filename))

    def list_files(self, dirname: str) -> Optional[List[Tuple[str, int]]]:
        """``(relative_path, size_bytes)`` for every file under ``dirname``
        (recursive, '/'-separated relpaths), or ``None`` when the backend
        cannot enumerate — callers (manifest verification) must then skip
        verification rather than fail."""
        return None

    def file_size(self, filename: str) -> Optional[int]:
        """Size in bytes, or ``None`` when missing/unsupported."""
        return None

    def read_bytes(self, filename: str) -> Optional[bytes]:
        """Raw file contents, or ``None`` when missing/unsupported.
        Manifest content digests (verified resume) hash through this;
        backends returning ``None`` degrade to inventory+size checks."""
        return None

    def save_bytes(self, data: bytes, filename: str) -> None:
        """Write ``data`` to ``filename`` (the payload, on backends that
        the engine does not write through a local path)."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot write raw bytes")


class FilesysCheckpointStorage(BaseCheckpointStorage):
    """Local/NFS filesystem backend (reference
    ``FilesysCheckpointStorage:138``)."""

    def dir_exists(self, dirname: str) -> bool:
        return os.path.isdir(dirname)

    def file_exists(self, filename: str) -> bool:
        return os.path.isfile(filename)

    def create_dir(self, dirname: str) -> None:
        os.makedirs(dirname, exist_ok=True)

    def list_dirs(self, dirname: str) -> List[str]:
        if not os.path.isdir(dirname):
            return []
        return [d for d in os.listdir(dirname)
                if os.path.isdir(os.path.join(dirname, d))]

    def remove_dir(self, dirname: str) -> None:
        shutil.rmtree(dirname, ignore_errors=True)

    def remove_file(self, filename: str) -> None:
        try:
            os.remove(filename)
        except FileNotFoundError:
            pass

    def save_text(self, text: str, filename: str) -> None:
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        # one temporary per writer: two commit threads publish ``newest``
        # at once, and a shared temporary name let one move the other's
        tmp = f"{filename}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, filename)  # atomic publish

    def load_text(self, filename: str) -> str:
        with open(filename) as f:
            return f.read()

    def list_files(self, dirname: str) -> Optional[List[Tuple[str, int]]]:
        if not os.path.isdir(dirname):
            return []
        out: List[Tuple[str, int]] = []
        for root, dirs, files in os.walk(dirname):
            dirs.sort()
            for f in sorted(files):
                full = os.path.join(root, f)
                rel = os.path.relpath(full, dirname).replace(os.sep, "/")
                try:
                    out.append((rel, os.path.getsize(full)))
                except OSError:
                    # racing deletion (retention): report what remains
                    pass
        return out

    def file_size(self, filename: str) -> Optional[int]:
        try:
            return os.path.getsize(filename)
        except OSError:
            return None

    def read_bytes(self, filename: str) -> Optional[bytes]:
        try:
            with open(filename, "rb") as f:
                return f.read()
        except OSError:
            return None


class ObjectStoreCheckpointStorage(BaseCheckpointStorage):
    """Cloud object-store backend (reference ``S3CheckpointStorage:287``).

    Requires ``fsspec`` with the matching protocol, for the payload and the
    control-plane files alike. Instantiating without it raises immediately
    (no silent fallback), mirroring the reference's explicit boto3
    dependency.
    """

    def __init__(self, dirname: str):
        super().__init__(dirname)
        try:
            import fsspec  # noqa: F401

            self._fs = fsspec.filesystem(dirname.split("://", 1)[0])
        except Exception as e:  # pragma: no cover - env without fsspec
            raise ImportError(
                f"object-store checkpoint dir {dirname!r} requires fsspec "
                f"with the matching backend: {e}") from e

    @retry_with_backoff()
    def dir_exists(self, dirname: str) -> bool:
        return self._fs.isdir(dirname)

    @retry_with_backoff()
    def file_exists(self, filename: str) -> bool:
        return self._fs.isfile(filename)

    @retry_with_backoff()
    def create_dir(self, dirname: str) -> None:
        self._fs.makedirs(dirname, exist_ok=True)

    @retry_with_backoff()
    def list_dirs(self, dirname: str) -> List[str]:
        if not self._fs.isdir(dirname):
            return []
        # names only: some fsspec backends list details by default
        return [os.path.basename(p.rstrip("/"))
                for p in self._fs.ls(dirname, detail=False)
                if self._fs.isdir(p)]

    @retry_with_backoff()
    def remove_dir(self, dirname: str) -> None:
        # a retry after a partially-completed delete legitimately finds
        # nothing left — that is success, not an error
        try:
            self._fs.rm(dirname, recursive=True)
        except FileNotFoundError:
            pass

    @retry_with_backoff()
    def remove_file(self, filename: str) -> None:
        # try/except rather than isfile-then-rm: fsspec dircaches can
        # report a stale False and silently skip the delete
        try:
            self._fs.rm(filename)
        except FileNotFoundError:
            pass

    @retry_with_backoff()
    def save_text(self, text: str, filename: str) -> None:
        with self._fs.open(filename, "w") as f:
            f.write(text)

    @retry_with_backoff()
    def load_text(self, filename: str) -> str:
        with self._fs.open(filename, "r") as f:
            return f.read()

    @retry_with_backoff()
    def list_files(self, dirname: str) -> Optional[List[Tuple[str, int]]]:
        if not self._fs.isdir(dirname):
            return []
        base = dirname.rstrip("/")
        out: List[Tuple[str, int]] = []
        for path, info in sorted(self._fs.find(base, detail=True).items()):
            if info.get("type") == "directory":
                continue
            rel = path[len(base):].lstrip("/") if path.startswith(base) \
                else os.path.basename(path)
            out.append((rel, int(info.get("size", 0))))
        return out

    @retry_with_backoff()
    def file_size(self, filename: str) -> Optional[int]:
        try:
            return int(self._fs.size(filename))
        except FileNotFoundError:
            return None

    @retry_with_backoff()
    def read_bytes(self, filename: str) -> Optional[bytes]:
        try:
            with self._fs.open(filename, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    @retry_with_backoff()
    def save_bytes(self, data: bytes, filename: str) -> None:
        with self._fs.open(filename, "wb") as f:
            f.write(data)


# Process-wide storage wrapper hook: a fault-injection harness (the
# reference's resilience chaos harness, a later slice here) or any
# instrumentation layer interposes on EVERY storage the checkpoint engine
# creates — including the ones async commit threads construct — without
# threading a parameter through save/load call sites.
_STORAGE_WRAPPER: Optional[
    Callable[[BaseCheckpointStorage], BaseCheckpointStorage]] = None


def install_storage_wrapper(
        wrapper: Callable[[BaseCheckpointStorage],
                          BaseCheckpointStorage]) -> None:
    """Wrap every storage subsequently built by
    :func:`create_checkpoint_storage`."""
    global _STORAGE_WRAPPER
    _STORAGE_WRAPPER = wrapper


def clear_storage_wrapper() -> None:
    global _STORAGE_WRAPPER
    _STORAGE_WRAPPER = None


def create_checkpoint_storage(dirname: str) -> BaseCheckpointStorage:
    """Factory (reference ``create_checkpoint_storage:611``)."""
    if dirname.startswith("file://"):
        storage: BaseCheckpointStorage = FilesysCheckpointStorage(
            dirname[len("file://"):])
    elif "://" in dirname:
        storage = ObjectStoreCheckpointStorage(dirname)
    else:
        storage = FilesysCheckpointStorage(dirname)
    if _STORAGE_WRAPPER is not None:
        storage = _STORAGE_WRAPPER(storage)
    return storage
