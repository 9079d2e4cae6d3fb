"""Checkpoint engine: async save and verified load with the reference's
commit protocol (counterpart of ``neuronx_distributed_tpu/trainer/
checkpoint.py``).

The protocol is the reference's, file for file:

* ``path/<tag>/`` holds the payload under ``state/``, the optional
  ``user_content.json``, ``manifest.json`` (:mod:`..resilience.manifest`)
  and the ``checkpoint`` done-marker, written only after the payload and
  the manifest;
* ``path/newest`` names the last committed tag, a hint only: ``tag=None``
  or ``"-1"`` loads the newest *complete* tag that verifies, falling back
  to the prior one, while an explicit tag that fails verification raises
  :class:`CheckpointCorruptionError`;
* ``num_kept`` complete tags survive retention, under one process-wide
  lock;
* an overwrite of a tag drops its stale done-marker and manifest first;
* async saves commit on a background thread; :func:`finalize_checkpoint`
  (also run at exit) joins them and raises a commit's error.

The payload is the port's own: ``state/state.pt``, one ``torch.save`` of
the state's tensors by name in a tree of dicts and lists (dataclasses
become dicts, :func:`state_to_tree`), loaded with ``weights_only=True``.
It cannot read the reference's Orbax payload; weights cross from JAX by
:func:`..models.convert.params_from_jax`.

The port's train step updates parameters and moments in place, where JAX
arrays are immutable. So :func:`save_checkpoint` first copies every tensor
to host memory and returns only when the copies are complete (as Orbax's
``save`` returns after its device-to-host copy): the next step cannot
reach into a checkpoint being written.
"""

from __future__ import annotations

import atexit
import dataclasses
import io
import logging
import os
import tempfile
import threading
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..resilience import manifest as _manifest
from .checkpoint_storage import (BaseCheckpointStorage,
                                 FilesysCheckpointStorage,
                                 create_checkpoint_storage)

logger = logging.getLogger(__name__)

DONE_FILE = "checkpoint"  # reference: done-marker file name
NEWEST_FILE = "newest"
STATE_DIR = "state"
PAYLOAD_FILE = "state.pt"
USER_CONTENT_FILE = "user_content.json"
MANIFEST_FILE = _manifest.MANIFEST_FILE


class CheckpointSaveError(RuntimeError):
    """An async checkpoint commit failed (raised at the next
    save/finalize/wait, never swallowed)."""


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint with a done-marker failed manifest verification (or
    restore), and no fallback was possible: explicit-tag loads never fall
    back silently, and auto-resume raises this only after every complete
    tag was tried."""


class CheckpointIOState:
    """Tracks in-flight async saves (reference ``CheckpointIOState:110``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: List[Tuple[str, threading.Thread]] = []
        self._errors: List[Tuple[str, BaseException]] = []

    def add(self, tag: str, thread: threading.Thread) -> None:
        with self._lock:
            self._pending.append((tag, thread))

    def record_error(self, tag: str, exc: BaseException) -> None:
        with self._lock:
            self._errors.append((tag, exc))

    def raise_pending_errors(self) -> None:
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            tags = ", ".join(t for t, _ in errors)
            raise CheckpointSaveError(
                f"async checkpoint commit failed for tag(s) {tags}: "
                f"{errors[0][1]!r}") from errors[0][1]

    def wait_all(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for _, t in pending:
            t.join()
        self.raise_pending_errors()

    def wait_tag(self, tag: str) -> None:
        """Join in-flight saves of one tag (an overwrite must not race the
        previous commit thread re-writing the done-marker)."""
        with self._lock:
            pending = [p for p in self._pending if p[0] == tag]
            self._pending = [p for p in self._pending if p[0] != tag]
        for _, t in pending:
            t.join()


_IO_STATE = CheckpointIOState()
atexit.register(_IO_STATE.wait_all)


# ---------------------------------------------------------------------------
# the state as a tree of tensors
# ---------------------------------------------------------------------------

def state_to_tree(obj: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``obj`` (dataclasses, dicts, lists and tuples of tensors and
    scalars) as plain dicts and lists, each tensor replaced by ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: state_to_tree(getattr(obj, f.name), fn)
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): state_to_tree(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [state_to_tree(v, fn) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _is_leaf(v: Any) -> bool:
    return not (isinstance(v, (torch.Tensor, dict, list, tuple))
                or (dataclasses.is_dataclass(v) and not isinstance(v, type)))


@torch.no_grad()
def load_tree_(target: Any, tree: Any, where: str = "state") -> Any:
    """Copy ``tree`` (as :func:`state_to_tree` made it) into ``target`` in
    place: every tensor by ``copy_`` (same shape and dtype, on the
    target's device), every scalar field by assignment. The target's
    tensors stay the same objects, so a model whose parameters they are
    sees the loaded values. Returns ``target``."""
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, found "
                             f"{type(tree).__name__}")
        if tree.shape != target.shape or tree.dtype != target.dtype:
            raise ValueError(f"{where}: {tuple(tree.shape)} {tree.dtype} "
                             f"cannot load into {tuple(target.shape)} "
                             f"{target.dtype}")
        target.copy_(tree)
        return target
    if dataclasses.is_dataclass(target):
        keys = [f.name for f in dataclasses.fields(target)]
        get, put = target.__getattribute__, target.__setattr__
    elif isinstance(target, (dict, list)):
        keys = list(target) if isinstance(target, dict) else list(
            range(len(target)))
        get, put = target.__getitem__, target.__setitem__
    else:
        raise TypeError(f"{where}: cannot load into a "
                        f"{type(target).__name__}")
    want = [str(k) for k in keys] if isinstance(tree, dict) else keys
    have = list(tree) if isinstance(tree, dict) else list(range(len(tree)))
    if sorted(map(str, have)) != sorted(map(str, want)):
        raise ValueError(f"{where}: the checkpoint holds {have}, the target "
                         f"{want}")
    for k, w in zip(keys, want):
        if _is_leaf(get(k)):
            put(k, tree[w])
        else:
            load_tree_(get(k), tree[w], f"{where}.{w}")
    return target


# ---------------------------------------------------------------------------
# tags
# ---------------------------------------------------------------------------

def _normalize_path(path: str) -> str:
    if path.startswith("file://"):
        return path[len("file://"):]
    return path


def _tag_dir(base: str, tag: str) -> str:
    if "://" in base:
        return base.rstrip("/") + "/" + str(tag)
    return os.path.join(base, str(tag))


def _payload_path(tdir: str) -> str:
    if "://" in tdir:
        return tdir.rstrip("/") + f"/{STATE_DIR}/{PAYLOAD_FILE}"
    return os.path.join(tdir, STATE_DIR, PAYLOAD_FILE)


def _is_complete(storage: BaseCheckpointStorage, base: str, tag: str) -> bool:
    return storage.file_exists(os.path.join(_tag_dir(base, tag), DONE_FILE))


def _complete_tags(storage: BaseCheckpointStorage, base: str) -> List[str]:
    tags = [t for t in storage.list_dirs(base)
            if _is_complete(storage, base, t)]

    def sort_key(t: str):
        try:
            return (0, int(t))
        except ValueError:
            return (1, t)

    return sorted(tags, key=sort_key)


def has_checkpoint(path: str, tag: Optional[str] = None) -> bool:
    """Whether ``path`` holds a complete checkpoint (of ``tag``, if
    given)."""
    path = _normalize_path(path)
    storage = create_checkpoint_storage(path)
    if tag is not None and tag != "-1":
        return _is_complete(storage, path, str(tag))
    return len(_complete_tags(storage, path)) > 0


def list_complete_tags(path: str) -> List[str]:
    """All complete (done-marker carrying) tags under ``path``, oldest
    first, numeric tags before lexical ones."""
    path = _normalize_path(path)
    return _complete_tags(create_checkpoint_storage(path), path)


def verify_checkpoint(path: str, tag: Any) -> Tuple[bool, str]:
    """``(ok, detail)`` manifest verification of one complete tag (content
    digests where recorded). Does not restore."""
    path = _normalize_path(path)
    return _verify_tag(create_checkpoint_storage(path), path, str(tag))


def user_content(path: str, tag: Any) -> Optional[dict]:
    """The ``user_content`` saved with ``tag``, or None."""
    path = _normalize_path(path)
    storage = create_checkpoint_storage(path)
    uc = os.path.join(_tag_dir(path, str(tag)), USER_CONTENT_FILE)
    return storage.load_object(uc) if storage.file_exists(uc) else None


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _write_payload(storage: BaseCheckpointStorage, tdir: str,
                   tree: Any) -> None:
    target = _payload_path(tdir)
    if isinstance(storage, FilesysCheckpointStorage):
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, target)
        return
    buf = io.BytesIO()
    torch.save(tree, buf)
    storage.save_bytes(buf.getvalue(), target)


def save_checkpoint(
    path: str,
    tag: Any,
    state: Any,
    user_content: Optional[dict] = None,
    async_save: bool = True,
    num_kept: int = -1,
) -> None:
    """Save ``state`` (a ``TrainState``, or any dataclass, dict or list of
    tensors and scalars) under ``path/tag``.

    Returns once every tensor has been copied to host memory; with
    ``async_save`` the payload, the manifest and the done-marker are
    written on a background thread and training goes on."""
    tag = str(tag)
    path = _normalize_path(path)
    _IO_STATE.raise_pending_errors()
    storage = create_checkpoint_storage(path)
    tdir = _tag_dir(path, tag)
    storage.create_dir(tdir)

    # done-marker implies a durable payload: an overwrite drops the stale
    # marker and manifest before the payload is touched, after joining an
    # in-flight save of the same tag
    _IO_STATE.wait_tag(tag)
    storage.remove_file(os.path.join(tdir, DONE_FILE))
    storage.remove_file(os.path.join(tdir, MANIFEST_FILE))
    state_dir = os.path.dirname(_payload_path(tdir))
    if storage.dir_exists(state_dir):
        storage.remove_dir(state_dir)

    # the snapshot: a blocking copy to host memory, so the next step's
    # in-place update cannot reach the values being written
    tree = state_to_tree(state, lambda t: t.detach().to("cpu", copy=True))
    if user_content is not None:
        storage.save_object(user_content, os.path.join(tdir,
                                                       USER_CONTENT_FILE))

    def commit():
        _write_payload(storage, tdir, tree)
        # manifest after the payload is durable, before the done-marker:
        # a complete tag always carries its inventory
        man = _manifest.build_manifest(storage, tdir, tag)
        if man is not None:
            storage.save_object(man, os.path.join(tdir, MANIFEST_FILE))
        storage.save_text("done", os.path.join(tdir, DONE_FILE))
        storage.save_text(tag, os.path.join(path, NEWEST_FILE))
        if num_kept > 0:
            _apply_retention(storage, path, num_kept)
        logger.info("checkpoint %s committed", tdir)

    def commit_async():
        try:
            commit()
        except BaseException as e:  # re-raised at next save/finalize
            logger.exception("async commit of checkpoint %s failed", tdir)
            _IO_STATE.record_error(tag, e)

    if async_save:
        t = threading.Thread(target=commit_async, daemon=False,
                             name=f"ckpt-commit-{tag}")
        t.start()
        _IO_STATE.add(tag, t)
    else:
        commit()


# Retention runs on async commit threads: two overlapping saves that both
# carry num_kept would otherwise list/remove concurrently.
_RETENTION_LOCK = threading.Lock()


def _apply_retention(storage: BaseCheckpointStorage, path: str,
                     num_kept: int) -> None:
    """Keep the newest ``num_kept`` complete tags (reference
    ``_determine_remove_tags:66``), one commit thread at a time."""
    with _RETENTION_LOCK:
        tags = _complete_tags(storage, path)
        for t in tags[:-num_kept] if num_kept > 0 else []:
            logger.info("retention: removing checkpoint %s", t)
            storage.remove_dir(_tag_dir(path, t))


def finalize_checkpoint() -> None:
    """Block until all async saves are committed; raise a failed commit's
    error."""
    _IO_STATE.wait_all()


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _verify_tag(storage: BaseCheckpointStorage, path: str,
                tag: str) -> Tuple[bool, str]:
    tdir = _tag_dir(path, tag)
    return _manifest.verify_manifest(storage, tdir,
                                     os.path.join(tdir, MANIFEST_FILE))


def _read_payload(storage: BaseCheckpointStorage, tdir: str,
                  map_location: torch.device) -> Any:
    source = _payload_path(tdir)
    if isinstance(storage, FilesysCheckpointStorage):
        return torch.load(source, map_location=map_location,
                          weights_only=True, mmap=True)
    with tempfile.TemporaryFile() as f:
        f.write(storage.read_bytes(source))
        f.seek(0)
        return torch.load(f, map_location=map_location, weights_only=True)


def _restore_tag(storage: BaseCheckpointStorage, path: str, tag: str,
                 target: Optional[Any], device: torch.device
                 ) -> Tuple[Any, Optional[dict]]:
    tdir = _tag_dir(path, tag)
    state = _read_payload(storage, tdir, device)
    if target is not None:
        state = load_tree_(target, state)
    uc = os.path.join(tdir, USER_CONTENT_FILE)
    content = storage.load_object(uc) if storage.file_exists(uc) else None
    return state, content


def load_checkpoint(
    path: str,
    tag: Optional[Any] = None,
    target: Optional[Any] = None,
    verify: bool = True,
    device: DeviceLike = None,
) -> Tuple[Any, Optional[dict]]:
    """Load ``(state, user_content)``.

    ``tag=None`` / ``"-1"`` resumes from the newest complete checkpoint
    that verifies, falling back to the prior complete tag with a logged
    warning; an explicit tag that fails verification raises
    :class:`CheckpointCorruptionError`. With ``target`` (e.g. the live
    ``TrainState``) the values are copied into its tensors in place and
    ``target`` is returned; without, the saved tree of dicts and lists is
    returned with its tensors on ``device`` (None: the CUDA card)."""
    path = _normalize_path(path)
    storage = create_checkpoint_storage(path)
    # with a target the payload is staged on the host and copied into the
    # target's own tensors
    device = (torch.device("cpu") if target is not None
              else resolve_device(device))
    if tag is None or str(tag) == "-1":
        tags = _complete_tags(storage, path)
        if not tags:
            raise FileNotFoundError(f"no complete checkpoint under {path}")
        skipped = []
        for t in reversed(tags):
            if verify:
                ok, why = _verify_tag(storage, path, t)
                if not ok:
                    logger.warning(
                        "checkpoint %s/%s failed verification (%s); "
                        "falling back to the prior complete tag", path, t,
                        why)
                    skipped.append((t, why))
                    continue
            try:
                return _restore_tag(storage, path, t, target, device)
            except Exception as e:
                logger.warning(
                    "checkpoint %s/%s failed to restore (%r); falling back "
                    "to the prior complete tag", path, t, e)
                skipped.append((t, repr(e)))
        raise CheckpointCorruptionError(
            f"no intact checkpoint under {path}; skipped: "
            + "; ".join(f"{t}: {why}" for t, why in skipped))
    tag = str(tag)
    if not _is_complete(storage, path, tag):
        raise FileNotFoundError(
            f"checkpoint {path}/{tag} missing or incomplete (no done-marker)")
    if verify:
        ok, why = _verify_tag(storage, path, tag)
        if not ok:
            raise CheckpointCorruptionError(
                f"checkpoint {path}/{tag} is corrupt: {why}")
    return _restore_tag(storage, path, tag, target, device)
