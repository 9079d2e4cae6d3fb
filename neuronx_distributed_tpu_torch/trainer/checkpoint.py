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

The payload is the port's own: ``torch.save`` files of the state's
tensors by path (dataclasses become dicts, :func:`state_to_tree`), loaded
with ``weights_only=True``. It cannot read the reference's Orbax payload;
weights cross from JAX by :func:`..models.convert.params_from_jax`.

Each tensor of the state has a partition spec, per dim None, ``"tp"``,
``"dp"`` (the data axes of ZeRO-1), or for an expert bank at ep > 1
``"ep"`` and ``"dp_exp"`` (the expert view splits the merged data index
``d`` as ``d = dp_exp_rank * ep + ep_rank``): ``TrainState.shard_specs``, or
``specs`` for another tree. Each rank writes the parts it alone holds to
``state/shard_tp<t>_dp<d>.pt``, keyed by its mesh coordinates: a tensor
the data ranks replicate is written by data rank 0, one the tp ranks
replicate by tp rank 0, and each ZeRO-1 slice of the moments by its own
rank (one rank writes everything to ``shard_tp0_dp0.pt``). Each rank
digests its file and leaves ``ranks/<rank>.json``; rank 0 waits for every
rank's (files, not a collective, so its commit thread never meets the
training loop's collectives) and writes the one SHA-256 manifest over
every file, with the shard table (each tensor's global shape, dtype, spec
and the boxes each file holds) and the state's scalars, then the
done-marker and ``newest``. Loading assembles each rank's part from the
boxes that cover it (``torch.load(mmap=True, weights_only=True)``), so a
tag loads onto another layout: another tp or dp, with or without ZeRO-1,
or one rank, as the reference's Orbax restore reshards. A tag written
before the shard table (one ``state/state.pt`` of the whole tree) still
loads, as a table of whole tensors. Across ranks verification is shared
out over the ranks and agreed (:func:`..parallel.mesh.agree`): a corrupt
rank file fails the whole tag on every rank, and auto-resume falls back
to the prior tag on every rank together. Saving and loading are
collective across ranks: every rank calls them at the same point, from
the training thread.

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
import json
import logging
import math
import os
import tempfile
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import torch

from ..device import DeviceLike, resolve_device
from ..parallel import mesh as ps
from ..resilience import manifest as _manifest
from .checkpoint_storage import (BaseCheckpointStorage,
                                 FilesysCheckpointStorage,
                                 create_checkpoint_storage)

logger = logging.getLogger(__name__)

DONE_FILE = "checkpoint"  # reference: done-marker file name
NEWEST_FILE = "newest"
STATE_DIR = "state"
#: the one payload of a tag written before the shard table (read only)
PAYLOAD_FILE = "state.pt"
USER_CONTENT_FILE = "user_content.json"
MANIFEST_FILE = _manifest.MANIFEST_FILE
RANKS_DIR = "ranks"
#: seconds rank 0's commit waits for every rank's file of a tag
RANK_WAIT_S = 3600.0

Spec = Tuple[Optional[str], ...]


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

def _fields(obj: Any) -> List[dataclasses.Field]:
    """A dataclass's saved fields: all but those marked
    ``metadata={"checkpoint": False}`` (``TrainState.shard_specs``)."""
    return [f for f in dataclasses.fields(obj)
            if f.metadata.get("checkpoint", True)]


def state_to_tree(obj: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``obj`` (dataclasses, dicts, lists and tuples of tensors and
    scalars) as plain dicts and lists, each tensor replaced by ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: state_to_tree(getattr(obj, f.name), fn)
                for f in _fields(obj)}
    if isinstance(obj, dict):
        return {str(k): state_to_tree(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [state_to_tree(v, fn) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def tree_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor of a tree of dicts and lists (as
    :func:`state_to_tree` makes it), the path its keys and list indices
    joined by ``/``."""
    if isinstance(tree, torch.Tensor):
        yield "/".join(prefix), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, prefix + (str(i),))


def _skeleton(tree: Any, prefix: Tuple[str, ...] = ()) -> Any:
    """``tree`` with each tensor replaced by ``{"tensor": path}``: the
    scalars and the shape of the state, as JSON."""
    if isinstance(tree, torch.Tensor):
        return {"tensor": "/".join(prefix)}
    if isinstance(tree, dict):
        return {"dict": {str(k): _skeleton(v, prefix + (str(k),))
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_skeleton(v, prefix + (str(i),))
                         for i, v in enumerate(tree)]}
    return {"value": tree}


def _unskeleton(sk: Any, tensors: Mapping[str, torch.Tensor]) -> Any:
    """The tree :func:`_skeleton` describes, its tensors from ``tensors``
    by path."""
    if "tensor" in sk:
        return tensors[sk["tensor"]]
    if "dict" in sk:
        return {k: _unskeleton(v, tensors) for k, v in sk["dict"].items()}
    if "list" in sk:
        return [_unskeleton(v, tensors) for v in sk["list"]]
    return sk["value"]


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
        if tree is not target:
            target.copy_(tree)
        return target
    if dataclasses.is_dataclass(target):
        keys = [f.name for f in _fields(target)]
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
# layouts: which part of each tensor a rank holds
# ---------------------------------------------------------------------------

def _layout() -> Dict[str, int]:
    """This process's tp, data (dp x cp) and pp sizes and indices; one rank
    of each without a parallel layout."""
    if not ps.model_parallel_is_initialized():
        return dict(tp=1, tp_rank=0, dp=1, dp_rank=0, pp=1, pp_rank=0, ep=1)
    return dict(tp=ps.axis_size(ps.TP_AXIS), tp_rank=ps.axis_rank(ps.TP_AXIS),
                dp=ps.axis_size(ps.DATA_AXES),
                dp_rank=ps.axis_rank(ps.DATA_AXES),
                pp=ps.axis_size(ps.PP_AXIS),
                pp_rank=ps.axis_rank(ps.PP_AXIS),
                ep=ps.axis_size(ps.EP_AXIS))


def _across_ranks() -> bool:
    return ps.model_parallel_is_initialized() and ps.get_world_size() > 1


def _rank_world() -> Tuple[int, int]:
    """This rank's index among the ranks that write a tag, and their
    count: ``(0, 1)`` outside a parallel layout of more than one rank."""
    if not _across_ranks():
        return 0, 1
    return ps.world_rank(), ps.world_size()


def _norm_spec(spec: Any, ndim: int) -> Spec:
    """A spec as per-dim None, ``"tp"``, ``"dp"`` (the data axes, named
    ``"dp"``, ``("dp", "cp")`` or ``"data"``), ``"ep"``, ``"dp_exp"`` or
    ``"pptp"`` (the merged ``(pp, tp)`` axes of a pipeline's ``vocab_pp``
    table)."""
    out = []
    for a in tuple(spec or ())[:ndim]:
        if a in (None, "tp", "pptp", "ep", "dp_exp"):
            out.append(a)
        elif a in ("dp", "data", ps.DATA_AXES):
            out.append("dp")
        elif a in (ps.PP_TP_AXES, list(ps.PP_TP_AXES)):
            out.append("pptp")
        else:
            raise ValueError(f"spec entry {a!r}: the checkpoint shards over "
                             "tp, (pp, tp), ep and the data axes only")
    return tuple(out) + (None,) * (ndim - len(out))


def _parts(a: Optional[str], lay: Mapping[str, int]) -> Tuple[int, int]:
    """``(parts, index)`` of the rank at ``lay`` along a spec entry."""
    if a == "tp":
        return lay["tp"], lay["tp_rank"]
    if a == "dp":
        return lay["dp"], lay["dp_rank"]
    ep = lay.get("ep", 1)
    if a == "ep":
        return ep, lay["dp_rank"] % ep
    if a == "dp_exp":
        return lay["dp"] // ep, lay["dp_rank"] // ep
    if a == "pptp":
        return (lay["pp"] * lay["tp"],
                lay["pp_rank"] * lay["tp"] + lay["tp_rank"])
    return 1, 0


def _box(local_shape, spec: Spec, lay: Mapping[str, int]
         ) -> Tuple[List[int], List[Tuple[int, int]]]:
    """``(global shape, [(start, stop)] per dim)`` of the part of a tensor
    a rank at ``lay`` holds, its local shape ``local_shape``."""
    shape, box = [], []
    for n, a in zip(local_shape, spec):
        parts, idx = _parts(a, lay)
        shape.append(n * parts)
        box.append((n * idx, n * (idx + 1)))
    return shape, box


def _writes(spec: Spec, lay: Mapping[str, int]) -> bool:
    """Whether the rank at ``lay`` writes its part: the first of the ranks
    that hold the same part (along the data index, the first whose parts
    of the data axes the spec does not shard over are 0)."""
    ep = lay.get("ep", 1)
    data = ("dp" in spec or lay["dp_rank"] == 0
            or (("ep" in spec or lay["dp_rank"] % ep == 0)
                and ("dp_exp" in spec or lay["dp_rank"] // ep == 0)))
    return (lay["tp_rank"] == 0 or "tp" in spec or "pptp" in spec) and data


def _shard_file(tp_rank: int, dp_rank: int, pp_rank: Optional[int] = None
                ) -> str:
    """A writing rank's payload file; a pipeline stage's carry its pp
    index too."""
    pp = "" if pp_rank is None else f"pp{pp_rank}_"
    return f"{STATE_DIR}/shard_{pp}tp{tp_rank}_dp{dp_rank}.pt"


def _file_of(lay: Mapping[str, int]) -> str:
    return _shard_file(lay["tp_rank"], lay["dp_rank"],
                       lay["pp_rank"] if lay.get("pp", 1) > 1 else None)


def shard_table(tree: Any, specs: Mapping[str, Any],
                lay: Mapping[str, int]) -> Dict[str, Any]:
    """The shard table of ``tree``, this rank's tensors at ``lay`` (every
    rank's the same shapes): per tensor path its global shape, dtype,
    spec and the ``[file, box]`` of every writing rank."""
    leaves = {}
    for path, t in tree_leaves(tree):
        spec = _norm_spec(specs.get(path), t.dim())
        shape, _ = _box(t.shape, spec, lay)
        pieces = []
        for tr in range(lay["tp"]):
            for dr in range(lay["dp"]):
                at = dict(lay, tp_rank=tr, dp_rank=dr)
                if _writes(spec, at):
                    pieces.append([_file_of(at),
                                   [list(b) for b in _box(t.shape, spec,
                                                          at)[1]]])
        leaves[path] = {"shape": shape, "dtype": str(t.dtype).split(".")[-1],
                        "spec": list(spec), "pieces": pieces}
    return {"tp": lay["tp"], "dp": lay["dp"], "pp": lay.get("pp", 1),
            "ep": lay.get("ep", 1), "leaves": leaves,
            "tree": _skeleton(tree)}


# ---------------------------------------------------------------------------
# pipeline stages: each rank holds the tensors of a part of the paths
# ---------------------------------------------------------------------------

def _global_paths(state: Any) -> Optional[Mapping[str, Tuple[str, bool]]]:
    """A pipeline stage's ``TrainState.global_paths`` (local path ->
    ``(path in the whole state, whether this rank writes it)``), None
    outside a pipeline layout."""
    gp = getattr(state, "global_paths", None)
    if gp is None or not _across_ranks() or ps.axis_size(ps.PP_AXIS) == 1:
        return None
    return gp


def _flat_skeleton(sk: Any, gpaths: Mapping[str, Tuple[str, bool]],
                   prefix: Tuple[str, ...] = (),
                   out: Optional[Tuple[list, dict]] = None
                   ) -> Tuple[list, dict]:
    """``(entries, kinds)`` of a stage's skeleton in whole-state paths:
    ``entries`` the ``(path, node)`` of each tensor and scalar, ``kinds``
    each container's path and kind (``"dict"`` or ``"list"``)."""
    entries, kinds = out if out is not None else ([], {})
    if "tensor" in sk:
        g = gpaths.get(sk["tensor"], (sk["tensor"], True))[0]
        entries.append((tuple(g.split("/")), {"tensor": g}))
    elif "value" in sk:
        entries.append((prefix, sk))
    else:
        kind = "dict" if "dict" in sk else "list"
        kinds[prefix] = kind
        items = (sk["dict"].items() if kind == "dict"
                 else ((str(i), v) for i, v in enumerate(sk["list"])))
        for k, v in items:
            _flat_skeleton(v, gpaths, prefix + (k,), (entries, kinds))
    return entries, kinds


def _merge_skeletons(parts: List[Tuple[list, dict]]) -> Any:
    """The whole state's skeleton from every stage's
    :func:`_flat_skeleton`: each container holds the union of its
    children, in the order the stages (in rank order) name them."""
    entries: Dict[tuple, Any] = {}
    kinds: Dict[tuple, str] = {}
    for ents, kd in parts:
        for path, node in ents:
            entries.setdefault(tuple(path), node)
        for path, kind in kd.items():
            kinds.setdefault(tuple(path), kind)
    children: Dict[tuple, List[str]] = {}
    for path in list(kinds) + list(entries):
        for i in range(len(path)):
            kids = children.setdefault(path[:i], [])
            if path[i] not in kids:
                kids.append(path[i])

    def build(prefix):
        if prefix not in kinds:
            return entries[prefix]
        kids = children.get(prefix, [])
        if kinds[prefix] == "list":
            kids = sorted(kids, key=int)
            if kids != [str(i) for i in range(len(kids))]:
                raise ValueError(f"{'/'.join(prefix)}: the stages hold "
                                 f"items {kids} of a list")
            return {"list": [build(prefix + (k,)) for k in kids]}
        return {"dict": {k: build(prefix + (k,)) for k in kids}}
    return build(())


def _merge_tables(tables: List[Mapping[str, Any]]) -> Dict[str, Any]:
    """One shard table from the stages' tables: each path's pieces from
    every stage that wrote it."""
    leaves: Dict[str, Any] = {}
    for t in tables:
        for p, entry in t["leaves"].items():
            if p not in leaves:
                leaves[p] = dict(entry, pieces=list(entry["pieces"]))
            else:
                leaves[p]["pieces"] += [x for x in entry["pieces"]
                                        if x not in leaves[p]["pieces"]]
    first = tables[0]
    return {"tp": first["tp"], "dp": first["dp"], "pp": first.get("pp", 1),
            "ep": first.get("ep", 1), "leaves": leaves, "tree": None}


def _stage_view(tree: Any, specs: Mapping[str, Any],
                gpaths: Mapping[str, Tuple[str, bool]], rank: int
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                           Optional[Dict[str, Any]]]:
    """A stage's snapshot in whole-state paths: the tensors it writes, their
    specs, and on rank 0 the shard table of the whole state, gathered from
    every rank (collective)."""
    import torch.distributed as dist

    leaves, gspecs = {}, {}
    for p, t in tree_leaves(tree):
        g, writes = gpaths.get(p, (p, True))
        if writes:
            leaves[g] = t
            gspecs[g] = specs.get(p)
    mine = (shard_table(leaves, gspecs, _layout()),
            _flat_skeleton(_skeleton(tree), gpaths))
    gathered: List[Any] = [None] * ps.world_size()
    dist.all_gather_object(gathered, mine)
    table = None
    if rank == 0:
        table = _merge_tables([g[0] for g in gathered])
        table["tree"] = _merge_skeletons([g[1] for g in gathered])
    return leaves, gspecs, table


def _set_scalars(target: Any, sk: Any) -> None:
    """Copy the scalars of the skeleton ``sk`` into ``target``'s fields and
    dict entries of the same paths (a stage's state loading a whole
    state's: the step and the optimizer's counts)."""
    if "dict" not in sk:
        return
    if dataclasses.is_dataclass(target):
        keys = [f.name for f in _fields(target)]
        get, put = target.__getattribute__, target.__setattr__
    elif isinstance(target, dict):
        keys = list(target)
        get, put = target.__getitem__, target.__setitem__
    else:
        return
    for k in keys:
        node = sk["dict"].get(str(k))
        if node is None:
            continue
        if "value" in node and _is_leaf(get(k)):
            put(k, node["value"])
        else:
            _set_scalars(get(k), node)


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


def saved_shard_table(path: str, tag: Any) -> Optional[Dict[str, Any]]:
    """The shard table a tag carries in its manifest (each tensor's global
    shape, dtype, spec and pieces), or None for a tag written before the
    shard table."""
    path = _normalize_path(path)
    return _shard_table_of(create_checkpoint_storage(path),
                           _tag_dir(path, str(tag)))


def user_content(path: str, tag: Any) -> Optional[dict]:
    """The ``user_content`` saved with ``tag``, or None."""
    path = _normalize_path(path)
    storage = create_checkpoint_storage(path)
    uc = os.path.join(_tag_dir(path, str(tag)), USER_CONTENT_FILE)
    return storage.load_object(uc) if storage.file_exists(uc) else None


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _on_local_disk(storage: BaseCheckpointStorage) -> bool:
    """Whether the payload goes straight to a local path: a filesystem
    backend, also under wrappers such as the chaos storage (which wrap the
    control plane; the payload bypasses them, as the reference's Orbax
    writes beside its storage)."""
    while hasattr(storage, "inner"):
        storage = storage.inner
    return isinstance(storage, FilesysCheckpointStorage)


def _join(tdir: str, rel: str) -> str:
    if "://" in tdir:
        return tdir.rstrip("/") + "/" + rel
    return os.path.join(tdir, *rel.split("/"))


class _HashingWriter:
    """A file that ``torch.save`` writes through, with the SHA-256 of what
    it writes taken on a second thread while each large record goes to
    disk (both release the interpreter lock), so a shard's digest needs
    no second read of the file."""

    LARGE = 1 << 20

    def __init__(self, f):
        import concurrent.futures
        import hashlib

        self.f, self.h = f, hashlib.sha256()
        self.pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="ckpt-digest")

    def write(self, b) -> int:
        if memoryview(b).nbytes < self.LARGE:
            self.h.update(b)
            return self.f.write(b)
        digest = self.pool.submit(self.h.update, b)
        try:
            return self.f.write(b)
        finally:
            digest.result()

    def flush(self) -> None:
        self.f.flush()

    def close(self) -> None:
        self.pool.shutdown()


def _write_file(storage: BaseCheckpointStorage, target: str,
                obj: Any) -> Optional[str]:
    """``torch.save`` ``obj`` to ``target`` (local disk: through a temporary
    file renamed into place, digested as it is written). Returns the
    file's SHA-256 on a local disk, else None."""
    if _on_local_disk(storage):
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            w = _HashingWriter(f)
            try:
                torch.save(obj, w)
            finally:
                w.close()
        os.replace(tmp, target)
        return w.h.hexdigest()
    buf = io.BytesIO()
    torch.save(obj, buf)
    storage.save_bytes(buf.getvalue(), target)
    return None


def _clear_tag(storage: BaseCheckpointStorage, tdir: str) -> None:
    """Drop a tag's done-marker and manifest, then its payload and rank
    markers: a done-marker always implies a durable payload."""
    storage.remove_file(os.path.join(tdir, DONE_FILE))
    storage.remove_file(os.path.join(tdir, MANIFEST_FILE))
    for sub in (STATE_DIR, RANKS_DIR):
        d = _join(tdir, sub)
        if storage.dir_exists(d):
            storage.remove_dir(d)


def save_checkpoint(
    path: str,
    tag: Any,
    state: Any,
    user_content: Optional[dict] = None,
    async_save: bool = True,
    num_kept: int = -1,
    specs: Optional[Mapping[str, Any]] = None,
) -> None:
    """Save ``state`` (a ``TrainState``, or any dataclass, dict or list of
    tensors and scalars) under ``path/tag``.

    Returns once every tensor has been copied to host memory; with
    ``async_save`` the payload, the manifest and the done-marker are
    written on a background thread and training goes on. Across ranks
    every rank calls it at the same step: each writes its part (``specs``,
    by tensor path, default ``state.shard_specs``; a tensor without one is
    whole on every rank) and rank 0 commits the tag once every rank's file
    is written; a synchronous save returns on every rank once the tag is
    committed. A pipeline stage's state (``TrainState.global_paths``)
    writes its tensors under their paths in the whole state, and the tag's
    shard table is the union over the stages: the tag is the one the same
    state saved at another layout would write."""
    tag = str(tag)
    path = _normalize_path(path)
    _IO_STATE.raise_pending_errors()
    storage = create_checkpoint_storage(path)
    tdir = _tag_dir(path, tag)
    rank, world = _rank_world()
    if specs is None:
        specs = getattr(state, "shard_specs", None) or {}

    # done-marker implies a durable payload: an overwrite drops the stale
    # marker and manifest before the payload is touched, after joining an
    # in-flight save of the same tag (on every rank, across ranks)
    _IO_STATE.wait_tag(tag)
    if world > 1:
        ps.barrier()
    if rank == 0:
        storage.create_dir(tdir)
        _clear_tag(storage, tdir)
    if world > 1:
        ps.barrier()

    # the snapshot: a blocking copy to host memory, so the next step's
    # in-place update cannot reach the values being written
    tree = state_to_tree(state, lambda t: t.detach().to("cpu", copy=True))
    table = None
    gpaths = _global_paths(state)
    if gpaths is not None:
        tree, specs, table = _stage_view(tree, specs, gpaths, rank)
    if user_content is not None and rank == 0:
        storage.save_object(user_content, os.path.join(tdir,
                                                       USER_CONTENT_FILE))
    commit = _rank_commit(storage, path, tdir, tag, tree, specs, num_kept,
                          table)

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
    elif world == 1:
        commit()
    else:
        # returns on every rank once rank 0 has committed, or raises on
        # every rank when any rank's part failed
        err = None
        try:
            commit()
        except Exception as e:  # noqa: BLE001 - raised below, on all ranks
            err = e
        if ps.agree(float(err is None), "min") < 1.0:
            raise err or CheckpointSaveError(
                f"checkpoint {tdir}: another rank's part failed")


def _finish(storage: BaseCheckpointStorage, path: str, tdir: str, tag: str,
            num_kept: int) -> None:
    """The last steps of a commit, after the manifest: the done-marker,
    ``newest`` and retention."""
    storage.save_text("done", os.path.join(tdir, DONE_FILE))
    storage.save_text(tag, os.path.join(path, NEWEST_FILE))
    if num_kept > 0:
        _apply_retention(storage, path, num_kept)
    logger.info("checkpoint %s committed", tdir)


def _write_rank_part(storage: BaseCheckpointStorage, tdir: str, tree: Any,
                     specs: Mapping[str, Any], lay: Mapping[str, int],
                     rank: int) -> None:
    """Write the part of ``tree`` (this rank's tensors at ``lay``) that
    the rank writes, digest the file, and leave the rank's marker
    ``ranks/<rank>.json`` (``[relpath, size, sha256]``)."""
    marker = _join(tdir, f"{RANKS_DIR}/{rank}.json")
    try:
        part = {p: t for p, t in tree_leaves(tree)
                if _writes(_norm_spec(specs.get(p), t.dim()), lay)}
        rel = _file_of(lay)
        target = _join(tdir, rel)
        digest = _write_file(storage, target, part)
        size = storage.file_size(target)
        if digest is None:
            digest = _manifest.file_digest(storage, target)
        storage.save_object([rel, size, digest], marker)
    except Exception as e:
        # tell rank 0's commit, which waits for this marker, to give up
        storage.save_object(["error", repr(e)], marker)
        raise


def _commit_tag(storage: BaseCheckpointStorage, path: str, tdir: str,
                tag: str, world: int, table: Dict[str, Any],
                num_kept: int, timeout: float = RANK_WAIT_S) -> None:
    """Rank 0's half of a commit: wait for every rank's marker, write the
    manifest over every file (with the shard table) once the payload is
    durable, then :func:`_finish`: a complete tag always carries its
    inventory."""
    markers = [_join(tdir, f"{RANKS_DIR}/{r}.json") for r in range(world)]
    deadline = time.monotonic() + timeout
    while not all(storage.file_exists(m) for m in markers):
        if time.monotonic() > deadline:
            missing = [r for r, m in enumerate(markers)
                       if not storage.file_exists(m)]
            raise CheckpointSaveError(f"checkpoint {tdir}: rank(s) {missing} "
                                      f"wrote nothing in {timeout:.0f} s")
        time.sleep(0.05)
    known = {}
    for r, m in enumerate(markers):
        entry = storage.load_object(m)
        if entry[0] == "error":
            raise CheckpointSaveError(f"checkpoint {tdir}: rank {r}'s part "
                                      f"failed: {entry[1]}")
        rel, size, digest = entry
        known[rel] = [size, digest]
    man = _manifest.build_manifest(storage, tdir, tag, known=known,
                                   shards=table)
    if man is not None:
        storage.save_object(man, os.path.join(tdir, MANIFEST_FILE))
    _finish(storage, path, tdir, tag, num_kept)


def _rank_commit(storage, path, tdir, tag, tree, specs, num_kept,
                 table=None) -> Callable[[], None]:
    """A rank's commit: its part and marker; on rank 0 also the wait for
    every rank and the manifest (with ``table``, by default this rank's
    shard table), done-marker and ``newest``. Files only: no collective,
    so it may run on a commit thread."""
    lay, (rank, world) = _layout(), _rank_world()
    if rank == 0 and table is None:
        table = shard_table(tree, specs, lay)

    def commit():
        _write_rank_part(storage, tdir, tree, specs, lay, rank)
        if rank == 0:
            _commit_tag(storage, path, tdir, tag, world, table, num_kept)
    return commit


def save_at_layout(path: str, tag: Any, tree: Any,
                   specs: Mapping[str, Any], tp: int, dp: int,
                   user_content: Optional[dict] = None,
                   num_kept: int = -1, pp: int = 1,
                   stage_of: Optional[Callable[[str], int]] = None) -> None:
    """Write the whole tensors of ``tree`` (from one process) as the tag
    ``pp`` x ``tp`` x ``dp`` ranks would save under ``specs``: one file
    per writing rank, each rank's marker, then the manifest and the
    done-marker. At ``pp > 1`` ``stage_of(path)`` names the stage that
    writes each tensor (one over pp for a ``"pptp"`` spec: every stage
    writes its shard). What :mod:`..scripts.reshard_checkpoint` writes at
    another layout."""
    tag = str(tag)
    path = _normalize_path(path)
    storage = create_checkpoint_storage(path)
    tdir = _tag_dir(path, tag)
    _IO_STATE.wait_tag(tag)
    storage.create_dir(tdir)
    _clear_tag(storage, tdir)
    tree = state_to_tree(tree, lambda t: t.detach().to("cpu"))
    if user_content is not None:
        storage.save_object(user_content, os.path.join(tdir,
                                                       USER_CONTENT_FILE))
    tables = []
    flat = dict(tree_leaves(tree))
    for st in range(pp):
        part = flat if pp == 1 else {
            p: t for p, t in flat.items()
            if "pptp" in _norm_spec(specs.get(p), t.dim())
            or stage_of(p) == st}
        for tr in range(tp):
            for dr in range(dp):
                lay = dict(tp=tp, tp_rank=tr, dp=dp, dp_rank=dr, pp=pp,
                           pp_rank=st)
                local = _local_tree(part, specs, lay)
                if tr == dr == 0:
                    tables.append(shard_table(local, specs, lay))
                _write_rank_part(storage, tdir, local, specs, lay,
                                 (st * dp + dr) * tp + tr)
    table = _merge_tables(tables)
    table["tree"] = _skeleton(tree)
    _commit_tag(storage, path, tdir, tag, pp * tp * dp, table, num_kept)


def _local_tree(tree: Any, specs: Mapping[str, Any],
                lay: Mapping[str, int]) -> Any:
    """``tree`` of whole tensors cut to the parts the rank at ``lay``
    holds under ``specs``."""
    def cut(path, t):
        spec = _norm_spec(specs.get(path), t.dim())
        for d, a in enumerate(spec):
            parts, idx = _parts(a, lay)
            if t.shape[d] % parts:
                raise ValueError(f"{path}: dim {d} ({t.shape[d]}) not "
                                 f"divisible by {parts}")
            n = t.shape[d] // parts
            t = t.narrow(d, idx * n, n)
        return t.contiguous()

    leaves = {p: cut(p, t) for p, t in tree_leaves(tree)}
    return _unskeleton(_skeleton(tree), leaves)


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
    error. Across ranks every rank calls it together, and it returns once
    rank 0 has committed every tag the ranks saved."""
    _IO_STATE.wait_all()
    if _across_ranks():
        ps.barrier()


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _verify_tag(storage: BaseCheckpointStorage, path: str,
                tag: str) -> Tuple[bool, str]:
    """Verify one tag; across ranks each rank digests its share of the
    files and the ranks agree (one rank's failure fails it on all)."""
    tdir = _tag_dir(path, tag)
    if not _across_ranks():
        return _manifest.verify_manifest(storage, tdir,
                                         os.path.join(tdir, MANIFEST_FILE))
    ok, why = _manifest.verify_manifest(
        storage, tdir, os.path.join(tdir, MANIFEST_FILE),
        share=(ps.world_rank(), ps.world_size()))
    if ps.agree(float(ok), "min") < 1.0:
        return False, why if not ok else "another rank's share failed"
    return True, why


def _read_file(storage: BaseCheckpointStorage, source: str,
               map_location: torch.device) -> Any:
    if _on_local_disk(storage):
        return torch.load(source, map_location=map_location,
                          weights_only=True, mmap=True)
    with tempfile.TemporaryFile() as f:
        f.write(storage.read_bytes(source))
        f.seek(0)
        return torch.load(f, map_location=map_location, weights_only=True)


class _Files(dict):
    """A tag's payload files by relpath, each loaded (memory-mapped) at
    first use."""

    def __init__(self, storage: BaseCheckpointStorage, tdir: str):
        super().__init__()
        self.storage, self.tdir = storage, tdir

    def __missing__(self, rel: str) -> Any:
        self[rel] = _read_file(self.storage, _join(self.tdir, rel),
                               torch.device("cpu"))
        return self[rel]


def _shard_table_of(storage: BaseCheckpointStorage,
                    tdir: str) -> Optional[Dict[str, Any]]:
    """The shard table of a tag, None for a tag written before it."""
    man_path = os.path.join(tdir, MANIFEST_FILE)
    if not storage.file_exists(man_path):
        return None
    return storage.load_object(man_path).get("shards")


def _whole_table(storage: BaseCheckpointStorage, tdir: str
                 ) -> Tuple[Dict[str, Any], _Files]:
    """A tag written before the shard table, as one: every tensor whole
    in its one payload."""
    rel = f"{STATE_DIR}/{PAYLOAD_FILE}"
    tree = _read_file(storage, _join(tdir, rel), torch.device("cpu"))
    files = _Files(storage, tdir)
    files[rel] = dict(tree_leaves(tree))
    leaves = {p: {"shape": list(t.shape),
                  "dtype": str(t.dtype).split(".")[-1],
                  "spec": [None] * t.dim(),
                  "pieces": [[rel, [[0, n] for n in t.shape]]]}
              for p, t in tree_leaves(tree)}
    return {"tp": 1, "dp": 1, "leaves": leaves,
            "tree": _skeleton(tree)}, files


@torch.no_grad()
def _assemble(entry: Mapping[str, Any], path: str, files: Mapping[str, Any],
              box: List[Tuple[int, int]], out: torch.Tensor) -> None:
    """Fill ``out`` (the part ``box`` of the tensor ``path``) from the
    saved pieces that overlap it."""
    covered = 0
    for rel, pbox in entry["pieces"]:
        lo = [max(a, p[0]) for (a, _), p in zip(box, pbox)]
        hi = [min(b, p[1]) for (_, b), p in zip(box, pbox)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        piece = files[rel][path]
        src = piece[tuple(slice(l - p[0], h - p[0])
                          for l, h, p in zip(lo, hi, pbox))]
        out[tuple(slice(l - b[0], h - b[0])
                  for l, h, b in zip(lo, hi, box))].copy_(src)
        covered += math.prod(h - l for l, h in zip(lo, hi))
    if covered != math.prod(b - a for a, b in box):
        raise ValueError(f"{path}: the saved pieces cover {covered} of the "
                         f"{math.prod(b - a for a, b in box)} elements "
                         "wanted")


def _restore_tag(storage: BaseCheckpointStorage, path: str, tag: str,
                 target: Optional[Any], device: torch.device,
                 specs: Optional[Mapping[str, Any]] = None
                 ) -> Tuple[Any, Optional[dict]]:
    tdir = _tag_dir(path, tag)
    table = _shard_table_of(storage, tdir)
    if table is None:
        table, files = _whole_table(storage, tdir)
    else:
        files = _Files(storage, tdir)
    state = (_assemble_whole(table, files, device) if target is None
             else _assemble_into(table, files, target, specs))
    uc = os.path.join(tdir, USER_CONTENT_FILE)
    content = storage.load_object(uc) if storage.file_exists(uc) else None
    return state, content


def _assemble_whole(table: Mapping[str, Any], files: Mapping[str, Any],
                    device: torch.device) -> Any:
    """The saved tree with every tensor whole, on ``device``."""
    whole = {}
    for p, entry in table["leaves"].items():
        t = torch.empty(entry["shape"], dtype=getattr(torch, entry["dtype"]))
        _assemble(entry, p, files, [(0, n) for n in entry["shape"]], t)
        whole[p] = t.to(device)
    return _unskeleton(table["tree"], whole)


@torch.no_grad()
def _assemble_into(table: Mapping[str, Any], files: Mapping[str, Any],
                   target: Any, specs: Optional[Mapping[str, Any]]) -> Any:
    """Copy into each tensor of ``target`` its part at this rank's layout
    (under ``specs``, default ``target.shard_specs``), then the saved
    scalars. Returns ``target``."""
    if specs is None:
        specs = getattr(target, "shard_specs", None) or {}
    leaves, lay = table["leaves"], _layout()
    mine = dict(tree_leaves(state_to_tree(target, lambda t: t)))
    gpaths = _global_paths(target)
    if gpaths is not None:
        # a pipeline stage: its tensors by their paths in the whole state
        for p, t in mine.items():
            g = gpaths.get(p, (p, True))[0]
            if g not in leaves:
                raise ValueError(f"{p}: the checkpoint holds no {g}")
            shape, box = _box(t.shape, _norm_spec(specs.get(p), t.dim()),
                              lay)
            if shape != list(leaves[g]["shape"]):
                raise ValueError(f"{g}: {leaves[g]['shape']} cannot load "
                                 f"into {shape}")
            _assemble(leaves[g], g, files, box, t)
        _set_scalars(target, table["tree"])
        return target
    if set(mine) != set(leaves):
        raise ValueError(f"the checkpoint holds {sorted(leaves)}, the "
                         f"target {sorted(mine)}")
    for p, t in mine.items():
        entry = leaves[p]
        shape, box = _box(t.shape, _norm_spec(specs.get(p), t.dim()), lay)
        if (shape != list(entry["shape"])
                or str(t.dtype).split(".")[-1] != entry["dtype"]):
            raise ValueError(f"{p}: {entry['shape']} {entry['dtype']} "
                             f"cannot load into {shape} {t.dtype}")
        _assemble(entry, p, files, box, t)
    return load_tree_(target, _unskeleton(table["tree"], mine))


def _try_restore(storage, path, tag, target, device, specs):
    """:func:`_restore_tag`; across ranks the ranks agree on success (a
    failure on one fails the tag on all). ``(state, content)`` or the
    error's text."""
    try:
        out, err = _restore_tag(storage, path, tag, target, device, specs), ""
    except Exception as e:  # reported or raised by the caller
        out, err = None, repr(e)
    if _across_ranks() and ps.agree(float(out is not None), "min") < 1.0:
        return None, err or "another rank failed to restore"
    return out, err


def load_checkpoint(
    path: str,
    tag: Optional[Any] = None,
    target: Optional[Any] = None,
    verify: bool = True,
    device: DeviceLike = None,
    specs: Optional[Mapping[str, Any]] = None,
) -> Tuple[Any, Optional[dict]]:
    """Load ``(state, user_content)``.

    ``tag=None`` / ``"-1"`` resumes from the newest complete checkpoint
    that verifies, falling back to the prior complete tag with a logged
    warning; an explicit tag that fails verification raises
    :class:`CheckpointCorruptionError`. With ``target`` (e.g. the live
    ``TrainState``) the values are copied into its tensors in place and
    ``target`` is returned; without, the saved tree of dicts and lists is
    returned with its whole tensors on ``device`` (None: the CUDA card).
    Across ranks every rank calls it together and gets its part of each
    tensor under ``specs`` (default ``target.shard_specs``; a tensor
    without one is whole) at the current layout, whatever layout saved
    the tag."""
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
            out, err = _try_restore(storage, path, t, target, device, specs)
            if out is not None:
                return out
            logger.warning(
                "checkpoint %s/%s failed to restore (%s); falling back "
                "to the prior complete tag", path, t, err)
            skipped.append((t, err))
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
    return _restore_tag(storage, path, tag, target, device, specs)
