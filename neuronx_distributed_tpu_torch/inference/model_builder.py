"""AOT inference builder and runtime container of the port (counterpart of
``neuronx_distributed_tpu/inference/model_builder.py``).

* :class:`ModelBuilder` registers model *keys* ("context_encoding",
  "token_generation", ...) with *bucketed* example arguments, resolves and
  fingerprints each function (``trace``) and captures each (key, bucket)
  (``compile``), priority models first.
* :class:`NxDModel` is the runtime container: a shape-keyed router that
  sends a call to the matching bucket's captured step, with save and load
  of the whole bundle.

What the reference exports as StableHLO has no counterpart in eager
PyTorch. A bundle therefore *names* each artifact's function by import
path (``module:qualname``, or a ``functools.partial`` of one with JSON
arguments such as a model config), next to the function's
:func:`.aot_cache.source_fingerprint` and its bucket's leaf shapes and
dtypes. ``load`` runs no code that the file names: it looks each name up
among the functions registered with :func:`bundle_function` (the bundle
functions below; a caller registers its own and imports them before
loading), refuses one whose source changed, and builds JSON arguments only
of the model config dataclasses. Nothing is imported by name and nothing
is unpickled. Weights ride inline, one raw ``weight_<j>.bin`` a tensor.

A captured step (:class:`.aot_cache.CapturedStep`: a CUDA graph on the
card, the eager step on the CPU) binds the tensors of the arguments it was
captured with. Parameters and state (the tensors inside a dict or a cache)
are bound by address: a later call that passes the same tensors uses them
in place, and other tensors are copied into the bound ones. Bare tensor
arguments (ids, positions) get buffers of the step's own and are copied
in every call. The state comes back updated in place, as every cache of
the port; every other output is a copy. A bundle loaded with :meth:`
NxDModel.load` captures each bucket at its first call, bound to the
bundle's weights and to the state :meth:`NxDModel.init_state` returns.

The bundle workers of :func:`register_serving_workers`, the ViT
classifier of :func:`register_image_encoder` (:func:`image_encoder`, the
reference's ``examples/inference/vit_serve.py``) and the functions
:func:`cached_step` and :func:`speculation_round` take the bridge's state
dict (:mod:`..models.convert`) as ``params`` through
``torch.func.functional_call`` on a weightless (``meta``) model: no second
copy of the weights.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import math
import zipfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from ..device import DeviceLike, resolve_device
from .aot_cache import CapturedStep, source_fingerprint
from .kv_cache import PAD_POSITION, KVCache, QuantizedKVCache, init_kv_cache
from .paging import (PagedKVCache, QuantizedPagedKVCache, init_paged_kv_cache,
                     init_quantized_paged_kv_cache)

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# The caches as pytree nodes: their tensors are leaves, a paged pool's
# block size its context.
# ---------------------------------------------------------------------------

_CACHE_FIELDS = {
    KVCache: ("k", "v", "pos", "index"),
    QuantizedKVCache: ("k", "v", "pos", "index", "k_scale", "v_scale"),
    PagedKVCache: ("k", "v", "pos", "block_tables", "lengths"),
    QuantizedPagedKVCache: ("k", "v", "pos", "block_tables", "lengths",
                            "k_scale", "v_scale"),
}


def _register_caches() -> None:
    for cls, names in _CACHE_FIELDS.items():
        if cls in pytree.SUPPORTED_NODES:
            continue
        paged = issubclass(cls, PagedKVCache)

        def flatten(c, names=names, paged=paged):
            return ([getattr(c, n) for n in names],
                    c.block_size if paged else None)

        def flatten_with_keys(c, names=names, paged=paged):
            return ([(pytree.GetAttrKey(n), getattr(c, n)) for n in names],
                    c.block_size if paged else None)

        def unflatten(leaves, ctx, cls=cls, names=names, paged=paged):
            kw = dict(zip(names, leaves))
            if paged:
                kw["block_size"] = ctx
            return cls(**kw)

        pytree.register_pytree_node(
            cls, flatten, unflatten,
            serialized_type_name=f"nxd_torch.{cls.__name__}",
            to_dumpable_context=lambda ctx: ctx,
            from_dumpable_context=lambda ctx: ctx,
            flatten_with_keys_fn=flatten_with_keys)


_register_caches()


def _canonical(tree):
    """``tree`` with every dict's keys sorted (the leaf order of the
    reference's pytrees, whatever order a state dict was built in) and a
    contiguous cache's host-int write index as a 0-dim int32 tensor on the
    cache's device (the reference's scalar index: one captured step then
    serves every position)."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_canonical(x) for x in tree)
    if isinstance(tree, KVCache) and not isinstance(tree.index,
                                                    torch.Tensor):
        return dataclasses.replace(tree, index=torch.tensor(
            tree.index, dtype=torch.int32, device=tree.k.device))
    return tree


@dataclass(frozen=True)
class LeafSpec:
    """One leaf of a bucket: a tensor's shape and dtype name, or a
    non-tensor leaf's value."""

    shape: Tuple[int, ...]
    dtype: Optional[str] = None
    value: Any = None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_spec(x) -> LeafSpec:
    if isinstance(x, torch.Tensor):
        return LeafSpec(tuple(x.shape), _dtype_name(x.dtype))
    return LeafSpec((), None, x)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


@dataclass
class TraceArtifacts:
    """Per-(key, bucket) artifact (reference ``TraceArtifacts``): the
    bucket's tree and leaves, the function's import reference (None for a
    lambda or a closure, which cannot be saved) and source fingerprint, and
    the captured step once compiled."""

    key: str
    bucket: Tuple[Any, List[LeafSpec]]       # (treespec, leaves)
    fn: Callable
    ref: Optional[Dict[str, Any]] = None
    fingerprint: str = ""
    compiled: Optional["_Program"] = None

    @property
    def leaves(self) -> List[LeafSpec]:
        return self.bucket[1]


# ---------------------------------------------------------------------------
# Functions by import path, with JSON arguments
# ---------------------------------------------------------------------------

def _qualified(obj) -> str:
    return f"{obj.__module__}:{obj.__qualname__}"


def _to_json(v):
    if isinstance(v, torch.dtype):
        return {"__dtype__": _dtype_name(v)}
    if (dataclasses.is_dataclass(v) and not isinstance(v, type)
            and _qualified(type(v)) in _json_dataclasses()):
        return {"__dataclass__": _qualified(type(v)),
                "fields": {f.name: _to_json(getattr(v, f.name))
                           for f in dataclasses.fields(v)}}
    if isinstance(v, tuple):
        return {"__tuple__": [_to_json(x) for x in v]}
    if isinstance(v, list):
        return [_to_json(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _to_json(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"{type(v).__name__} is not a JSON argument")


def _torch_dtype(name) -> torch.dtype:
    """The ``torch`` dtype called ``name``; any other attribute raises."""
    dtype = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"bundle names {name!r}, which is not a torch dtype")
    return dtype


def _json_dataclasses() -> Dict[str, type]:
    """The dataclasses a bundle's JSON arguments may build: the model
    configs, and the LoRA config a Llama config may hold."""
    from ..lora import LoraConfig
    from ..models.bert import BertConfig
    from ..models.gpt_neox import GPTNeoXConfig
    from ..models.llama import LlamaConfig
    from ..models.mixtral import MixtralConfig
    from ..models.vit import ViTConfig

    return {_qualified(c): c for c in (LlamaConfig, MixtralConfig,
                                       GPTNeoXConfig, BertConfig, ViTConfig,
                                       LoraConfig)}


def _from_json(v):
    if isinstance(v, list):
        return [_from_json(x) for x in v]
    if not isinstance(v, dict):
        return v
    if "__dtype__" in v:
        return _torch_dtype(v["__dtype__"])
    if "__tuple__" in v:
        return tuple(_from_json(x) for x in v["__tuple__"])
    if "__dataclass__" in v:
        cls = _json_dataclasses().get(v["__dataclass__"])
        if cls is None:
            raise ValueError(
                f"bundle argument names class {v['__dataclass__']!r}; "
                "a bundle builds only the model config dataclasses")
        fields = v.get("fields", {})
        known = {f.name for f in dataclasses.fields(cls) if f.init}
        if not isinstance(fields, dict) or not set(fields) <= known:
            raise ValueError(f"bundle argument of {cls.__name__} has fields "
                             f"it does not know: {sorted(set(fields) - known)}")
        return cls(**{k: _from_json(x) for k, x in fields.items()})
    return {k: _from_json(x) for k, x in v.items()}


# the functions a bundle may name, by "module:qualname"
_BUNDLE_FUNCTIONS: Dict[str, Callable] = {}


def bundle_function(fn: Callable) -> Callable:
    """Register a module-level function as one a bundle may name (a
    decorator). :meth:`NxDModel.load` resolves a name only against these:
    a process that loads a bundle of its own functions imports their module
    first."""
    qualname = getattr(fn, "__qualname__", "")
    if not getattr(fn, "__module__", None) or "<" in qualname:
        raise ValueError(f"{qualname or fn!r} is a lambda or a closure: a "
                         "bundle names module-level functions only")
    _BUNDLE_FUNCTIONS[_qualified(fn)] = fn
    return fn


def function_ref(fn: Callable) -> Optional[Dict[str, Any]]:
    """``{"function": "module:qualname", "kwargs": {...}}`` naming ``fn``
    (a function registered with :func:`bundle_function`, or a
    ``functools.partial`` of one with JSON keyword arguments), or None for
    any other (a lambda, a closure, an unregistered function, a partial
    with positional or non-JSON arguments)."""
    kwargs: Dict[str, Any] = {}
    base = fn
    if isinstance(fn, functools.partial):
        if fn.args:
            return None
        base = fn.func
        try:
            kwargs = {k: _to_json(v) for k, v in fn.keywords.items()}
        except TypeError:
            return None
    if not hasattr(base, "__qualname__") or not hasattr(base, "__module__"):
        return None
    ref = _qualified(base)
    if _BUNDLE_FUNCTIONS.get(ref) is not base:
        return None
    return {"function": ref, "kwargs": kwargs}


def _fn_from_ref(ref: Dict[str, Any], fingerprint: str, key: str
                 ) -> Callable:
    """The registered function ``ref`` names, checked against the source
    ``fingerprint`` it was saved with, then bound to its JSON arguments:
    a name that is not registered raises before anything is built."""
    name = ref.get("function")
    fn = _BUNDLE_FUNCTIONS.get(name) if isinstance(name, str) else None
    if fn is None:
        raise ValueError(
            f"artifact {key!r} names {name!r}, which is not a registered "
            "bundle function (register it with bundle_function and import "
            "its module before loading)")
    fp = source_fingerprint(fn)
    if fp != fingerprint:
        raise ValueError(
            f"artifact {key!r}: the source of {name} changed since the "
            f"bundle was saved (fingerprint {str(fingerprint)[:16]}, now "
            f"{fp[:16]})")
    kwargs = {k: _from_json(v) for k, v in ref.get("kwargs", {}).items()}
    return functools.partial(fn, **kwargs) if kwargs else fn


def _fingerprint(fn: Callable) -> str:
    return source_fingerprint(fn.func if isinstance(fn, functools.partial)
                              else fn)


# ---------------------------------------------------------------------------
# A captured (key, bucket)
# ---------------------------------------------------------------------------

def _scratch_like(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` over a copy of its whole storage, so a pool's spare
    rows come along (the capture's warm-up writes there, not into the
    caller's state)."""
    out = torch.empty(0, dtype=t.dtype, device=t.device)
    return out.set_(t.untyped_storage().clone(), t.storage_offset(),
                    t.size(), t.stride())


class _Program:
    """One bucket's :class:`CapturedStep` over the arguments it was first
    called with: tensors inside a dict (parameters) or a cache (state) are
    bound by address, bare tensors get buffers of the step's own."""

    def __init__(self, fn: Callable, args: Tuple[Any, ...]):
        flat, self.spec = pytree.tree_flatten_with_path(args)
        self.bound: List[bool] = []
        bufs, warm = [], []
        for path, leaf in flat:
            inside = len(path) > 1
            state = any(isinstance(k, pytree.GetAttrKey) for k in path)
            self.bound.append(inside and isinstance(leaf, torch.Tensor))
            if not isinstance(leaf, torch.Tensor):
                bufs.append(leaf)
                warm.append(leaf)
            elif inside:
                bufs.append(leaf)
                warm.append(_scratch_like(leaf) if state else leaf)
            else:
                bufs.append(leaf.clone())
                warm.append(bufs[-1])
        spec = self.spec

        def step(*leaves):
            return fn(*pytree.tree_unflatten(list(leaves), spec))

        self.step = CapturedStep(step, bufs, warm_inputs=warm)
        self._bound_ids = {id(b) for b, is_b in zip(bufs, self.bound)
                           if is_b}

    @property
    def buffers(self) -> Tuple[Any, ...]:
        return self.step.inputs

    def __call__(self, flat_args: Sequence[Any]):
        for a, buf in zip(flat_args, self.buffers):
            if isinstance(buf, torch.Tensor) and not (
                    isinstance(a, torch.Tensor) and a is buf):
                if (isinstance(a, torch.Tensor)
                        and a.data_ptr() == buf.data_ptr()
                        and a.stride() == buf.stride()):
                    continue
                buf.copy_(torch.as_tensor(a))
        out = self.step.run()
        leaves, spec = pytree.tree_flatten(out)
        return pytree.tree_unflatten(
            [x.clone() if isinstance(x, torch.Tensor)
             and id(x) not in self._bound_ids else x for x in leaves], spec)


@dataclass
class _ModelEntry:
    fn: Callable
    buckets: List[Tuple[Any, ...]]   # example args, each a tuple
    priority: bool = False


def generate_buckets(min_length: int, max_length: int) -> List[int]:
    """Log2-spaced bucket sizes from ``min_length`` up to ``max_length``
    (the reference's autobucketing: ``round(log2(max))`` avoids a bucket
    one step under the max). Routing an input to the tightest bucket with
    padding is :meth:`NxDModel.router` / ``forward(pad_inputs=True)``."""
    if min_length >= max_length:
        return [max_length]
    lo = int(math.log2(min_length))
    hi = round(math.log2(max_length))
    return [2 ** i for i in range(lo, hi)] + [max_length]


class ModelBuilder:
    """Multi-key, multi-bucket builder (reference ``ModelBuilder``:
    ``add``, ``trace``, ``compile``)."""

    def __init__(self, compiler_flags: Optional[dict] = None):
        self._entries: Dict[str, _ModelEntry] = {}
        self._artifacts: Dict[Tuple[str, int], TraceArtifacts] = {}
        self._compiler_flags = compiler_flags or {}

    def add(self, key: str, fn: Callable, example_args: Sequence[Tuple],
            priority_model: bool = False) -> "ModelBuilder":
        """Register ``fn`` under ``key`` with one or more argument buckets
        (each an args tuple of tensors, dicts of tensors and caches); each
        bucket is recorded as its leaves' shapes and dtypes."""
        buckets = [tuple(_canonical(tuple(args)))
                   for args in example_args]
        self._entries[key] = _ModelEntry(fn=fn, buckets=buckets,
                                         priority=priority_model)
        return self

    def trace(self) -> "ModelBuilder":
        """Resolve and fingerprint each (key, bucket)'s function."""
        for key, entry in self._entries.items():
            ref = function_ref(entry.fn)
            fp = _fingerprint(entry.fn)
            for bi, args in enumerate(entry.buckets):
                leaves, spec = pytree.tree_flatten(args)
                self._artifacts[(key, bi)] = TraceArtifacts(
                    key=key, bucket=(spec, [_leaf_spec(x) for x in leaves]),
                    fn=entry.fn, ref=ref, fingerprint=fp)
                logger.info("traced %s bucket %d", key, bi)
        return self

    def compile(self, cache: Optional[Any] = None) -> "NxDModel":
        """Capture every artifact over its example arguments, priority
        models first. With an :class:`~.aot_cache.AotExecutableCache` each
        goes through ``cache.compile_or_load``, keyed by the function (its
        import path and source), the bucket and the addresses it binds."""
        if not self._artifacts:
            self.trace()
        order = sorted(self._artifacts.items(),
                       key=lambda kv: not self._entries[kv[0][0]].priority)
        leased = []
        for (key, bi), art in order:
            args = self._entries[key].buckets[bi]
            if cache is not None:
                probe = [x.data_ptr() for x in pytree.tree_leaves(args)
                         if isinstance(x, torch.Tensor)]
                k = cache.key_for("model-builder", repr(art.ref),
                                  art.fingerprint, repr(art.leaves),
                                  repr(art.bucket[0]), tuple(probe))
                art.compiled, from_cache = cache.compile_or_load(
                    k, _Program, (art.fn, args))
                leased.append(art.compiled)
                logger.info("%s %s bucket %d", "loaded" if from_cache
                            else "captured", key, bi)
            else:
                art.compiled = _Program(art.fn, args)
                logger.info("captured %s bucket %d", key, bi)
        model = NxDModel(self._artifacts)
        if leased:
            import weakref

            weakref.finalize(model, cache.release, *leased)
        return model


class NxDModel:
    """Runtime container with shape-keyed routing (reference ``NxDModel``:
    ``router``, ``forward``, ``save``, ``load``, ``init_state``)."""

    FORMAT_VERSION = 3

    def __init__(self, artifacts: Dict[Tuple[str, int], TraceArtifacts],
                 device: DeviceLike = None):
        self._artifacts = artifacts
        self.device = torch.device(device) if device is not None else None
        # populated by load() from the bundle
        self.params: Any = None
        self.state_spec: Optional[dict] = None
        self.generation_config: Optional[dict] = None
        self._state = None

    def keys(self) -> List[str]:
        return sorted({k for k, _ in self._artifacts})

    def router(self, key: str, args) -> TraceArtifacts:
        """Pick the bucket whose shapes fit ``args``: an exact match, else
        the *smallest-volume* bucket with every dim >= (insertion order
        does not matter)."""
        flat_in = [_shape(x) for x in pytree.tree_leaves(
            _canonical(tuple(args)))]
        candidates = []
        for (k, bi), art in sorted(self._artifacts.items(),
                                   key=lambda kv: kv[0]):
            if k != key:
                continue
            flat_b = [tuple(x.shape) for x in art.leaves]
            if flat_b == flat_in:
                return art
            if len(flat_b) == len(flat_in) and all(
                    len(a) == len(b) and all(x >= y for x, y in zip(a, b))
                    for a, b in zip(flat_b, flat_in)):
                volume = sum(math.prod(s) for s in flat_b)
                candidates.append((volume, art))
        if candidates:
            return min(candidates, key=lambda c: c[0])[1]
        raise KeyError(
            f"no bucket of {key!r} fits shapes {flat_in}; "
            f"available keys: {self.keys()}")

    def forward(self, key: str, *args, pad_inputs: bool = False):
        """Run the matching bucket's captured step (capturing it at the
        first call of a loaded bundle).

        A shape mismatch with the routed bucket raises by default. With
        ``pad_inputs=True`` inputs are right-padded with zeros up to the
        bucket shapes; outputs then come back at the *bucket* shape (the
        caller owns slicing)."""
        args = _canonical(tuple(args))
        art = self.router(key, args)
        flat_args, treedef = pytree.tree_flatten(args)
        flat_bucket = art.leaves
        if any(_shape(a) != tuple(b.shape)
               for a, b in zip(flat_args, flat_bucket)):
            if not pad_inputs:
                raise ValueError(
                    f"args shapes {[_shape(a) for a in flat_args]} do not "
                    f"exactly match bucket "
                    f"{[tuple(b.shape) for b in flat_bucket]} of {key!r} "
                    "(pass pad_inputs=True to zero-pad up to the bucket; "
                    "outputs then come back at the bucket shape)")
            flat_args = [
                torch.nn.functional.pad(a, [p for s, bs in reversed(list(
                    zip(a.shape, b.shape))) for p in (0, bs - s)])
                if _shape(a) != tuple(b.shape) else a
                for a, b in zip(flat_args, flat_bucket)]
            args = pytree.tree_unflatten(flat_args, treedef)
        if art.compiled is None:
            art.compiled = _Program(art.fn, args)
        return art.compiled(flat_args)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str, params: Any = None,
             state_spec: Optional[dict] = None,
             generation_config: Optional[dict] = None,
             param_specs: Any = None,
             serialize_compiled: bool = True) -> None:
        """Write the serving bundle: a zip of ``manifest.json`` (the
        reference's fields, ``torch_version`` in place of ``jax_version``)
        and one raw ``weight_<j>.bin`` per tensor of ``params`` (nested
        dicts of tensors). Each artifact names its function by import path;
        a lambda or a closure raises. ``param_specs`` (the sharded weight
        store) is refused: the port runs one device. A captured graph
        cannot be serialized, so ``serialize_compiled`` packs nothing."""
        if param_specs is not None:
            raise NotImplementedError(
                "NxDModel.save(param_specs=...): the sharded weight store "
                "waits for the port's parallel substrate; save replicated "
                "weights inline (param_specs=None)")
        manifest, weights = [], []
        for i, ((key, bi), art) in enumerate(
                sorted(self._artifacts.items(), key=lambda kv: kv[0])):
            if art.ref is None:
                raise ValueError(
                    f"cannot save artifact {key!r}: its function "
                    f"{getattr(art.fn, '__qualname__', art.fn)!r} is a "
                    "lambda or a closure, or not registered; a bundle "
                    "names its functions by import path, so register a "
                    "module-level function with bundle_function (or pass a "
                    "functools.partial of one with JSON arguments)")
            manifest.append({
                "key": key, "bucket_index": bi, "artifact": i,
                "function": art.ref, "fingerprint": art.fingerprint,
                "tree": pytree.treespec_dumps(art.bucket[0]),
                "leaves": [{"shape": list(x.shape), "dtype": x.dtype}
                           if x.dtype is not None else
                           {"shape": [], "value": x.value}
                           for x in art.leaves]})
        with zipfile.ZipFile(path, "w") as z:
            if params is not None:
                for j, (keypath, t) in enumerate(_leaves_with_paths(params)):
                    host = t.detach().to("cpu").contiguous()
                    fname = f"weight_{j}.bin"
                    with z.open(fname, "w", force_zip64=True) as fh:
                        fh.write(host.reshape(-1).view(torch.uint8)
                                 .numpy().data)
                    weights.append({"path": keypath, "file": fname,
                                    "dtype": _dtype_name(t.dtype),
                                    "shape": list(t.shape)})
            z.writestr("manifest.json", json.dumps(
                {"version": self.FORMAT_VERSION,
                 "torch_version": torch.__version__,
                 "artifacts": manifest,
                 "weights": weights,
                 "weights_store": None,
                 "mesh": None,
                 "state_spec": state_spec,
                 "generation_config": generation_config}))
        logger.info("saved NxDModel to %s", path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None,
             trust_packaged_executables: bool = False) -> "NxDModel":
        """Load a serving bundle onto ``device`` (None: the card). Each
        artifact's function is looked up among the registered bundle
        functions (:func:`bundle_function`) and must have the source it was
        saved with; each bucket is captured at its first call.
        ``trust_packaged_executables`` is refused: the port's bundle
        carries no executable."""
        if trust_packaged_executables:
            raise NotImplementedError(
                "NxDModel.load(trust_packaged_executables=True): the "
                "PyTorch port's bundle carries no executable (a captured "
                "CUDA graph cannot be serialized); each bucket is captured "
                "at its first call")
        dev = resolve_device(device)
        artifacts: Dict[Tuple[str, int], TraceArtifacts] = {}
        with zipfile.ZipFile(path) as z:
            manifest = json.loads(z.read("manifest.json"))
            if manifest.get("version") != cls.FORMAT_VERSION or (
                    "torch_version" not in manifest):
                raise ValueError(
                    f"unsupported NxDModel format {manifest.get('version')} "
                    "(not a bundle of the PyTorch port)")
            for item in manifest["artifacts"]:
                fp = item["fingerprint"]
                fn = _fn_from_ref(item["function"], fp, item["key"])
                leaves = [LeafSpec(tuple(x["shape"]), x.get("dtype"),
                                   x.get("value")) for x in item["leaves"]]
                artifacts[(item["key"], item["bucket_index"])] = (
                    TraceArtifacts(
                        key=item["key"],
                        bucket=(pytree.treespec_loads(item["tree"]), leaves),
                        fn=fn, ref=item["function"], fingerprint=fp))
            params = None
            if manifest.get("weights"):
                flat = {}
                for w in manifest["weights"]:
                    dtype = _torch_dtype(w["dtype"])
                    raw = torch.empty(z.getinfo(w["file"]).file_size,
                                      dtype=torch.uint8)
                    with z.open(w["file"]) as fh:
                        if fh.readinto(raw.numpy()) != raw.numel():
                            raise ValueError(f"{w['file']}: short read")
                    flat[w["path"]] = raw.view(dtype).reshape(
                        w["shape"]).to(dev)
                params = _unflatten_paths(flat)
        model = cls(artifacts, dev)
        model.params = params
        model.state_spec = manifest.get("state_spec")
        model.generation_config = manifest.get("generation_config")
        return model

    def init_state(self):
        """Empty KV state from the packaged spec (reference
        ``StateInitializer``): ``kind: "paged"`` builds the block pool of
        :mod:`.paging` (int8 with ``quantized: true``), else the contiguous
        cache, whose write index is a device scalar. The model keeps one
        state: a later call resets it and returns it again, so the steps
        captured over it run on it in place."""
        if not getattr(self, "state_spec", None):
            raise ValueError("bundle was saved without a state_spec")
        if self._state is not None:
            _reset_state(self._state)
            return self._state
        spec = dict(self.state_spec)
        kind = spec.pop("kind", "contiguous")
        dev = self.device or resolve_device(None)
        if kind == "paged":
            if spec.pop("quantized", False):
                spec.pop("dtype", None)
                state = init_quantized_paged_kv_cache(**spec, device=dev)
            else:
                spec["dtype"] = _torch_dtype(spec.get("dtype", "bfloat16"))
                state = init_paged_kv_cache(**spec, device=dev)
        elif kind == "contiguous":
            spec["dtype"] = _torch_dtype(spec.get("dtype", "bfloat16"))
            state = _canonical(init_kv_cache(**spec, device=dev))
        else:
            raise ValueError(f"unknown state_spec kind: {kind!r}")
        self._state = state
        return state


def _reset_state(cache) -> None:
    """A cache back to empty, in place."""
    for name in ("k", "v"):
        getattr(cache, name).zero_()
    for name in ("k_scale", "v_scale"):
        t = getattr(cache, name, None)
        if t is not None:
            t.fill_(1)
    cache.pos.fill_(PAD_POSITION)
    if isinstance(cache, PagedKVCache):
        cache.block_tables.fill_(-1)
        cache.lengths.zero_()
    else:
        cache.index.zero_()


def _leaves_with_paths(tree, prefix: str = ""):
    """``(path, tensor)`` of nested dicts in sorted key order, the path
    joined with ``/`` (the reference's manifest paths)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    if not isinstance(tree, dict):
        raise ValueError("bundled params must be nested dicts of tensors "
                         f"(got {type(tree).__name__})")
    for k in sorted(tree):
        yield from _leaves_with_paths(tree[k], f"{prefix}/{k}" if prefix
                                      else str(k))


def _unflatten_paths(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


# ---------------------------------------------------------------------------
# Bundle functions: module-level, so that a bundle can name them
# ---------------------------------------------------------------------------

class _Bound(nn.Module):
    """Weightless models of the given configs, so that
    ``torch.func.functional_call`` can run a function over them with a
    state dict's tensors (``m<i>.<name>``)."""

    def __init__(self, models: Sequence[nn.Module], fn: Callable):
        super().__init__()
        for i, m in enumerate(models):
            self.add_module(f"m{i}", m)
        self.fn = fn
        self.n = len(models)

    def forward(self, *args, **kwargs):
        return self.fn(*(getattr(self, f"m{i}") for i in range(self.n)),
                       *args, **kwargs)


_META: Dict[Tuple[str, str], nn.Module] = {}


def _meta_model(cfg, device: torch.device) -> nn.Module:
    """A weightless serving model of ``cfg`` (one per config and device:
    its rope tables, made at the first call, stay where a captured step
    reads them)."""
    from ..models import family_of

    key = (repr(cfg), str(device))
    m = _META.get(key)
    if m is None:
        _, cls = family_of(cfg)
        m = _META[key] = cls(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                             device="meta").requires_grad_(False)
    return m


def _call_with(fn: Callable, cfgs: Sequence[Any],
               params: Sequence[Dict[str, torch.Tensor]], *args, **kwargs):
    """``fn(*models, *args, **kwargs)``, model i being ``cfgs[i]``'s with
    ``params[i]``'s tensors (no copy)."""
    dev = next(iter(params[0].values())).device
    bound = _Bound([_meta_model(c, dev) for c in cfgs], fn)
    tensors = {f"m{i}.{k}": v for i, p in enumerate(params)
               for k, v in p.items()}
    return torch.func.functional_call(bound, tensors, args, kwargs)


@bundle_function
def cached_step(params: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                positions: torch.Tensor, cache, *, model_cfg):
    """The contiguous-cache step of a bundle (``"context_encoding"`` and
    ``"token_generation"``): ``(params, input_ids [B, S], positions [B, S],
    cache) -> (logits [B, S, V], cache)``, the model family's cached
    forward."""
    from .engine import _family

    _, forward = _family(model_cfg)
    return _call_with(forward, [model_cfg], [params], input_ids, positions,
                      cache)


@bundle_function
def paged_worker(params: Dict[str, torch.Tensor], cache,
                 tokens: torch.Tensor, positions: torch.Tensor,
                 slot_ids: torch.Tensor, *, model_cfg):
    """A serving worker over the paged pool: ``(params, cache, tokens [1,
    W], positions [1, W], slot_ids [W]) -> (logits [1, W, V], cache)``."""
    from .engine import _family

    _, forward = _family(model_cfg)
    return _call_with(forward, [model_cfg], [params], tokens, positions,
                      cache, slot_ids=slot_ids)


@bundle_function
def image_encoder(params: Dict[str, torch.Tensor],
                  pixel_values: torch.Tensor, *, model_cfg):
    """The ViT classifier of a bundle (``"image_encoder"``): ``(params,
    pixel_values [B, C, H, W]) -> fp32 logits [B, num_labels]``."""
    with torch.no_grad():
        return _call_with(lambda model, px: model(px), [model_cfg], [params],
                          pixel_values)


@bundle_function
def speculation_round(target_params: Dict[str, torch.Tensor],
                      draft_params: Dict[str, torch.Tensor], tcache, dcache,
                      committed: torch.Tensor, pos: torch.Tensor,
                      filled: torch.Tensor, out: torch.Tensor, *,
                      model_cfg, draft_cfg, speculation_length: int,
                      max_new_tokens: int):
    """One speculative round as a bundle key (``"speculation"``):
    :func:`.speculative.make_speculation_round_fn` over the two models."""
    from .engine import _family
    from .speculative import make_speculation_round_fn

    _, forward = _family(model_cfg)
    _, draft_forward = _family(draft_cfg)

    def run(model, draft, *args):
        return make_speculation_round_fn(
            model, draft, speculation_length, max_new_tokens, forward,
            draft_forward)(*args)

    return _call_with(run, [model_cfg, draft_cfg],
                      [target_params, draft_params], tcache, dcache,
                      committed, pos, filled, out)


def bundle_generate(model: NxDModel, input_ids, prompt_len,
                    max_new_tokens: int) -> torch.Tensor:
    """Greedy generation driven from a loaded bundle alone: programs,
    weights, KV state and generation config come from the zip.

    Bundle protocol: key ``"context_encoding"`` has signature ``(params,
    input_ids [B, S], positions [B, S], cache) -> (logits, cache)`` and
    ``"token_generation"`` the same at S=1 (:func:`cached_step`)."""
    from .generation import pick_bucket

    if model.params is None:
        raise ValueError("bundle carries no weights; re-save with params=")
    gc = model.generation_config or {}
    dev = model.device
    input_ids = torch.from_numpy(np.array(input_ids, np.int32)).to(dev)
    prompt_len = torch.from_numpy(np.array(prompt_len, np.int32)).to(dev)
    b, s = input_ids.shape
    bucket = pick_bucket(s, gc.get("buckets", (s,)))
    if bucket > s:
        input_ids = torch.nn.functional.pad(input_ids, (0, bucket - s))
    cache = model.init_state()
    ar = torch.arange(bucket, dtype=torch.int32, device=dev).expand(b,
                                                                   bucket)
    positions = torch.where(ar < prompt_len[:, None], ar,
                            torch.full_like(ar, PAD_POSITION))
    logits, cache = model.forward("context_encoding", model.params,
                                  input_ids, positions, cache)
    last = logits[torch.arange(b, device=dev), prompt_len.long() - 1]
    toks = []
    for t in range(max_new_tokens):
        tok = torch.argmax(last, dim=-1)
        toks.append(tok)
        if t == max_new_tokens - 1:
            break  # the last token needs no further forward
        pos = (prompt_len + t)[:, None]
        logits, cache = model.forward("token_generation", model.params,
                                      tok[:, None].to(torch.int32), pos,
                                      cache)
        last = logits[:, 0]
    return torch.stack(toks, dim=1)


def bundle_speculative_generate(model: NxDModel, input_ids, prompt_len,
                                max_new_tokens: int) -> torch.Tensor:
    """Greedy draft-model speculative decoding driven from a loaded
    bundle. Keys: ``"context_encoding"`` and ``"draft_context_encoding"``
    (:func:`cached_step` per model) and ``"speculation"``
    (:func:`speculation_round`); ``params`` saved as ``{"target": ...,
    "draft": ...}``; ``generation_config`` with ``speculation_length``,
    ``buckets`` and ``draft_state_spec``. The output equals the target's
    own greedy decoding."""
    from .generation import pick_bucket

    if model.params is None or "target" not in model.params:
        raise ValueError(
            'speculative bundles carry params={"target":..., "draft":...}')
    gc = model.generation_config or {}
    k = int(gc["speculation_length"])
    tp_, dp_ = model.params["target"], model.params["draft"]
    dev = model.device
    input_ids = torch.from_numpy(np.array(input_ids, np.int32)).to(dev)
    prompt_len = torch.from_numpy(np.array(prompt_len, np.int32)).to(dev)
    b, s = input_ids.shape
    bucket = pick_bucket(s, gc.get("buckets", (s,)))
    if bucket > s:
        input_ids = torch.nn.functional.pad(input_ids, (0, bucket - s))
    tcache = model.init_state()
    dspec = dict(gc["draft_state_spec"])
    dspec["dtype"] = _torch_dtype(dspec.get("dtype", "bfloat16"))
    dcache = _canonical(init_kv_cache(**dspec, device=dev))
    ar = torch.arange(bucket, dtype=torch.int32, device=dev).expand(b,
                                                                   bucket)
    positions = torch.where(ar < prompt_len[:, None], ar,
                            torch.full_like(ar, PAD_POSITION))
    tlogits, tcache = model.forward("context_encoding", tp_, input_ids,
                                    positions, tcache)
    _, dcache = model.forward("draft_context_encoding", dp_, input_ids,
                              positions, dcache)
    rows = torch.arange(b, device=dev)
    committed = torch.argmax(tlogits[rows, prompt_len.long() - 1],
                             dim=-1).to(torch.int32)
    out = torch.zeros((b, max_new_tokens + k + 1), dtype=torch.int32,
                      device=dev)
    out[:, 0] = committed
    filled = torch.ones((b,), dtype=torch.int32, device=dev)
    pos = prompt_len
    while int(filled.min()) < max_new_tokens:
        (tcache, dcache, committed, pos, filled, out, _) = model.forward(
            "speculation", tp_, dp_, tcache, dcache, committed, pos,
            filled, out)
    return out[:, :max_new_tokens]


def serving_state_spec(model_cfg, engine_cfg) -> Dict[str, Any]:
    """The ``state_spec`` of a :class:`~.engine.ServingEngine`'s paged
    block pool, for ``NxDModel.save(state_spec=...)``: a bundle's
    :meth:`NxDModel.init_state` rebuilds exactly the pool the engine
    served from (``kind: "paged"``, optionally ``quantized``)."""
    spec: Dict[str, Any] = {
        "kind": "paged",
        "num_layers": model_cfg.num_layers,
        "num_blocks": max(1, getattr(engine_cfg, "cp", 1))
        * engine_cfg.num_blocks,
        "block_size": engine_cfg.block_size,
        "num_kv_heads": model_cfg.num_kv_heads,
        "head_dim": model_cfg.head_dim_,
        "max_slots": engine_cfg.max_slots,
        "max_blocks_per_seq": engine_cfg.max_blocks_per_seq,
    }
    if engine_cfg.quantized:
        spec["quantized"] = True
    else:
        spec["dtype"] = _dtype_name(engine_cfg.kv_dtype or model_cfg.dtype)
    return spec


def register_serving_workers(builder: ModelBuilder, model_cfg, engine_cfg,
                             params: Dict[str, torch.Tensor],
                             device: DeviceLike = None) -> ModelBuilder:
    """Register the disaggregated serving workers as keys:
    ``"chunked_prefill"`` (width ``prefill_budget`` or ``token_budget``,
    the priority model) and ``"token_decode"`` (width ``max_slots``) over
    one paged pool, the two fixed-shape steps a disaggregated
    :class:`~.engine.ServingEngine` runs (:func:`paged_worker`). ``params``
    (a state dict) is moved to ``device`` in the serving dtypes once
    (quantized first under ``engine_cfg.weight_quant``); the example
    batches are all pad rows. ``cp > 1`` (the long-context tier) is
    refused."""
    from ..quantization.serving import quantize_params_for_serving
    from .engine import _family

    e, m = engine_cfg, model_cfg
    if int(getattr(e, "cp", 1)) > 1:
        raise NotImplementedError(
            "register_serving_workers with cp > 1: the long-context tier "
            "needs context-parallel engines, which the PyTorch port does "
            "not have yet")
    dev = resolve_device(device)
    wq = getattr(e, "weight_quant", None)
    if wq is not None:
        if getattr(m, "weight_quant", None) != wq:
            model_cfg = m = dataclasses.replace(m, weight_quant=wq)
        params = quantize_params_for_serving(m, params)
    family, _ = _family(m)
    params = dict(family.build_model(m, params, dev).state_dict())
    if e.quantized:
        cache = init_quantized_paged_kv_cache(
            m.num_layers, e.num_blocks, e.block_size, m.num_kv_heads,
            m.head_dim_, e.max_slots, e.max_blocks_per_seq, device=dev)
    else:
        cache = init_paged_kv_cache(
            m.num_layers, e.num_blocks, e.block_size, m.num_kv_heads,
            m.head_dim_, e.max_slots, e.max_blocks_per_seq,
            dtype=e.kv_dtype or m.dtype, device=dev)
    worker = functools.partial(paged_worker, model_cfg=m)

    def _args(width: int):
        return (params, cache,
                torch.zeros((1, width), dtype=torch.int32, device=dev),
                torch.full((1, width), PAD_POSITION, dtype=torch.int32,
                           device=dev),
                torch.full((width,), e.max_slots, dtype=torch.int32,
                           device=dev))

    builder.add("chunked_prefill", worker,
                [_args(e.prefill_budget or e.token_budget)],
                priority_model=True)
    builder.add("token_decode", worker, [_args(e.max_slots)])
    return builder


def register_image_encoder(builder: ModelBuilder, model_cfg,
                           params: Dict[str, torch.Tensor],
                           buckets: Sequence[int],
                           device: DeviceLike = None) -> ModelBuilder:
    """Register a ViT classifier as ``"image_encoder"`` (the priority
    model), one batch bucket each (:func:`image_encoder`), as the
    reference's ``examples/inference/vit_serve.py`` does. ``params`` (a
    state dict) is moved to ``device`` in ``model_cfg.dtype`` once and
    bound; one already there (``init_state_dict(replace(cfg,
    param_dtype=cfg.dtype))``) is bound as it is, and passing it to
    ``forward`` copies nothing. The example batches are zeros in fp32.
    Serve a batch with ``forward("image_encoder", params, pixel_values,
    pad_inputs=True)``: it runs the tightest bucket, and the logits come
    back at the bucket's batch."""
    from ..models.vit import build_model

    dev = resolve_device(device)
    params = dict(build_model(model_cfg, params, dev).state_dict())
    shape = (model_cfg.num_channels, model_cfg.image_size,
             model_cfg.image_size)
    builder.add("image_encoder",
                functools.partial(image_encoder, model_cfg=model_cfg),
                [(params, torch.zeros((b,) + shape, device=dev))
                 for b in sorted(set(buckets))], priority_model=True)
    return builder


def shard_checkpoint(params: Any, param_specs: Any) -> Any:
    """Place ``params`` per ``param_specs`` (a tree like ``params`` whose
    leaves are ``None`` or a tuple of ``None``: replicated). On one device
    a replicated placement is ``params`` as they are; any sharded spec is
    refused until the port's parallel substrate exists."""
    def check(spec):
        if spec is not None and any(p is not None for p in spec):
            raise NotImplementedError(
                f"shard_checkpoint with spec {spec!r}: sharded placement "
                "waits for the port's parallel substrate; only replicated "
                "specs (None) are accepted")
    for spec in pytree.tree_leaves(param_specs, is_leaf=lambda s: s is None
                                   or isinstance(s, tuple)):
        check(spec)
    return params
