"""Silent-data-corruption (SDC) defense: parameter fingerprints
(counterpart of ``neuronx_distributed_tpu/resilience/integrity.py``; the
same fold, the same constants and the same bits).

* **On-device fingerprints** — :func:`fingerprint_array` folds the raw
  bits of a tensor (a 32-bit word per element) into a small int32 digest
  with tensor ops on the tensor's own device, so the train step computes
  it at a cadence ``integrity_every=K`` (``make_train_step``) without
  copying the parameters to the host. :func:`fingerprint_array_np` is the
  bit-exact host (numpy) mirror, to verify host copies (checkpoint
  payloads, KV-session tickets) without touching the device.
* **Cross-dp-replica consensus** — :func:`majority_vote` over an
  ``[replicas, n_leaves]`` fingerprint matrix localizes a divergent
  replica; :func:`dp_consensus_fingerprints` all-gathers it over the
  data-parallel group (one row on one rank).
* **Sharded fingerprints** — :func:`fingerprint_tree_sharded` gives the
  whole tensors' fingerprints from their tensor-parallel shards, bit for
  bit, without gathering them: the fold is an add mod 2**32 of
  position-weighted words, so each rank folds its shard at its global
  positions and the sums add over tp before the avalanche.
* **Wire spot checks** — :func:`payload_fingerprint` digests an encoded
  payload ``(q, scales)``.

:class:`IntegrityMonitor` wires detection into the training loop: at each
cadence boundary it compares the step-reported fingerprint against an
independent recompute over the live parameters, emits an
``integrity_mismatch`` obs event on divergence, and hands the mismatch to
the :class:`~.watchdog.Watchdog`'s discipline (``report_anomaly``: a
``rewind`` restores the newest content-verified checkpoint). The chaos
``bitflip`` fault kind drives deterministic drills end to end.

PyTorch has no full uint32 arithmetic, so the fold works on int32 words:
floats are widened to fp32 and viewed as int32, other types converted to
int32 (wrapping as numpy's ``astype(uint32)`` does); products and xors in
int32 wrap mod 2**32 and keep the low 32 bits of the uint32 result; the
sum runs in int64 and is masked to 32 bits; the avalanche's right shifts
run on that masked, non-negative int64, so they are logical shifts, and
its products are split into 16-bit halves so that no int64 product
overflows. Large leaves are folded in chunks of :data:`CHUNK` elements
(each chunk's word positions carried by its offset), so the temporaries
stay a few hundred MB whatever the leaf's size.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..obs.events import emit_event
from ..obs.metrics import get_registry
from ..parallel import mesh as ps
from ..utils.bfloat16 import is_bf16, widen_to_fp32_words
from ..utils.logger import get_logger

logger = get_logger(__name__)

# Odd multiplicative constants (Knuth / splitmix-style). The fold is
# position-weighted so permutations don't cancel, and avalanched so a
# single flipped bit flips ~half the digest. Not cryptographic — SDC is
# random, not adversarial.
_C_WORD = 2654435761   # 0x9E3779B1
_C_POS = 2654435769    # 0x9E3779B9
_C_MIX1 = 2246822519   # 0x85EBCA77
_C_MIX2 = 3266489917   # 0xC2B2AE3D
_MASK = 0xFFFFFFFF

#: elements folded at a time: the int32 words, their products and the
#: positions of one chunk take about 16 bytes an element (256 MB)
CHUNK = 1 << 24


def _signed32(c: int) -> int:
    """The int32 whose bits are the uint32 ``c``."""
    return c - (1 << 32) if c >= 1 << 31 else c


class IntegrityError(RuntimeError):
    """An integrity fingerprint mismatch that no recovery policy absorbed
    (no watchdog to rewind through, or a corrupted KV-session ticket)."""


# ---------------------------------------------------------------------------
# device-side (torch) fingerprints
# ---------------------------------------------------------------------------


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 words of the reference's uint32 view: floats widened
    to fp32 (exact for bf16/fp16/fp32 — a flipped mantissa or exponent bit
    survives the widening) and their bits viewed as int32; bools and ints
    converted (wrapping) to int32."""
    if x.is_floating_point():
        return x.float().view(torch.int32)
    return x.to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for a non-negative int64 ``a < 2**32`` and a
    uint32 constant, in 16-bit halves of ``c`` so no product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _pos_terms(n: int, dev: torch.device) -> torch.Tensor:
    """``(i + 1) C_POS mod 2**32`` as int32 for ``i < n`` (n at most
    :data:`CHUNK`, 64 MB)."""
    pos = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    return _to_int32(_mul32(pos, _C_POS))


def _fold(x: torch.Tensor, blocks: int,
          pos_term: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's fold of ``x``'s words into ``blocks`` words, each
    the avalanche of ``sum_j (w_j C_WORD) ^ (j C_POS) ^ n`` over its
    contiguous slice (j from 1), as masked non-negative int64.
    ``pos_term``: :func:`_pos_terms` on ``x``'s device, at least one chunk
    long, to share between the leaves of a tree."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % blocks
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    width = flat.numel() // blocks
    rows = flat.view(blocks, width)
    dev = x.device
    h = torch.zeros(blocks, dtype=torch.int64, device=dev)
    c_word = torch.tensor(_signed32(_C_WORD), dtype=torch.int32, device=dev)
    if pos_term is None or pos_term.numel() < min(width, CHUNK):
        pos_term = _pos_terms(min(width, CHUNK), dev)
    for j0 in range(0, width, CHUNK):
        j1 = min(width, j0 + CHUNK)
        words = _as_words(rows[:, j0:j1])
        # (j0 + i + 1) C_POS = (i + 1) C_POS + j0 C_POS  (mod 2**32)
        pos = pos_term[:j1 - j0] + _signed32(j0 * _C_POS & _MASK)
        mixed = (words * c_word) ^ pos
        h += mixed.sum(dim=1, dtype=torch.int64)
    h = (h & _MASK) ^ (n & _MASK)
    h = _mul32(h ^ (h >> 15), _C_MIX1)
    h = _mul32(h ^ (h >> 13), _C_MIX2)
    return h ^ (h >> 16)


def _to_int32(h: torch.Tensor) -> torch.Tensor:
    """Masked non-negative int64 words -> the int32 with the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def fingerprint_array(x: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """Blockwise int32 fingerprint of ``x``'s raw bits, on ``x``'s device.
    Returns an ``int32[blocks]`` tensor; element ``b`` digests the ``b``-th
    contiguous slice of the flattened tensor, localizing corruption to a
    block. Empty tensors fingerprint as ``blocks`` zero words."""
    return _fingerprint(x, blocks)


def _fingerprint(x: torch.Tensor, blocks: int,
                 pos_term: Optional[torch.Tensor] = None) -> torch.Tensor:
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    x = x.detach()
    if x.numel() == 0:
        x = torch.zeros(blocks, dtype=torch.int32, device=x.device)
    return _to_int32(_fold(x, blocks, pos_term))


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a dict (in its order), a list or tuple, or a tensor."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"cannot fingerprint a {type(tree).__name__}")


def fingerprint_tree(tree: Any) -> torch.Tensor:
    """Per-leaf scalar fingerprints, stacked into an ``int32[n_leaves]``
    tensor. The leaf order is the tree's own: for the train state's
    ``params``, the model's parameter order, one leaf per layer (the
    reference's scanned tree stacks the layers, so its vector has other
    leaves)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(0, dtype=torch.int32)
    # the position terms of one chunk, made once for every leaf on the
    # device of the largest
    big = max(leaves, key=lambda t: t.numel())
    pos_term = _pos_terms(max(1, min(big.numel(), CHUNK)), big.device)
    return torch.cat([_fingerprint(
        leaf, 1, pos_term if leaf.device == big.device else None)
        for leaf in leaves])


def _shard_fold_sum(x: torch.Tensor, shape: Tuple[int, ...], dim: int,
                    offset: int, pos_term: torch.Tensor,
                    base: int = 0) -> torch.Tensor:
    """The int64 sum (unmasked) of the fold's terms ``(w_j C_WORD) ^ (j
    C_POS)`` over the elements of ``x``, the slice ``[offset, offset +
    x.shape[dim])`` along ``dim`` of a tensor of ``shape``, each at its
    flat position ``j`` (from 1) in that whole tensor, shifted by ``base``
    (a tensor of ``shape`` that is itself a run of a larger one). Viewed
    as ``[A, L x Bk]``, row ``a`` of the slice is one contiguous run of
    the whole tensor, from ``base + a x D x Bk + offset x Bk``."""
    a = int(np.prod(shape[:dim], dtype=np.int64))
    bk = int(np.prod(shape[dim + 1:], dtype=np.int64))
    width = x.shape[dim] * bk
    rows = x.detach().reshape(a, width)
    dev = x.device
    starts = (torch.arange(a, dtype=torch.int64, device=dev)
              * (shape[dim] * bk) + offset * bk + base) & _MASK
    start_terms = _to_int32(_mul32(starts, _C_POS))
    c_word = torch.tensor(_signed32(_C_WORD), dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    per = max(1, CHUNK // max(width, 1))
    for r0 in range(0, a, per):
        r1 = min(a, r0 + per)
        for j0 in range(0, width, CHUNK):
            j1 = min(width, j0 + CHUNK)
            words = _as_words(rows[r0:r1, j0:j1])
            pos = (pos_term[:j1 - j0][None, :] + start_terms[r0:r1, None]
                   + _signed32(j0 * _C_POS & _MASK))
            total += ((words * c_word) ^ pos).sum(dtype=torch.int64)
    return total


def fingerprint_tree_sharded(tree: Mapping[str, torch.Tensor],
                             specs: Mapping[str, Tuple]) -> torch.Tensor:
    """:func:`fingerprint_tree` of the whole tensors whose shards the
    ranks of the tp axis (and of the ep axis, for an expert bank sharded
    over it on its first dim) hold, bit for bit, without gathering them:
    each rank folds its shard at the shard's positions in the whole
    tensor, the int64 sums add over tp and ep (one all-reduce of
    ``int64[n_leaves]`` each), and every rank applies the avalanche.
    ``specs[name]`` is the leaf's partition spec (per dim ``"tp"``,
    ``"ep"`` or not); a leaf whole on an axis, or one missing from
    ``specs``, is folded by that axis's rank 0 alone. The result is the
    same on every rank; at tp = ep = 1 it is :func:`fingerprint_tree`."""
    from ..parallel import comm

    axis = ps.TP_AXIS
    size = comm.axis_size(axis)
    ep = comm.axis_size(ps.EP_AXIS)
    if size == 1 and ep == 1:
        return fingerprint_tree(tree)
    rank = ps.axis_rank(axis) if size > 1 else 0
    ep_rank = ps.axis_rank(ps.EP_AXIS) if ep > 1 else 0
    leaves = list(tree.items())
    dev = leaves[0][1].device
    big = max(t.numel() for _, t in leaves)
    pos_term = _pos_terms(max(1, min(big, CHUNK)), dev)
    sums, counts = [], []
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for name, t in leaves:
        spec = tuple(specs.get(name, ()))
        dim = next((d for d, a in enumerate(spec) if a == axis), None)
        if size == 1:
            dim = None
        on_ep = ep > 1 and ps.EP_AXIS in spec
        if on_ep and spec.index(ps.EP_AXIS) != 0:
            raise ValueError(f"{name}: an ep-sharded leaf is sharded on "
                             "its first dim")
        # the block this ep rank holds whole over tp, a run of the tensor
        shape = list(t.shape)
        if dim is not None:
            shape[dim] *= size
        block = int(np.prod(shape, dtype=np.int64))
        whole = list(shape)
        if on_ep:
            whole[0] *= ep
        if (dim is None and rank != 0) or (not on_ep and ep_rank != 0):
            part = zero
        elif dim is None:
            part = _shard_fold_sum(t, tuple(shape), 0, 0, pos_term,
                                   ep_rank * block if on_ep else 0)
        else:
            part = _shard_fold_sum(t, tuple(shape), dim,
                                   rank * t.shape[dim], pos_term,
                                   ep_rank * block if on_ep else 0)
        sums.append(part.to(dev))
        counts.append(int(np.prod(whole, dtype=np.int64)))
    total = comm.all_reduce(comm.all_reduce(torch.stack(sums), axis),
                            ps.EP_AXIS)
    n = torch.tensor([c & _MASK for c in counts], dtype=torch.int64,
                     device=dev)
    return _to_int32(_avalanche(total, n))


def fingerprint_tree_stages(tree: Mapping[str, torch.Tensor],
                            specs: Mapping[str, Tuple],
                            names: List[str]) -> torch.Tensor:
    """:func:`fingerprint_tree` of the whole model whose parameters
    ``names`` (in the model's order) the pipeline stages hold: ``tree``
    is the part this rank's stage counts, each leaf a shard over tp (or
    over ``(pp, tp)``, a ``vocab_pp`` table) or whole. Each rank folds its
    shards at their positions in the whole tensors into its leaves' slots
    of an ``int64[len(names)]`` vector, the vector is summed over tp and
    pp, and every rank applies the avalanche: the same vector on every
    rank, equal to one process's over the whole tensors."""
    from ..parallel import comm

    tp = comm.axis_size(ps.TP_AXIS)
    tp_rank = ps.axis_rank(ps.TP_AXIS) if tp > 1 else 0
    index = {n: i for i, n in enumerate(names)}
    leaves = list(tree.items())
    dev = leaves[0][1].device
    big = max(t.numel() for _, t in leaves)
    pos_term = _pos_terms(max(1, min(big, CHUNK)), dev)
    sums = torch.zeros(len(names), dtype=torch.int64, device=dev)
    counts = torch.zeros(len(names), dtype=torch.int64, device=dev)
    for name, t in leaves:
        spec = tuple(specs.get(name, ()))
        dim = next((d for d, a in enumerate(spec)
                    if a in (ps.TP_AXIS, ps.PP_TP_AXES)), None)
        shape = list(t.shape)
        if dim is None:
            if tp_rank == 0:
                sums[index[name]] = _shard_fold_sum(t, tuple(shape), 0, 0,
                                                    pos_term)
        else:
            axis = spec[dim]
            shape[dim] *= comm.axis_size(axis)
            sums[index[name]] = _shard_fold_sum(
                t, tuple(shape), dim, ps.axis_rank(axis) * t.shape[dim]
                if comm.axis_size(axis) > 1 else 0, pos_term)
        counts[index[name]] = int(np.prod(shape, dtype=np.int64)) & _MASK
    for axis in (ps.TP_AXIS, ps.PP_AXIS):
        sums = comm.all_reduce(sums, axis)
        counts = comm.all_reduce(counts, axis, op="max")
    return _to_int32(_avalanche(sums, counts))


def _avalanche(h: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The fold's finish on the int64 sums ``h`` of tensors of ``n``
    elements each (int64, masked): mask, xor the count, then the two
    multiply-xorshift rounds."""
    h = (h & _MASK) ^ n
    h = _mul32(h ^ (h >> 15), _C_MIX1)
    h = _mul32(h ^ (h >> 13), _C_MIX2)
    return h ^ (h >> 16)


def combine_fingerprints(fps: torch.Tensor) -> torch.Tensor:
    """Fold a vector of fingerprints into one scalar int32 (e.g. a whole
    param-tree digest, or a ``(q, scales)`` wire-payload pair)."""
    return fingerprint_array(torch.as_tensor(fps))[0]


def payload_fingerprint(q: torch.Tensor,
                        scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Scalar fingerprint of an encoded payload — digests the quantized
    words and (when present) the per-block scales, so a flipped bit in
    either is visible."""
    fp_q = fingerprint_array(q)
    if scales is None:
        return fp_q[0]
    return combine_fingerprints(
        torch.cat([fp_q, fingerprint_array(scales)]))


# ---------------------------------------------------------------------------
# host-side (numpy) mirror — bit-exact parity with the device fold
# ---------------------------------------------------------------------------


def _is_float_np(dtype: np.dtype) -> bool:
    # ml_dtypes' floats (bfloat16, float8_*) are not np.floating
    return (np.issubdtype(dtype, np.floating)
            or dtype.name.startswith(("bfloat16", "float8")))


def _as_words_np(x: np.ndarray) -> np.ndarray:
    if is_bf16(x):
        return widen_to_fp32_words(x)
    a = np.ascontiguousarray(x)
    if a.dtype == np.bool_:
        return a.astype(np.uint32).reshape(-1)
    if _is_float_np(a.dtype):
        return a.astype(np.float32).view(np.uint32).reshape(-1)
    with np.errstate(over="ignore"):
        return a.astype(np.uint32).reshape(-1)


def fingerprint_array_np(x: np.ndarray, blocks: int = 1) -> np.ndarray:
    """Host mirror of :func:`fingerprint_array`: same fold, same
    constants, bit-identical output, in numpy's uint32 arithmetic, a
    million words at a time (the temporaries stay in cache). A bf16
    tensor reaches numpy as its exact fp32 widening
    (``t.float().cpu().numpy()``), or as its raw words in a
    :class:`..utils.bfloat16.BF16Words` array, which folds the same."""
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    words = _as_words_np(np.asanyarray(x))
    if words.size == 0:
        words = np.zeros((blocks,), np.uint32)
    n = words.size
    pad = (-n) % blocks
    if pad:
        words = np.concatenate([words, np.zeros((pad,), np.uint32)])
    words = words.reshape(blocks, -1)
    width = words.shape[1]
    chunk = 1 << 20
    h = np.zeros((blocks,), np.uint32)
    with np.errstate(over="ignore"):
        pos = (np.arange(1, min(width, chunk) + 1, dtype=np.uint32)
               * np.uint32(_C_POS))
        for j0 in range(0, width, chunk):
            j1 = min(width, j0 + chunk)
            mixed = words[:, j0:j1] * np.uint32(_C_WORD)
            # (j0 + i + 1) C_POS = (i + 1) C_POS + j0 C_POS  (mod 2**32)
            mixed ^= pos[:j1 - j0] + np.uint32(j0 * _C_POS & _MASK)
            # dtype pinned: np.sum would widen uint32 to uint64 and break
            # bit-parity with the device fold's mod-2**32 wraparound
            h += np.add.reduce(mixed, axis=1, dtype=np.uint32)
        h ^= np.uint32(n & _MASK)
        h = (h ^ (h >> np.uint32(15))) * np.uint32(_C_MIX1)
        h = (h ^ (h >> np.uint32(13))) * np.uint32(_C_MIX2)
        h = h ^ (h >> np.uint32(16))
    return h.view(np.int32)


def fingerprint_blocks_np(arr: np.ndarray, axis: int) -> List[int]:
    """Per-slice fingerprints of a host array along ``axis`` (e.g. the
    block axis of an extracted KV payload): one int per block, so a
    corrupted shipped block is localized, not just detected."""
    moved = np.moveaxis(np.asanyarray(arr), axis, 0)
    return [int(fingerprint_array_np(moved[i])[0])
            for i in range(moved.shape[0])]


def kv_payload_fingerprints(payload: Dict[str, np.ndarray],
                            block_axes: Dict[str, int]
                            ) -> Dict[str, List[int]]:
    """Fingerprint every tensor of an extracted KV payload per block.
    ``block_axes`` maps payload key -> block axis."""
    return {name: fingerprint_blocks_np(arr, block_axes[name])
            for name, arr in payload.items()}


# ---------------------------------------------------------------------------
# cross-dp-replica consensus
# ---------------------------------------------------------------------------


def dp_consensus_fingerprints(tree: Any,
                              fps: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The ``int32[dp, n_leaves]`` matrix of every data-parallel replica's
    fingerprints, for :func:`majority_vote`: this replica's vector
    (``fps``, or :func:`fingerprint_tree` of ``tree``), all-gathered over
    the dp group (JAX ``resilience/integrity.py:295``), so every replica
    holds the whole matrix and the vote needs no leader. One row where
    there is one replica."""
    from ..parallel import comm

    if fps is None:
        fps = fingerprint_tree(tree)
    return comm.all_gather(fps[None], ps.DP_AXIS, 0)


def majority_vote(fp_matrix: Any) -> Tuple[np.ndarray,
                                           Dict[int, List[int]]]:
    """Majority vote over an ``[replicas, n_leaves]`` fingerprint matrix.

    Returns ``(consensus[n_leaves], divergent)`` where ``divergent`` maps
    replica index -> leaf indices disagreeing with the majority (ties
    blame every holdout — with 2 replicas you get detection but not
    localization)."""
    if isinstance(fp_matrix, torch.Tensor):
        fp_matrix = fp_matrix.cpu().numpy()
    fps = np.asarray(fp_matrix)
    if fps.ndim != 2:
        raise ValueError(f"expected [replicas, n_leaves], got {fps.shape}")
    n_rep, n_leaves = fps.shape
    consensus = np.empty((n_leaves,), fps.dtype)
    divergent: Dict[int, List[int]] = {}
    for col in range(n_leaves):
        values, counts = np.unique(fps[:, col], return_counts=True)
        maj = values[int(np.argmax(counts))]
        consensus[col] = maj
        for rep in np.nonzero(fps[:, col] != maj)[0]:
            divergent.setdefault(int(rep), []).append(col)
    return consensus, divergent


# ---------------------------------------------------------------------------
# training-loop monitor
# ---------------------------------------------------------------------------


def _metrics():
    reg = get_registry()
    return (
        reg.counter("nxd_integrity_checks_total",
                    "Integrity fingerprint verifications performed"),
        reg.counter("nxd_integrity_mismatch_total",
                    "Integrity fingerprint mismatches detected",
                    labels=("scope",)),
    )


class IntegrityMonitor:
    """Trainer callback closing the detection loop at cadence boundaries.

    ``make_train_step(integrity_every=K)`` fingerprints the updated
    parameters inside the step (metric ``integrity_fp``, filled on steps
    where ``step % K == 0``). At each boundary this callback
    re-fingerprints the live ``trainer.state.params`` and compares: the
    step-reported vector digests the parameters the step *wrote*, the
    recompute those the next step will *read* — corruption landing between
    the two surfaces as a mismatch within one cadence window. On mismatch
    it emits the ``integrity_mismatch`` obs event and hands recovery to
    the watchdog (``Watchdog.report_anomaly``; its ``rewind`` restores the
    newest content-verified checkpoint); without a watchdog it raises
    :class:`IntegrityError` (fail-stop beats training on garbage).

    ``chaos`` hooks the deterministic drill: at each boundary the plan is
    consulted at ``("integrity", "params")`` and a ``bitflip`` directive
    flips the seeded bit in the largest parameter *before* verification —
    corruption at rest between the step's write and the next read.

    Across ranks the recompute is the step's own fingerprint
    (``step.fingerprint``: the whole tensors', from their shards), the
    ranks agree on whether any of them saw a mismatch
    (:func:`..parallel.mesh.agree`), so a flip in one rank's shard makes
    every rank report it and rewind together, and the data-parallel
    replicas' vectors are voted on (:func:`dp_consensus_fingerprints`,
    :func:`majority_vote`; ``divergent_replicas`` names the outvoted
    ones: of two replicas that disagree, one).
    """

    needs_prev_state = False

    def __init__(self, every: int, watchdog: Any = None,
                 chaos: Any = None) -> None:
        if every < 1:
            raise ValueError(f"integrity cadence must be >= 1, got {every}")
        self.every = every
        self.watchdog = watchdog
        self.chaos = chaos
        self.checks = 0
        self.mismatches = 0
        self.flips_injected = 0
        self.divergent_replicas: Dict[int, List[int]] = {}

    # -- Callback protocol -------------------------------------------------

    def on_train_start(self, trainer) -> None: ...

    def on_eval_end(self, trainer, metrics) -> None: ...

    def on_train_end(self, trainer) -> None: ...

    def on_step_end(self, trainer, metrics: Dict) -> None:
        step = trainer.host_step
        if step % self.every != 0:
            return
        if "integrity_fp" not in metrics:
            raise IntegrityError(
                "IntegrityMonitor needs the in-step fingerprint metric: "
                "build the step with make_train_step(..., "
                f"integrity_every={self.every})")
        if self.chaos is not None:
            kind, _lat, detail = self.chaos.consult_detail(
                "integrity", "params")
            if kind == "bitflip":
                self._flip_param_bit(trainer, int(detail.get("bit", 0)))
        fingerprint = getattr(trainer.step_fn, "fingerprint",
                              fingerprint_tree)
        actual_t = fingerprint(trainer.state.params)
        reported = metrics["integrity_fp"].cpu().numpy()
        actual = actual_t.cpu().numpy()
        self.checks += 1
        checks, mismatches = _metrics()
        checks.inc()
        same = np.array_equal(reported, actual)
        if ps.world_size() > 1:
            _, self.divergent_replicas = majority_vote(
                dp_consensus_fingerprints(None, actual_t))
            same = ps.agree(float(not same), "max") == 0
        if same:
            return
        bad = [int(i) for i in np.nonzero(reported != actual)[0]]
        self.mismatches += 1
        mismatches.labels(scope="params").inc()
        emit_event("integrity_mismatch", scope="params", step=step,
                   leaves=bad, cadence=self.every,
                   divergent_replicas=self.divergent_replicas)
        reason = (f"integrity fingerprint mismatch at step {step} "
                  f"(divergent leaves {bad})")
        if self.watchdog is not None:
            self.watchdog.report_anomaly(trainer, reason)
        else:
            raise IntegrityError(reason)

    # -- internals ---------------------------------------------------------

    def _flip_param_bit(self, trainer, bit: int) -> None:
        """Chaos drill injection: flip one (seeded) bit of the largest
        parameter in place — byte ``(bit // 8) % nbytes``, bit ``bit % 8``
        of its little-endian bytes, as the reference flips its host copy —
        simulating a memory or readback corruption between the step's
        write and the next read. Deterministic given the plan seed."""
        leaves = list(trainer.state.params.values())
        li = max(range(len(leaves)), key=lambda i: leaves[i].numel())
        with torch.no_grad():
            flat = leaves[li].detach().view(-1).view(torch.uint8)
            pos = (bit // 8) % flat.numel()
            flat[pos] ^= 1 << (bit % 8)
        self.flips_injected += 1
        logger.info("chaos: flipped bit %d of param leaf %d", bit, li)
