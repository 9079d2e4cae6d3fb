"""Per-tag checkpoint manifests behind verified resume (the port's copy of
``neuronx_distributed_tpu/resilience/manifest.py``).

``save_checkpoint`` writes ``manifest.json`` into the tag dir *after* the
tensor payload is durable and *before* the done-marker, so a complete tag
always carries a verifiable inventory:

.. code-block:: json

    {"version": 2, "tag": "100",
     "files": [["state/state.pt", 4096, "<sha256>"],
               ["user_content.json", 17, "<sha256>"]],
     "meta_sha256": "..."}

``files`` lists every file under the tag dir (relative, '/'-separated)
except the done-marker and the manifest itself, with byte sizes and a
SHA-256 *content digest* of each shard — "verified resume" means verified
bytes, not just a complete inventory. Size catches truncation (the
dominant corruption after a mid-write kill); the digest catches silent
bit rot in the payload itself, which is what a watchdog rewind must never
restore.
Digesting happens once at save time on the async commit thread, off the
training critical path; verification re-reads the tag being restored —
which the restore was about to read anyway. ``meta_sha256`` is the
SHA-256 of the canonical JSON of ``files``, guarding the manifest's own
metadata.

Backends that cannot serve raw bytes (``read_bytes`` returning ``None``)
degrade to inventory+size entries. Version-1 manifests (pre-digest) and
digest-less entries still verify by size — with a once-per-process
warning that content verification was skipped.

``load_checkpoint`` verifies the manifest and, in auto-resume mode, falls
back to the newest *prior* complete tag on mismatch, logging what was
skipped. Tags saved before this format existed carry no manifest and are
accepted as-is (legacy).
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import List, Optional, Tuple

from ..trainer.checkpoint_storage import BaseCheckpointStorage

logger = logging.getLogger(__name__)

MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 2

#: control-plane files excluded from the inventory: the done-marker is
#: written after the manifest, and the manifest cannot list itself.
_EXCLUDED = ("checkpoint", MANIFEST_FILE)

#: once-per-process flag: digest-less manifests (v1 tags, or backends
#: without read_bytes) are still accepted, but say so exactly once.
_warned_no_digest = False


def _meta_sha256(files: List[List]) -> str:
    canon = json.dumps(files, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def _digest(storage: BaseCheckpointStorage, tag_dir: str,
            relpath: str) -> Optional[str]:
    data = storage.read_bytes(f"{tag_dir}/{relpath}")
    if data is None:
        return None
    return hashlib.sha256(data).hexdigest()


def _warn_no_digest(reason: str) -> None:
    global _warned_no_digest
    if not _warned_no_digest:
        _warned_no_digest = True
        logger.warning(
            "checkpoint manifest carries no content digests (%s): resume "
            "verification degrades to inventory+size — re-save to upgrade "
            "to verified bytes", reason)


def build_manifest(storage: BaseCheckpointStorage, tag_dir: str,
                   tag: str) -> Optional[dict]:
    """Inventory ``tag_dir`` into a manifest dict, or ``None`` when the
    backend cannot enumerate files (verification is then skipped on load —
    never a hard failure on exotic backends). Entries are
    ``[relpath, size, sha256]``; the digest is dropped (entry shrinks to
    ``[relpath, size]``) when the backend cannot read raw bytes."""
    listing = storage.list_files(tag_dir)
    if listing is None:
        return None
    files = []
    for p, size in sorted(listing):
        if p in _EXCLUDED:
            continue
        digest = _digest(storage, tag_dir, p)
        files.append([p, int(size)] if digest is None
                     else [p, int(size), digest])
    return {
        "version": MANIFEST_VERSION,
        "tag": str(tag),
        "files": files,
        "meta_sha256": _meta_sha256(files),
    }


def verify_manifest(storage: BaseCheckpointStorage, tag_dir: str,
                    manifest_path: str) -> Tuple[bool, str]:
    """``(ok, detail)``: does the tag dir match its manifest, *byte for
    byte* where digests are recorded?

    Missing manifest (legacy tag) and unenumerable backends verify
    vacuously — the commit protocol's done-marker remains the baseline
    guarantee; the manifest strengthens it where available. Digest-less
    entries (v1 manifests, digest-incapable backends) fall back to the
    size check and warn once per process.
    """
    if not storage.file_exists(manifest_path):
        return True, "no manifest (legacy tag)"
    try:
        manifest = storage.load_object(manifest_path)
    except Exception as e:
        return False, f"unreadable manifest: {e!r}"
    files = manifest.get("files")
    if not isinstance(files, list):
        return False, "malformed manifest: no file list"
    recorded_sha = manifest.get("meta_sha256")
    if recorded_sha != _meta_sha256(files):
        return False, "manifest metadata checksum mismatch"
    listing = storage.list_files(tag_dir)
    if listing is None:
        return True, "backend cannot enumerate files; skipped"
    actual = {p: int(size) for p, size in listing if p not in _EXCLUDED}
    checked = unverified = 0
    for entry in files:
        path, size = entry[0], int(entry[1])
        if path not in actual:
            return False, f"missing file {path!r}"
        if actual[path] != size:
            return False, (f"size mismatch for {path!r}: manifest {size}, "
                           f"on storage {actual[path]}")
        recorded = entry[2] if len(entry) > 2 else None
        if recorded is None:
            unverified += 1
            continue
        current = _digest(storage, tag_dir, path)
        if current is None:
            unverified += 1
            continue
        if current != recorded:
            return False, (f"content digest mismatch for {path!r}: the "
                           "shard's bytes changed after save (silent "
                           "corruption)")
        checked += 1
    if unverified:
        _warn_no_digest(f"{unverified} of {len(files)} entries under "
                        f"{tag_dir!r}")
        return True, f"ok ({checked} digests verified, {unverified} by size)"
    return True, f"ok ({checked} digests verified)"
