"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library for ``sm_90a`` (Hopper), loaded with
:mod:`ctypes`. Libraries land in ``build/torch_kernels/`` at the repository
root, named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once. All sources that need a build
compile in parallel, one ``nvcc`` each. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit")


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Raises on a failed
    build; returns each name's library path."""
    names = list(sources() if names is None else names)
    for n in names:
        if not (CSRC / f"{n}.cu").is_file():
            raise FileNotFoundError(f"no kernel source csrc/{n}.cu")
    todo = [n for n in names if not library_path(n).is_file()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        try:
            for n in todo:
                out = library_path(n)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{n}.cu")]
                procs.append((n, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                    tmp, out))
            for n, proc, tmp, out in procs:
                log = proc.communicate()[0].decode(errors="replace")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for csrc/{n}.cu "
                                       f"(exit {proc.returncode}):\n{log}")
                os.replace(tmp, out)
        finally:
            for _, proc, tmp, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
