"""Compare the machine code of the port's kernels built from two source
trees.

    python3 -m neuronx_distributed_tpu_torch.scripts.compare_sass OTHER_CSRC
    python3 -m neuronx_distributed_tpu_torch.scripts.compare_sass OTHER_CSRC \\
        --show "paged_attention_kernel<float, float, (int)128>"

Builds every ``csrc/*.cu`` of this checkout and of ``OTHER_CSRC`` (for
example the parent commit's ``neuronx_distributed_tpu_torch/csrc``, unpacked
with ``git archive``) with ``ops/_build.py``'s flags into a temporary
directory, disassembles both with ``cuobjdump -sass`` and prints, for each
kernel by its demangled name, whether the two builds' SASS is the same,
differs, or exists in one build only, then a JSON line of the counts. A
kernel whose SASS is the same runs the same instructions: a change to a
shared header (``csrc/hopper_tc.cuh``) that leaves it the same cannot move
its bits or its time. ``--show`` prints a unified diff of each kernel whose
name contains the text. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``,
``cu++filt``), not a card.
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ..ops import _build


def build(csrc: Path, out: Path) -> dict:
    """Every ``*.cu`` of ``csrc`` into ``out``, one ``nvcc`` each, all
    started together; returns each source's library path."""
    out.mkdir(parents=True)
    procs = []
    for cu in sorted(csrc.glob("*.cu")):
        so = out / f"lib{cu.stem}.so"
        procs.append((cu, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for cu, so, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {cu}:\n{log}")
    return {cu.stem: so for cu, so, _ in procs}


def kernels(so: Path) -> dict:
    """Demangled kernel name -> its SASS text, runs of blanks made one
    (cuobjdump pads its columns to the longest instruction of the file)."""
    tools = Path(_build._nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    names = subprocess.run([str(tools / "cu++filt")],
                           input="\n".join(parts[1::2]), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {n: re.sub(r"[ \t]+", " ", body)
            for n, body in zip(names, parts[2::2])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other tree's csrc/")
    ap.add_argument("--show", default=None,
                    help="print the diff of kernels whose name contains this")
    args = ap.parse_args()
    counts = {"same": 0, "differs": 0, "only_here": 0, "only_there": 0}
    with tempfile.TemporaryDirectory() as tmp:
        here = build(_build.CSRC, Path(tmp) / "here")
        there = build(args.other, Path(tmp) / "there")
        for src in sorted(set(here) | set(there)):
            a = kernels(here[src]) if src in here else {}
            b = kernels(there[src]) if src in there else {}
            for name in sorted(set(a) | set(b)):
                state = ("only_there" if name not in a else "only_here"
                         if name not in b else "same" if a[name] == b[name]
                         else "differs")
                counts[state] += 1
                print(f"{state:10s} {src}: {name}", flush=True)
                if args.show and args.show in name and state == "differs":
                    print("".join(difflib.unified_diff(
                        b[name].splitlines(True), a[name].splitlines(True),
                        "there", "here", n=1)))
    print(json.dumps(counts), flush=True)


if __name__ == "__main__":
    main()
