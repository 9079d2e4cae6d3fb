"""Tokenize and pack text into the token file the port's
:class:`..data.native_loader.TokenBatchLoader` reads (counterpart of
``neuronx_distributed_tpu/scripts/prepare_dataset.py``): raw text, a
tokenizer, packed ``seqlen + 1``-token rows, a flat uint16 or uint32
``.bin``.

    python -m neuronx_distributed_tpu_torch.scripts.prepare_dataset \\
        --input corpus.txt --tokenizer path/to/tokenizer_dir \\
        --seqlen 2048 --output tokens.bin

``--input`` is a text file (one document per line) or ``-`` for stdin.
Documents are joined with the tokenizer's EOS and cut into
non-overlapping ``seqlen + 1`` rows (the +1 is the shifted label); the
remainder is dropped. ``--tokenizer`` must be a local directory: nothing
is fetched (the reference also takes a hub name).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def pack_tokens(token_iter, seqlen: int, dtype) -> np.ndarray:
    """Concatenate token id chunks and cut them into rows of ``seqlen +
    1``, returned flat in ``dtype``. Raises when there is not one row, or
    when an id does not fit ``dtype``."""
    flat = np.concatenate([np.asarray(t, np.int64) for t in token_iter])
    per = seqlen + 1
    n = len(flat) // per
    if n == 0:
        raise ValueError(
            f"corpus has {len(flat)} tokens, fewer than one row of "
            f"seqlen+1 = {per}")
    info = np.iinfo(dtype)
    if flat.max(initial=0) > info.max:
        raise ValueError(
            f"token id {int(flat.max())} exceeds {np.dtype(dtype).name}; "
            "use --dtype uint32")
    return flat[:n * per].astype(dtype)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True,
                    help="text file (one document per line), or '-'")
    ap.add_argument("--tokenizer", required=True,
                    help="local directory of an HF tokenizer")
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--output", required=True, help="output .bin path")
    ap.add_argument("--dtype", default="uint16",
                    choices=["uint16", "uint32"])
    args = ap.parse_args(argv)
    if not os.path.isdir(args.tokenizer):
        raise SystemExit(f"--tokenizer {args.tokenizer!r} is not a local "
                         "directory; nothing is fetched")

    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.tokenizer,
                                        local_files_only=True)
    eos = [tok.eos_token_id] if tok.eos_token_id is not None else []

    def token_chunks():
        stream = (sys.stdin if args.input == "-"
                  else open(args.input, encoding="utf-8"))
        with stream:
            for line in stream:
                line = line.strip()
                if line:
                    yield tok.encode(line) + eos

    packed = pack_tokens(token_chunks(), args.seqlen, np.dtype(args.dtype))
    packed.tofile(args.output)
    per = args.seqlen + 1
    print(f"wrote {args.output}: {len(packed) // per} sequences of "
          f"seqlen {args.seqlen} ({packed.nbytes / 1e6:.1f} MB, "
          f"{args.dtype})")


if __name__ == "__main__":
    main()
