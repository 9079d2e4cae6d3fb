"""Time the candidate schedules of the bf16 paged attention (K1) on one
CUDA card.

    python3 -m neuronx_distributed_tpu_torch.scripts.time_paged_tilings

``tc::paged_attention_wgmma`` (``csrc/paged_attention.cu``) runs a token
tile and kv head in ``splits`` CTAs, each taking a share of every run's
table, merged by a second pass. The wrapper picks the split count from the
shapes alone (``tc_splits``). This script times every candidate (splits
1, 2, 4, 8, 16), L2 flushed, on
the same inputs at the shapes where the main path runs K1 at Llama-3-8B
widths (T=512 or 4, N=32, KV=8, D=128, BS=16, 128 table entries): the
random case (every token one of 8 sequences' tables), the packed prefill
step (3-4 chunks), the packed decode step (8 decode rows, 504 pad rows on
the last slot's table) and the T=4 decode worker. It prints the card, then
one JSON line per shape with each candidate's median ms, the entry's
choice, and the largest error of any candidate against the plain version
(limit 2e-2). Run it from the repository root (it borrows
``chip_smoke.py``'s inputs and timer).
"""

from __future__ import annotations

import json
import subprocess

import torch


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_paged_tilings: CUDA is not available")
    import chip_smoke as cs

    from ..ops import paged_attention as pa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, kind, t in (("random", "random", 512),
                           ("packed_prefill", "prefill", 512),
                           ("packed_decode", "decode", 512),
                           ("decode_worker", "worker", 4)):
        args = cs.paged_case(800, t=t, kind=kind)
        ref = pa.paged_attention_plain(*args).float()
        ms, worst = {}, 0.0
        for splits in (1, 2, 4, 8, 16):
            def call(splits=splits):
                return pa.paged_attention_cuda(*args, splits=splits)
            worst = max(worst, (call().float() - ref).abs().max().item())
            ms[f"splits={splits}"] = cs.time_ms(call, flush=flush)
        if not worst <= 2e-2:
            raise AssertionError(f"time_paged_tilings {shape}: a candidate "
                                 f"is {worst} from the plain version")
        print(json.dumps({
            "shape": shape, "tokens": t, "ms": ms,
            "entry_splits": pa.tc_splits(t, args[0].shape[1],
                                         args[1].shape[2], sms),
            "max_abs_err": worst,
            "bound_ms": cs.paged_bound(args)[0]}), flush=True)
        del args, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
