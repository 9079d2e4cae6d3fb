"""How often a ``torch.profiler`` trace holds the port's kernels.

    python3 -m tools.probe_trace_loss      # from the root of the repository

The card tests that check which kernel an entry launches read the names
from a profiler trace, and traces have come back without some of the
kernels that the ``ctypes`` libraries launched. This traces two entries
(the bf16 flash backward pair, two kernels; the fp32 grouped-GLU forward,
two kernels) ``--repeats`` times in each of several arrangements and
prints, per arrangement, how many traces held every kernel and how many
held none. The launches are real either way: each entry counts them.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _inputs(device):
    from neuronx_distributed_tpu_torch.modules.moe import blockwise as bw
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 130, n, 64, generator=g).to(
        device, torch.bfloat16) for n in (4, 1, 1, 4))
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.attention_delta(do, out)
    idx = torch.randint(0, 5, (40, 2), generator=g)
    _, src, dest, be, _, padded = bw.compute_block_metadata(idx, 5, 16)
    x = torch.randn(40, 200, generator=g)
    xs = bw.scatter_to_blocks(x, src, dest, padded).to(device)
    gu = (0.1 * torch.randn(5, 200, 2, 176, generator=g)).to(device)
    dn = (0.1 * torch.randn(5, 176, 200, generator=g)).to(device)
    return (q, k, v, do, lse, delta), (xs, gu, dn, be.to(device))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_trace_loss: CUDA is not available")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    fargs, (xs, gu, dn, be) = _inputs(torch.device("cuda"))
    entries = {
        "flash_bwd_bf16": (lambda: (fa.flash_bwd_dq(*fargs),
                                    fa.flash_bwd_dkv(*fargs)), "flash_bwd"),
        "grouped_glu_fp32": (lambda: bm.grouped_glu_cuda(
            xs, gu, dn, be, 16, 88), "glu_")}

    def marker():
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    arrangements = {
        "launch_at_once": lambda fn: fn(),
        "marker_pause_then_twice": lambda fn: (
            marker(), time.sleep(0.1), fn(), fn()),
        "launch_then_pause": lambda fn: (
            fn(), torch.cuda.synchronize(), time.sleep(0.2)),
        "launch_then_torch_kernel": lambda fn: (fn(), marker()),
        "five_launches": lambda fn: [fn() for _ in range(5)],
    }
    for name, (fn, part) in entries.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            marker()
        for how, arrange in arrangements.items():
            held = none = 0
            for _ in range(args.repeats):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    arrange(fn)
                    torch.cuda.synchronize()
                got = {e.key for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and part in e.key}
                held += len(got) == 2
                none += not got
            print(json.dumps({"entry": name, "arrangement": how,
                              "traces": args.repeats, "held_all": held,
                              "held_none": none}), flush=True)


if __name__ == "__main__":
    main()
