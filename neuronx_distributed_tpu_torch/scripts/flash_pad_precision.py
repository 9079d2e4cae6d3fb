"""How far the fp32 flash kernels and their plain versions each lie from a
float64 reference at head widths the kernels take padded.

    python3 -m neuronx_distributed_tpu_torch.scripts.flash_pad_precision

``flash_attention`` zero-pads a head width other than 64 or 128 (GPT-NeoX
-20B's 96) to the kernels' width. For each shape (causal or not) this
prints, per output (out, dq, dk, dv), ``chip_smoke.flash_rel_err`` of: the
plain fp32 version at the unpadded width, the kernels on the padded
inputs, and the plain fp32 version on the padded inputs, each against the
plain version in float64; and the kernels against each fp32 plain version.
It prints the card first. Run it from the repository root (it borrows
``chip_smoke.py``'s inputs and error measure).
"""

from __future__ import annotations

import json
import math
import subprocess

import torch
import torch.nn.functional as F

#: (S, N, D, causal); B = 1, as many K/V heads as query heads
SHAPES = ((2048, 64, 96, True), (512, 64, 96, True), (512, 64, 128, True),
          (512, 64, 64, True), (512, 8, 96, True), (2048, 64, 96, False))


def _run(fns, q, k, v, g, causal, scale):
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    out, lse = fns[0](q, k, v, causal, scale, 0.0, 0)
    args = (q, k, v, g, lse, fa.attention_delta(g, out), causal, scale, 0.0,
            0)
    return (out, fns[1](*args), *fns[2](*args))


def main() -> None:
    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    plain = (fa.flash_fwd_plain, fa.flash_bwd_dq_plain,
             fa.flash_bwd_dkv_plain)
    names = ("out", "dq", "dk", "dv")
    for s, n, d, causal in SHAPES:
        q, k, v, g = cs.flash_inputs(301, b=1, s=s, n=n, kv=n, d=d,
                                     dtype=torch.float32)
        scale = 1.0 / math.sqrt(d)
        width = fa.kernel_head_dim(d)

        def pad(t):
            return F.pad(t, (0, width - d))

        ref = _run(plain, *(t.double() for t in (q, k, v, g)), causal, scale)
        runs = {
            "plain_fp32": _run(plain, q, k, v, g, causal, scale),
            "kernel_padded": [t[..., :d] for t in _run(
                kernels, *map(pad, (q, k, v, g)), causal, scale)],
            "plain_fp32_padded": [t[..., :d] for t in _run(
                plain, *map(pad, (q, k, v, g)), causal, scale)]}

        def errs(got, want):
            return {nm: cs.flash_rel_err(a, r.to(a.dtype))
                    for nm, a, r in zip(names, got, want)}

        line = {f"{name}_vs_float64": errs(out, ref)
                for name, out in runs.items()}
        line["kernel_vs_plain_fp32"] = errs(runs["kernel_padded"],
                                            runs["plain_fp32"])
        line["kernel_vs_plain_fp32_padded"] = errs(
            runs["kernel_padded"], runs["plain_fp32_padded"])
        print(json.dumps({"shape": [1, s, n, d], "causal": causal, **line}),
              flush=True)


if __name__ == "__main__":
    main()
