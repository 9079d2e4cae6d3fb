"""Where the train step's time goes on one CUDA card.

    python3 -m neuronx_distributed_tpu_torch.scripts.profile_train [--mixtral]

Runs ``chip_smoke.py``'s ``train`` workload
(:func:`.workloads.llama3_train_workload`: Llama-3-8B widths at 4 layers,
fp32 params, bf16 compute, flash attention, B=1, S=4096, AdamW clipped at
1.0, one fixed batch) through ``make_train_step``, or with ``--mixtral``
its ``train_mixtral`` workload (:func:`.workloads.mixtral_train_workload`:
Mixtral 8x7B widths at 2 layers, blockwise experts with block 64, the same
settings otherwise). After two warm-up steps it times 3 steps without the
profiler, then traces 3 with ``torch.profiler`` and prints one JSON line:
host wall time per step, device busy time per step, the device's idle
share (busy time from the trace over the unprofiled wall time), the device
time per step of each group of kernels (the three flash kernels, the
grouped-GLU forward K5, the backward's shared pass 1 and its dx (K7) and dW
(K8) passes, matrix products, the rest), each of the port's kernels by
name (so the bf16 ``tc::..._wgmma`` kernels and the fp32 CUDA-core ones
show apart) and the top kernels by device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

# kernel-name fragments of each group, first match wins
# (the CUDA-core kernels run fp32, the wgmma kernels bf16)
GROUPS = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma")),
          ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_wgmma")),
          ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_wgmma")),
          ("grouped_glu", ("glu_act_kernel", "glu_down_kernel",
                           "glu_act_wgmma", "glu_down_wgmma")),
          ("grouped_glu_bwd_pass1", ("glu_bwd_act_kernel",
                                     "glu_bwd_act_wgmma")),
          ("grouped_glu_dx", ("glu_bwd_dx_kernel", "glu_bwd_dx_wgmma")),
          ("grouped_glu_dw", ("glu_bwd_dw_kernel", "glu_bwd_dw_wgmma")),
          ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def port_kernels(kernels: dict, steps: int, keep) -> dict:
    """Device ms per step of each kernel whose profiler key ``keep``
    accepts, by :func:`kernel_name`; ``kernels`` maps profiler keys to
    device us."""
    out = {}
    for key, us in kernels.items():
        if keep(key):
            name = kernel_name(key)
            out[name] = out.get(name, 0.0) + us / 1e3 / steps
    return out


def kernel_name(key: str) -> str:
    """A profiler key without its return type, namespace and arguments:
    ``void (anonymous namespace)::tc::flash_fwd_wgmma<128>(...)`` ->
    ``tc::flash_fwd_wgmma<128>``."""
    return key.split("(anonymous namespace)::", 1)[-1].split("(")[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mixtral", action="store_true",
                    help="the train_mixtral workload (2 layers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .workloads import llama3_train_workload, mixtral_train_workload

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    seq = 4096
    w = (mixtral_train_workload(layers=2, seq=seq) if args.mixtral
         else llama3_train_workload(layers=4, seq=seq))
    cfg, state, step, batch = w.cfg, w.state, w.step, w.batch

    def run(n):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    run(2)                               # kernel build and load, warm-up
    wall_ms = run(3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(1)                           # the first trace pays CUPTI's start
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run(steps)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.device_time_total
    busy_ms = sum(kernels.values()) / 1e3 / steps
    groups = {}
    for name, us in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "model": "mixtral" if args.mixtral else "llama",
        "layers": cfg.num_layers, "seq": seq,
        "wall_ms_per_step": wall_ms, "profiled_wall_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "tokens_per_s": seq / (wall_ms / 1e3),
        "groups_ms_per_step": groups,
        # each kernel of the port's groups (not cuBLAS, not "other") by name
        "port_kernels_ms_per_step": port_kernels(
            kernels, steps,
            lambda k: group_of(k) not in ("matmul", "other")),
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / steps]
                                    for k, v in top]}), flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
