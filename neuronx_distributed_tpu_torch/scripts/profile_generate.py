"""Where the contiguous-cache decode step's time goes on one CUDA card.

    python3 -m neuronx_distributed_tpu_torch.scripts.profile_generate
    python3 -m neuronx_distributed_tpu_torch.scripts.profile_generate --mixtral

Runs ``chip_smoke.py``'s ``generate`` workload (Llama-3-8B at full width,
all 32 layers, bf16, random weights; B=8 prompts of 100-500 tokens padded
to bucket 512, a 576-slot cache) or, with ``--mixtral``, its
``generate_mixtral`` workload (Mixtral 8x7B's widths at 8 layers,
blockwise with block 64, B=4), prefills, and traces greedy decode steps
with ``torch.profiler``. Prints, as ``profile_serving`` does, one JSON line
for the prefill and one for the decode window (host wall time per step,
device busy time, the idle share, busy time by kernel group, the port's
kernels by name), and the wall time per decode step without the profiler.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from .profile_serving import time_steps, trace


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mixtral", action="store_true",
                    help="Mixtral 8x7B widths at 8 layers, blockwise, B=4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: CUDA is not available")
    from ..inference import generation, kv_cache
    from ..models import llama, mixtral

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    family = mixtral if args.mixtral else llama
    base = (dataclasses.replace(mixtral.MIXTRAL_8X7B, num_layers=8,
                                moe_dispatch="blockwise", moe_block_size=64)
            if args.mixtral else llama.LLAMA3_8B)
    cfg = dataclasses.replace(base, param_dtype=base.dtype)
    model = family.build_model(cfg, family.init_state_dict(cfg, seed=0,
                                                           std=0.02))
    forward = (mixtral.mixtral_forward_with_cache if args.mixtral
               else llama.llama_forward_with_cache)
    b = 4 if args.mixtral else 8
    rng = np.random.RandomState(1 if args.mixtral else 0)
    lens = rng.randint(100, 501, b)
    bucket = generation.pick_bucket(int(lens.max()), (128, 512, 2048))
    cache_len = bucket + generation.pick_bucket(64,
                                                generation.DECODE_BUCKETS)
    ids = np.zeros((b, bucket), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, cfg.vocab_size, n)
    ids, plen = torch.from_numpy(ids).cuda(), torch.from_numpy(lens).cuda()
    state = {}

    def prefill():
        cache = kv_cache.init_kv_cache(cfg.num_layers, b, cache_len,
                                       cfg.num_kv_heads, cfg.head_dim_,
                                       dtype=cfg.dtype)
        logits, state["cache"] = generation.prefill(model, ids, plen, cache,
                                                    forward=forward)
        state["tok"] = torch.argmax(logits, -1)
        state["pos"] = plen.to(torch.int32)

    def decode():
        logits, state["cache"] = generation.decode_step(
            model, state["tok"], state["pos"], state["cache"],
            forward=forward)
        state["tok"] = torch.argmax(logits, -1)
        state["pos"] = state["pos"] + 1

    prefill()                             # first use: kernel build and load
    trace(decode, 1, "profiler_warmup")   # the first trace pays CUPTI's start
    trace(prefill, 1, "prefill")
    for _ in range(3):
        decode()
    time_steps(decode, 10, "decode_unprofiled")
    trace(decode, 10, "decode")
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
