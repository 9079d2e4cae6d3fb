"""How far bf16 serving of a LoRA Llama lies from fp32, by depth.

    python3 -m neuronx_distributed_tpu_torch.scripts.lora_bf16_floor \
        [--depths 2,8,32] [--adapter-std 0.02]

On the CUDA card, for Llama-3-8B's widths at each depth (random bf16 base
weights, seed 0; adapters of r=16 on qkv, o_proj, gate_up and down drawn
normal(0, adapter std), B too, seed 1) and two right-padded prompts:
the last-prompt-token logits of ``generation.prefill`` for the base model,
the unmerged LoRA model and the merged one (``merge_lora_params``), each
in bf16 and fp32. Prints one JSON line per depth with the max absolute
gaps over max|logit|: the base model bf16 against fp32 (the floor any bf16
form starts from), merged against unmerged in fp32 (the merge's own error)
and in bf16, and the base against the unmerged model (what a merge that
dropped every adapter would give) in both. ``chip_smoke.py``'s
``lora_serve`` holds the bf16 merge at a depth where the merged gap stays
within 2e-2 and the dropped one does not.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..inference import generation, kv_cache
from ..lora import LoraConfig, is_lora_path, merge_lora_params
from ..models.llama import (LLAMA3_8B, build_model, init_lora_state,
                            init_state_dict)


def prefill_logits(cfg, weights, ids, lens) -> torch.Tensor:
    """fp32 logits of the last prompt token of each row."""
    model = build_model(cfg, weights)
    cache = kv_cache.init_kv_cache(cfg.num_layers, ids.shape[0],
                                   ids.shape[1], cfg.num_kv_heads,
                                   cfg.head_dim_, dtype=cfg.dtype,
                                   device="cuda")
    with torch.no_grad():
        logits, _ = generation.prefill(model, ids, lens, cache)
    del model, cache
    torch.cuda.empty_cache()
    return logits.float()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", default="2,8,32",
                    help="comma-separated layer counts")
    ap.add_argument("--adapter-std", type=float, default=0.02)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lora_bf16_floor: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lora = LoraConfig(r=16, alpha=32.0,
                      target_modules=("qkv", "o_proj", "gate_up", "down"))
    cfg = dataclasses.replace(LLAMA3_8B, param_dtype=torch.bfloat16,
                              use_flash_attention=True)
    base = init_state_dict(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    adapters = {n: torch.randn(t.shape, generator=gen, device="cuda")
                * args.adapter_std
                for n, t in init_lora_state(dataclasses.replace(
                    cfg, lora=lora, param_dtype=torch.float32)).items()}
    rng = np.random.RandomState(5)
    lens = np.array([200, 137])
    ids = np.zeros((2, 256), np.int64)
    for r, k in enumerate(lens):
        ids[r, :k] = rng.randint(0, cfg.vocab_size, k)
    ids, lens = torch.from_numpy(ids).cuda(), torch.from_numpy(lens).cuda()
    print(torch.cuda.get_device_name(0), flush=True)
    for depth in (int(d) for d in args.depths.split(",")):
        keep = {n: t for n, t in {**base, **adapters}.items()
                if not n.startswith("layers.")
                or int(n.split(".")[1]) < depth}
        c = dataclasses.replace(cfg, num_layers=depth)
        lc = dataclasses.replace(c, lora=lora)
        logits = {}
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            dc = dataclasses.replace(c, dtype=dtype)
            ldc = dataclasses.replace(lc, dtype=dtype)
            logits["base_" + name] = prefill_logits(
                dc, {n: t for n, t in keep.items() if not is_lora_path(n)},
                ids, lens)
            logits["unmerged_" + name] = prefill_logits(ldc, keep, ids, lens)
            merged = merge_lora_params(keep, lora)
            if dtype == torch.bfloat16:     # served merged weights
                merged = {n: t.to(dtype) for n, t in merged.items()}
            logits["merged_" + name] = prefill_logits(dc, merged, ids, lens)
            del merged

        def gap(a, b):
            return ((logits[a] - logits[b]).abs().max()
                    / logits[b].abs().max()).item()

        print(json.dumps({
            "depth": depth, "adapter_std": args.adapter_std,
            "bf16_floor_base": gap("base_bf16", "base_fp32"),
            "merged_vs_unmerged_fp32": gap("merged_fp32", "unmerged_fp32"),
            "merged_vs_unmerged_bf16": gap("merged_bf16", "unmerged_bf16"),
            "unmerged_bf16_vs_fp32": gap("unmerged_bf16", "unmerged_fp32"),
            "adapters_vs_base_fp32": gap("unmerged_fp32", "base_fp32"),
            "dropped_merge_vs_unmerged_bf16": gap("base_bf16",
                                                  "unmerged_bf16")}),
            flush=True)


if __name__ == "__main__":
    main()
