"""Time the two tilings of the bf16 grouped-GLU forward on one CUDA card.

    python3 -m neuronx_distributed_tpu_torch.scripts.time_glu_tilings

``csrc/blockwise_moe.cu`` runs the bf16 forward in two tilings: K5's entry
pairs two 64-row tiles a CTA (one a warpgroup), K6's gives a CTA one row
tile and splits its columns between the two warpgroups. Both compute the
same function, so each entry can take the other's inputs. This script
times both, L2 flushed, at the three shapes where the main path runs the
forward at Mixtral 8x7B widths (random weights): the packed serving step
(512 tokens), the train step's forward (4096 tokens) and the decode worker
(4 tokens, sentinel metadata). It prints the card, then one JSON line per
shape with each tiling's median ms and whether the two agree bit for bit.
Run it from the repository root (it borrows ``chip_smoke.py``'s inputs and
timer).
"""

from __future__ import annotations

import json
import subprocess

import torch


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_glu_tilings: CUDA is not available")
    import chip_smoke as cs

    from ..models.mixtral import MIXTRAL_8X7B
    from ..ops import blockwise_moe as bm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = MIXTRAL_8X7B
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(320)
    weights = (torch.randn((e, h, 2, i), generator=gen, device="cuda",
                           dtype=torch.bfloat16) * 0.02,
               torch.randn((e, i, h), generator=gen, device="cuda",
                           dtype=torch.bfloat16) * 0.02)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    tilings = {"pairs": bm.grouped_glu_cuda,
               "split": bm.grouped_glu_decode_cuda}
    for shape, tokens, sentinel in (("packed_step", 512, False),
                                    ("train_forward", 4096, False),
                                    ("decode_worker", 4, True)):
        args = cs.moe_case(700, tokens, weights, sentinel) + (min(512, i),)
        outs = {name: fn(*args) for name, fn in tilings.items()}
        ms = {name: cs.time_ms(lambda fn=fn: fn(*args), reps=10, flush=flush)
              for name, fn in tilings.items()}
        print(json.dumps({"shape": shape, "rows": args[0].shape[0],
                          "blocks": args[3].numel(), "ms": ms,
                          "same_bits": torch.equal(outs["pairs"],
                                                   outs["split"]),
                          "bound_ms": cs.moe_bound(*args[:5])["bound_ms"]}),
              flush=True)


if __name__ == "__main__":
    main()
