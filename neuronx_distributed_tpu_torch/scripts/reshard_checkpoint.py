"""Merge a checkpoint saved across ranks into a one-rank checkpoint, or
write it out at another layout (counterpart of
``neuronx_distributed_tpu/scripts/reshard_checkpoint.py``).

A tag saved across ranks holds one file per writing rank and a shard
table in its manifest (:mod:`..trainer.checkpoint`). This CLI resolves
the tag first (``-1``: the newest complete one), so that the loaded state
and the saved tag cannot disagree, verifies it, loads every tensor whole
and saves it as ``--tp`` x ``--dp`` ranks would have saved it (default
one rank: what the port's one-rank step loads), each tensor split by its
saved spec (a ``"dp"`` dim, the moments' ZeRO-1 slices, over ``--dp``).
A tag saved at an expert-parallel layout (an expert bank's ``"ep"`` dim,
its moments' ``"dp_exp"`` dim) merges the same way, and loads directly at
any other layout too (:func:`..trainer.checkpoint.load_checkpoint`).
With ``--pp S`` the output is a pipeline layout's tag: each stage writes
the tensors of the parameters it holds (:func:`..models.llama_pipeline.
holders`: its layers, the embedding on the first stage, the norm and the
head on the last), and their optimizer tensors.

    python -m neuronx_distributed_tpu_torch.scripts.reshard_checkpoint \\
        --input ckpts/run1 --tag -1 --output merged/ [--tp 4 --dp 1 --pp 2]

Tensors are assembled on the CUDA card unless ``--device cpu`` is given,
as the port's other CLIs run.
"""

from __future__ import annotations

import argparse
import os

from ..device import resolve_device


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Merge or reshard a checkpoint of the port")
    ap.add_argument("--input", required=True, help="checkpoint root dir")
    ap.add_argument("--tag", default="-1",
                    help="tag to load (-1 = newest complete)")
    ap.add_argument("--output", required=True, help="output checkpoint root")
    ap.add_argument("--output-tag", default=None,
                    help="tag to save under (default: same as loaded)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks of the output layout")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks of the output layout")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages of the output layout")
    ap.add_argument("--device", default=None,
                    help="where tensors are assembled (default: the card)")
    args = ap.parse_args(argv)

    from ..trainer import checkpoint as ckpt

    tag = args.tag
    if tag in (None, "-1"):
        tags = ckpt.list_complete_tags(args.input)
        if not tags:
            raise FileNotFoundError(
                f"no complete checkpoint under {args.input}")
        tag = tags[-1]
    ok, why = ckpt.verify_checkpoint(args.input, tag)
    print(f"verify {args.input}/{tag}: {'ok' if ok else 'FAILED'} ({why})")
    if not ok:
        raise ckpt.CheckpointCorruptionError(
            f"checkpoint {args.input}/{tag} is corrupt: {why}")
    dev = resolve_device(args.device)
    # verified just above: the load does not digest every file again
    state, user_content = ckpt.load_checkpoint(args.input, tag=tag,
                                               device=dev, verify=False)
    out_tag = args.output_tag if args.output_tag is not None else tag
    table = ckpt.saved_shard_table(args.input, tag)
    if table is None and args.tp * args.dp > 1:
        raise ValueError(f"{args.input}/{tag} holds no shard table: it "
                         "has no partition specs to lay out")
    specs = ({p: tuple(e["spec"]) for p, e in table["leaves"].items()}
             if table is not None else {})
    ckpt.save_at_layout(args.output, out_tag, state, specs, args.tp,
                        args.dp, user_content=user_content, pp=args.pp,
                        stage_of=_stage_of(state, args.pp))
    out = os.path.join(args.output, str(out_tag))
    print(f"resharded {args.input}/{tag} -> {out} (tp={args.tp}, "
          f"dp={args.dp}, pp={args.pp})")
    return out


def _stage_of(state, pp: int):
    """``path -> stage`` writing it in a ``pp``-stage layout of a Llama or
    Mixtral train state (``params/<name>``, and each optimizer tensor at
    its parameter's index); None at ``pp = 1``."""
    if pp == 1:
        return None
    from ..models.llama_pipeline import holders

    names = list(state["params"])
    layers = {int(n.split(".")[1]) for n in names
              if n.startswith("layers.")}
    held = holders(names, len(layers), pp,
                   tie_embeddings="lm_head.kernel" not in names)

    def stage_of(path: str) -> int:
        head, last = path.rsplit("/", 1)
        name = (path.split("/", 1)[1] if path.startswith("params/")
                else names[int(last)] if last.isdigit()
                and int(last) < len(names) else None)
        return 0 if name is None else min(held[name])
    return stage_of


if __name__ == "__main__":  # pragma: no cover
    main()
