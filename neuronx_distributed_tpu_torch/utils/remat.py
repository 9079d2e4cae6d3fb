"""Remat (activation checkpointing) policies by name (counterpart of
``neuronx_distributed_tpu/utils/remat.py``).

A rematerialised decoder layer keeps only its inputs across the forward
and recomputes its body in the backward, except for what the policy
saves. The policies run through PyTorch's selective checkpointing
(``torch.utils.checkpoint`` with ``use_reentrant=False`` and
``create_selective_checkpoint_contexts``), which decides op by op:

* ``"nothing"``: recompute everything (the flash forward K2 runs twice);
* ``"dots"``: save the products without batch dims (``aten.mm``,
  ``aten.addmm``: the projections), as ``dots_with_no_batch_dims_saveable``;
* ``"dots_batch"``: every product (also ``aten.bmm``, ``aten.baddbmm``),
  as ``dots_saveable``;
* ``"save_attention"``: save the flash forward's ``(out, lse)``, the
  reference's named residuals ``flash_out``/``flash_lse``, so the backward
  does not run K2 again (the flash forward is the op
  ``nxd_torch::flash_fwd``, :mod:`..ops.flash_attention`);
* ``"dots_and_attention"``: the union of ``"dots"`` and
  ``"save_attention"``.

The reference also takes any other ``jax.checkpoint_policies`` name; those
are JAX's, so the port raises ``ValueError`` on them.

Recompute runs the same kernels on the same inputs, so gradients with any
policy equal those without remat, bit for bit.
"""

from __future__ import annotations

import functools
from typing import Callable, FrozenSet

import torch

POLICIES = ("nothing", "dots", "dots_batch", "save_attention",
            "dots_and_attention")


def _saved_ops(name: str) -> FrozenSet:
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.addmm.default}
    batched = {aten.bmm.default, aten.baddbmm.default}
    # the op is registered when ops/flash_attention.py is imported
    from ..ops import flash_attention  # noqa: F401

    attention = {torch.ops.nxd_torch.flash_fwd.default}
    return frozenset({
        "nothing": set(),
        "dots": dots,
        "dots_batch": dots | batched,
        "save_attention": attention,
        "dots_and_attention": dots | attention,
    }[name])


def validate_remat_policy(name: str) -> None:
    """Raise ``ValueError`` for a name the port does not have."""
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; the port has "
                         f"{list(POLICIES)} (other jax.checkpoint_policies "
                         "names are JAX's)")


def resolve_remat_policy(name: str = "nothing") -> Callable:
    """Policy name -> the ``context_fn`` of ``torch.utils.checkpoint``."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    validate_remat_policy(name)
    saved = _saved_ops(name)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_call(fn: Callable, *args, policy: str = "nothing"):
    """``fn(*args)`` under remat with the named policy."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=resolve_remat_policy(policy))
