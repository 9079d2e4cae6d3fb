"""Cross-entropy losses at tp=1 (counterpart of
``neuronx_distributed_tpu/parallel/loss_functions.py``).

The vocab dim is whole on one rank, so the JAX package's pmax/psum over the
tp axis are identities here; what carries over is the arithmetic: the fp32
upcast, the max shift that carries no gradient, the label logit taken from
the shifted logits, ``ignore_index`` zeroing, and the mean over the tokens
that are not ignored. The sharded form comes with the parallel substrate.
"""

from __future__ import annotations

from typing import Optional

import torch


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           ignore_index: Optional[int] = None
                           ) -> torch.Tensor:
    """Per-token cross-entropy: ``logits [..., V]``, integer ``labels
    [...]``; returns fp32 losses ``[...]``, 0 where ``labels ==
    ignore_index``."""
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    sum_exp = torch.exp(shifted).sum(dim=-1)
    vocab = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < vocab)
    safe = torch.where(valid, labels, 0)
    label_logit = torch.gather(shifted, -1, safe[..., None])[..., 0]
    label_logit = torch.where(valid, label_logit, 0.0)
    loss = torch.log(sum_exp) - label_logit
    if ignore_index is not None:
        loss = torch.where(labels == ignore_index, 0.0, loss)
    return loss


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is not
    ``ignore_index`` (at least one in the denominator)."""
    per_tok = parallel_cross_entropy(logits, labels,
                                     ignore_index=ignore_index)
    denom = torch.clamp((labels != ignore_index).sum(), min=1)
    return per_tok.sum() / denom
