"""AdamW after global-norm clipping, with optax's semantics (counterpart of
``neuronx_distributed_tpu/trainer/optimizer.py`` ``make_optimizer``).

The JAX package chains ``optax.clip_by_global_norm`` and ``optax.adamw``.
Written out, one update of every parameter ``p`` with gradient ``g`` is:

* clip: ``norm = sqrt(sum_leaves sum(g**2))``; ``g`` stays as it is when
  ``norm < max_norm`` and becomes ``g / norm * max_norm`` otherwise (no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
* ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g**2``, ``t`` the
  update count from 1;
* ``p -= lr(t - 1) * (mu / (1 - b1**t) / (sqrt(nu / (1 - b2**t)) + eps)
  + weight_decay * p)``, with the decay on every parameter (optax's mask
  ``None``) and a schedule read at the count before the update.

``torch.optim.AdamW`` computes the same update only with every parameter in
one group with one weight decay; this module writes it out instead, so the
clip, the schedule's count and a skipped step follow optax exactly. Updates
are in place: the moments and the parameters are overwritten, and no copy
of the model is kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import torch

from ..config import NxDConfig

LearningRate = Union[float, Callable[[int], float]]


@dataclass
class AdamWState:
    """``count`` updates applied so far; first and second moments, one per
    parameter, in the parameters' order."""

    count: int = 0
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor, as
    ``optax.global_norm``; a 0-dim fp32 tensor on the tensors' device.

    Each tensor is reduced one dim at a time, last dim first, so no fp32
    sum runs over more than one dim's length. A flat fp32 norm on the CPU
    drifts with the element count: it put the grad norm of Llama-3-8B's
    widths at 2 layers, whose largest part is the 525 M-element LM-head
    gradient, 0.19% below the same norm on a CUDA card."""
    def norm(t):
        t = t.float()
        while t.dim() > 1:
            t = torch.linalg.vector_norm(t, dim=-1)
        return torch.linalg.vector_norm(t)

    return torch.linalg.vector_norm(torch.stack([norm(t) for t in tensors]))


@dataclass(frozen=True)
class AdamW:
    """The optimizer :func:`make_optimizer` builds. ``max_grad_norm`` None
    means no clipping."""

    learning_rate: LearningRate = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: Optional[float] = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(count=0,
                          mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params])

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: AdamWState,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip ``grads`` (in place), then apply one AdamW update to
        ``params`` and ``state`` in place. ``grad_norm``, when given, is the
        global norm of ``grads`` already computed by the caller."""
        grads = list(grads)
        if self.max_grad_norm is not None:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            factor = torch.where(norm < self.max_grad_norm,
                                 torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.lr(state.count)
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        # one parameter at a time: the temporaries stay the size of the
        # largest parameter, not of the model
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)


def make_optimizer(cfg: NxDConfig, learning_rate: LearningRate = 1e-4,
                   weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.95, eps: float = 1e-8) -> AdamW:
    """AdamW with global-norm clipping per ``cfg.optimizer``
    (``grad_clipping``, ``max_grad_norm``). ``learning_rate`` is a float
    or a schedule of the update count (:mod:`.schedules`)."""
    opt = cfg.optimizer
    return AdamW(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay,
                 max_grad_norm=opt.max_grad_norm if opt.grad_clipping
                 else None)
