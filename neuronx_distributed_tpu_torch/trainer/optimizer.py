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

ZeRO-1 (JAX ``zero1_state_specs`` ``:80``, ``_zero1_extend_spec``): each
parameter's moments are sharded over the merged dp x cp ranks along the
dim :func:`zero1_dim` picks, the largest one not already sharded that the
ranks divide. The train step reduce-scatters the gradient along that dim,
updates this rank's slice of the parameter with its moments, and
all-gathers the parameter (the reference's ``NeuronZero1Optimizer``
dataflow, which GSPMD derives from the specs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple, Union

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
        """Zero moments for ``params``, which must be the tensors (and the
        order) that :meth:`update` will be given: the train step gives the
        trainable ones (``trainer.trainable``)."""
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
        params, grads = list(params), list(grads)
        if not len(params) == len(grads) == len(state.mu):
            raise ValueError(
                f"AdamW.update: {len(params)} parameters, {len(grads)} "
                f"gradients, moments for {len(state.mu)}: init() must be "
                "given the parameters update() is (with LoRA, call "
                "make_lora_optimizer before init)")
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
        # one parameter, and of a large one a block of rows, at a time:
        # the temporaries stay under UPDATE_CHUNK elements, not the size
        # of the largest parameter (an expert bank's is gigabytes)
        for p, g, m, v in zip(params, grads, state.mu, state.nu,
                              strict=True):
            for pc, gc, mc, vc in _row_blocks(p, g, m, v):
                mc.mul_(self.b1).add_(gc, alpha=1.0 - self.b1)
                vc.mul_(self.b2).addcmul_(gc, gc, value=1.0 - self.b2)
                u = (mc / bc1).div_((vc / bc2).sqrt_().add_(self.eps))
                u.add_(pc, alpha=self.weight_decay)
                pc.add_(u, alpha=-lr)


#: the most elements one block of a parameter's AdamW update spans
UPDATE_CHUNK = 1 << 26


def _row_blocks(*tensors: torch.Tensor):
    """The tensors (of one shape) split along dim 0 into blocks of at most
    :data:`UPDATE_CHUNK` elements (whole when smaller, or 0-dim): views,
    so in-place ops on a block write the tensor. The update is elementwise,
    so its values do not depend on the blocks."""
    t = tensors[0]
    if t.dim() == 0 or t.numel() <= UPDATE_CHUNK:
        return [tensors]
    rows = max(1, UPDATE_CHUNK // max(1, t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in tensors))


def zero1_dim(spec: Sequence, shape: Sequence[int],
              zero_size: int) -> Optional[int]:
    """The dim ZeRO-1 shards a parameter's moments along over ``zero_size``
    ranks: of the dims the spec leaves unsharded, the largest that
    ``zero_size`` divides (the first of equal ones); None when none does
    or ``zero_size`` is 1 (JAX ``_zero1_extend_spec``)."""
    if zero_size == 1 or not shape:
        return None
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if (parts[i] is None and shape[i] % zero_size == 0
                and shape[i] >= zero_size):
            return i
    return None


def zero1_state_specs(param_specs: Mapping[str, Sequence],
                      param_shapes: Mapping[str, Sequence[int]],
                      sizes: Mapping[str, int],
                      zero_axes: Tuple[str, ...] = ("dp", "cp"),
                      enabled: bool = True) -> Dict[str, tuple]:
    """The moments' specs: each parameter's spec (of its whole shape) with
    ``zero_axes`` (a tuple, or the one axis) at its :func:`zero1_dim`,
    over the product of their ``sizes`` (JAX ``zero1_state_specs``). A
    spec that names ``ep`` lives on the expert view, whose data axis is
    ``dp_exp``: its moments shard over that instead (JAX
    ``_zero1_extend_spec``, the reference's ``NeuronEPZero1Optimizer``)."""
    out = {}
    for name, spec in param_specs.items():
        axes = (("dp_exp",) if "ep" in spec or "dp_exp" in spec
                else tuple(zero_axes))
        zero_size = 1
        for a in axes:
            zero_size *= sizes.get(a, 1)
        shape = tuple(param_shapes[name])
        parts = list(spec) + [None] * (len(shape) - len(spec))
        d = zero1_dim(spec, shape, zero_size) if enabled else None
        if d is not None:
            parts[d] = axes if len(axes) > 1 else axes[0]
            out[name] = tuple(parts)
        else:
            out[name] = tuple(spec)
    return out


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
