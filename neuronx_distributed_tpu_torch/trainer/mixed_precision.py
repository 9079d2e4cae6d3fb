"""fp32 master weights for low-precision parameters (counterpart of
``neuronx_distributed_tpu/trainer/mixed_precision.py``).

The port's default is the reference's: fp32 parameters cast to the
compute dtype at use, so the masters are the parameters themselves. This
wrapper covers the other convention, parameters stored in bf16 (half the
parameter memory) with fp32 masters and the optimizer's moments in the
optimizer state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from .optimizer import AdamW, AdamWState


@dataclass
class MasterWeightsState:
    """fp32 copies of the parameters, in their order, and the wrapped
    optimizer's state over them."""

    master: List[torch.Tensor] = field(default_factory=list)
    inner: AdamWState = field(default_factory=AdamWState)


@dataclass(frozen=True)
class FP32MasterWeights:
    """``tx`` run on fp32 masters (what :func:`with_fp32_master_weights`
    returns); the same ``init``/``update`` interface as :class:`AdamW`, so
    ``make_train_step`` takes either."""

    tx: AdamW

    def init(self, params: Sequence[torch.Tensor]) -> MasterWeightsState:
        master = [p.detach().to(torch.float32, copy=True) for p in params]
        return MasterWeightsState(master=master, inner=self.tx.init(master))

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: MasterWeightsState,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip and update the masters in fp32 from ``grads`` cast to fp32,
        then set each live parameter to its new master, cast to the
        parameter's dtype (the reference emits ``master.astype(p.dtype) -
        p`` as the update, which lands there)."""
        grads32 = [g.to(torch.float32) for g in grads]
        self.tx.update(state.master, grads32, state.inner,
                       grad_norm=grad_norm)
        for p, m in zip(params, state.master):
            p.copy_(m)


def with_fp32_master_weights(tx: AdamW) -> FP32MasterWeights:
    """Wrap ``tx`` so that its updates run on fp32 masters and the live
    parameters follow them, rounded (the reference's
    ``AdamW_FP32OptimParams``)."""
    return FP32MasterWeights(tx)
