"""The single-device train step of Llama and Mixtral (counterpart of
``neuronx_distributed_tpu/trainer/trainer.py``).

The JAX package builds one jitted step (loss, grad, clip, AdamW) over
sharded params. Here the step runs eagerly on one device: the model's loss
(``LlamaForCausalLM.loss``, or ``MixtralForCausalLM.loss`` with the
router's aux losses) through autograd, with causal flash attention on the
flash kernels when ``use_flash_attention`` is set and, for Mixtral with
``moe_dispatch="blockwise"``, the experts on the grouped-GLU kernels (K5
forward, K7 and K8 backward), then the global gradient norm and the
optimizer. The model's parameters are the state:
every step updates them, the gradients and the Adam moments in place, and
returns the same :class:`TrainState`.

``scan_steps``, ``compression``, ``integrity_every``, ``loss_fn`` and
``grad_fn`` come with later slices; passing one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ..config import NxDConfig
from ..device import DeviceLike, resolve_device
from ..models import llama, mixtral
from ..models.llama import LlamaConfig, LlamaForCausalLM
from . import optimizer as opt_mod


@dataclass
class TrainState:
    """Step count, the model's parameters (by state-dict name) and the
    optimizer state."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: opt_mod.AdamWState


@dataclass
class ParallelModel:
    """What :func:`initialize_parallel_model` returns beside the params:
    the module, the config and the device."""

    module: LlamaForCausalLM
    config: NxDConfig
    device: torch.device


def initialize_parallel_model(
        cfg: NxDConfig, model_cfg: LlamaConfig, seed: int = 0,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device: DeviceLike = None, std: float = 0.02
) -> Tuple[ParallelModel, Dict[str, torch.nn.Parameter]]:
    """Build the model on ``device`` (None: the CUDA card) with parameters
    that require gradients: random normal(0, ``std``) from ``seed`` (unit
    norm scales), or copies of ``state_dict`` (e.g.
    :func:`..models.convert.params_from_jax`), which is left as it is. The
    family follows the config's type: a ``MixtralConfig`` builds a
    ``MixtralForCausalLM``. Parameters are in ``model_cfg.param_dtype``, but
    for those the model holds in fp32 (the MoE router's kernel). Returns
    ``(ParallelModel, params)``."""
    dev = resolve_device(device)
    if isinstance(model_cfg, mixtral.MixtralConfig):
        family, model_cls = mixtral, mixtral.MixtralForCausalLM
    else:
        family, model_cls = llama, LlamaForCausalLM
    model = model_cls(model_cfg, device="meta")
    if state_dict is None:
        sd = family.init_state_dict(model_cfg, seed=seed, std=std, device=dev)
    else:
        want = model.state_dict()
        sd = {k: v.to(device=dev, dtype=want[k].dtype if k in want
                      else model_cfg.param_dtype, copy=True)
              for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    model.requires_grad_(True).train()
    params = dict(model.named_parameters())
    return ParallelModel(module=model, config=cfg, device=dev), params


def initialize_parallel_optimizer(
        pm: ParallelModel, params: Mapping[str, torch.nn.Parameter],
        learning_rate: opt_mod.LearningRate = 1e-4,
        weight_decay: float = 0.01, **adam_kw
) -> Tuple[opt_mod.AdamW, TrainState]:
    """The optimizer (:func:`.optimizer.make_optimizer`) and a
    :class:`TrainState` at step 0 with zeroed moments."""
    tx = opt_mod.make_optimizer(pm.config, learning_rate=learning_rate,
                                weight_decay=weight_decay, **adam_kw)
    params = dict(params)
    return tx, TrainState(step=0, params=params,
                          opt_state=tx.init(list(params.values())))


def make_train_step(pm: ParallelModel, tx: opt_mod.AdamW, *,
                    grad_accum_steps: int = 1,
                    dropout_generator: Optional[torch.Generator] = None,
                    skip_nonfinite: bool = False,
                    loss_fn: Optional[Callable] = None,
                    grad_fn: Optional[Callable] = None,
                    scan_steps: int = 1, compression: Any = None,
                    integrity_every: Optional[int] = None):
    """``step(state, batch) -> (state, metrics)`` over ``batch =
    {"input_ids": [B, S], "labels": [B, S]}`` (tensors or numpy arrays,
    moved to the model's device here; labels already shifted, ``-100``
    ignored). ``tx`` is the optimizer, or it wrapped by
    :func:`.mixed_precision.with_fp32_master_weights`. ``metrics`` holds 0-dim device tensors: ``loss`` and
    ``grad_norm``, the global norm before clipping.

    ``grad_accum_steps``: split the batch's leading dim into that many
    microbatches and accumulate their gradients before the one update; the
    loss and gradient are the mean over microbatch means.
    ``dropout_generator``: enables attention dropout; each attention call
    of each microbatch draws its seed from it in turn.
    ``skip_nonfinite``: when the loss or the gradient norm is not finite,
    leave the parameters and the optimizer state as they were (the step
    still counts) and report ``metrics["nonfinite_skipped"]``; this reads
    both scalars on the host, one synchronisation per step.
    """
    later = {"loss_fn": loss_fn is not None, "grad_fn": grad_fn is not None,
             "scan_steps": scan_steps != 1,
             "compression": compression is not None,
             "integrity_every": integrity_every is not None}
    asked = [k for k, v in later.items() if v]
    if asked:
        raise ValueError(f"{', '.join(asked)}: not in the port yet (later "
                         "slices)")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    model = pm.module

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        params = list(state.params.values())
        ids = torch.as_tensor(batch["input_ids"]).to(pm.device)
        labels = torch.as_tensor(batch["labels"]).to(pm.device)
        a = grad_accum_steps
        if ids.shape[0] % a:
            raise ValueError(f"batch dim {ids.shape[0]} not divisible by "
                             f"grad_accum_steps {a}")
        for p in params:
            p.grad = None
        loss = None
        for mb_ids, mb_labels in zip(ids.chunk(a), labels.chunk(a)):
            mb_loss = model.loss(mb_ids, mb_labels,
                                 dropout_generator=dropout_generator)
            mb_loss.backward()
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = [p.grad for p in params]
        if a > 1:
            loss = loss * (1.0 / a)
            torch._foreach_mul_(grads, 1.0 / a)
        grad_norm = opt_mod.global_norm(grads)
        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": grad_norm}
        ok = True
        if skip_nonfinite:
            ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
            metrics["nonfinite_skipped"] = int(not ok)
        if ok:
            tx.update(params, grads, state.opt_state, grad_norm=grad_norm)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return step
