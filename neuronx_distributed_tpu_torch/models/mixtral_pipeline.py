"""Pipeline-parallel Mixtral training (counterpart of
``neuronx_distributed_tpu/models/mixtral_pipeline.py``).

The MoE decoder stack is cut over the ``pp`` ranks as the Llama one is
(:mod:`.llama_pipeline`: the same stage layout, the same executors). Each
stage call returns the router's aux losses ``[load_balance, z]`` summed
over its layers; the loss is the global cross-entropy plus
``router_aux_coef · aux[0] + router_z_coef · aux[1]`` with the aux summed
over the stages and averaged over the microbatches, as in JAX, and every
backward seeds the aux with those coefficients over M. With
``moe_dispatch="blockwise"`` the experts run K5 forward and K7/K8 backward
at each stage's local expert width; capacity dispatch sizes its capacity
per microbatch. Attention dropout raises, as in JAX: the MoE pipelines
carry no per-microbatch rng channel.
"""

from __future__ import annotations

from typing import Any

from .llama_pipeline import _pipeline_grad_fn


def _check(cfg: Any) -> None:
    if getattr(cfg, "attention_dropout", 0.0) > 0.0:
        raise ValueError(
            "attention_dropout is not threaded through the MoE pipeline "
            "engines; set attention_dropout=0 for MoE PP configs")


def make_moe_pipeline_grad_fn(cfg: Any, num_microbatches: int, pm: Any,
                              ignore_index: int = -100):
    """``grad_fn(params, batch) -> (loss, grads)`` over the GPipe executor
    (JAX ``:142``); ``pm`` is the stage's ParallelModel."""
    _check(cfg)
    if cfg.num_layers % max(pm.pp, 1):
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pp "
                         f"{pm.pp}")
    return _pipeline_grad_fn(cfg, num_microbatches, pm, "gpipe", 1,
                             ignore_index, False, 0)


def make_moe_1f1b_grad_fn(cfg: Any, num_microbatches: int, pm: Any,
                          num_chunks: int = 1, ignore_index: int = -100):
    """The 1F1B / interleaved grad function for the MoE decoder (JAX
    ``:167``), the router's aux seeded in every backward; with
    ``num_chunks > 1`` the stack in the interleaved storage order
    (:func:`.llama_pipeline.interleave_pipeline_params`)."""
    _check(cfg)
    if cfg.num_layers % (max(pm.pp, 1) * num_chunks):
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by stages*chunks "
            f"{pm.pp * num_chunks}")
    return _pipeline_grad_fn(cfg, num_microbatches, pm,
                             "interleaved" if num_chunks > 1 else "1f1b",
                             num_chunks, ignore_index, False, 0)
