"""The train workloads that ``chip_smoke.py`` (phases ``train`` and
``train_mixtral``) and :mod:`.profile_train` both drive, set up in one
place so the two cannot drift apart (``profile_train --loop`` adds
``train_loop``'s remat and chunked loss to the ``train`` workload)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from .. import trainer
from ..config import OptimizerConfig, neuronx_distributed_config
from ..models.llama import LLAMA3_8B, LlamaConfig
from ..models.mixtral import MIXTRAL_8X7B


def train_batch(vocab: int, seq: int, seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """One ``[1, seq]`` batch of token ids from numpy's ``RandomState(seed)``,
    labels shifted by one."""
    ids = np.random.RandomState(seed).randint(0, vocab, (1, seq + 1))
    ids = torch.from_numpy(ids)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


@dataclasses.dataclass
class TrainWorkload:
    cfg: LlamaConfig
    state: trainer.TrainState
    step: Callable[..., Any]
    batch: Dict[str, torch.Tensor]


def _workload(cfg: LlamaConfig, seq: int, **cfg_kw) -> TrainWorkload:
    """``cfg`` in fp32 params and bf16 compute with flash attention and no
    dropout, random weights (seed 0, std 0.02); AdamW at lr 1e-4 (b2 0.95,
    weight decay 0.01) clipped at global norm 1.0; one fixed batch of
    ``seq`` tokens from numpy seed 0. ``cfg_kw`` sets more config fields
    (remat, ``loss_chunk``)."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16,
                              param_dtype=torch.float32,
                              use_flash_attention=True, attention_dropout=0.0,
                              **cfg_kw)
    ncfg = neuronx_distributed_config(optimizer_config=OptimizerConfig(
        grad_clipping=True, max_grad_norm=1.0))
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, seed=0,
                                                   std=0.02)
    tx, state = trainer.initialize_parallel_optimizer(pm, params,
                                                      learning_rate=1e-4)
    return TrainWorkload(cfg=cfg, state=state,
                         step=trainer.make_train_step(pm, tx),
                         batch=train_batch(cfg.vocab_size, seq))


def llama3_train_workload(layers: int = 4, seq: int = 4096,
                          **cfg_kw) -> TrainWorkload:
    """Llama-3-8B widths at ``layers`` layers (:func:`_workload`); with
    ``remat=True, remat_policy="save_attention", loss_chunk=512`` the
    model of ``chip_smoke.py``'s ``train_loop``."""
    return _workload(dataclasses.replace(LLAMA3_8B, num_layers=layers), seq,
                     **cfg_kw)


def mixtral_train_workload(layers: int = 2,
                           seq: int = 4096) -> TrainWorkload:
    """Mixtral 8x7B widths at ``layers`` layers, the experts dropless
    (``moe_dispatch="blockwise"``, block 64: K5 forward, K7 and K8
    backward), router coefficients 0.02 and 0.001 (:func:`_workload`)."""
    return _workload(dataclasses.replace(
        MIXTRAL_8X7B, num_layers=layers, moe_dispatch="blockwise",
        moe_block_size=64), seq)
