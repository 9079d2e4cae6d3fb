"""The train workloads that ``chip_smoke.py`` (phases ``train``,
``train_mixtral``, ``train_mixtral_remat`` and ``train_families``) and
:mod:`.profile_train` both drive, set up in one place so the two cannot
drift apart (``profile_train --loop`` adds ``train_loop``'s remat and
chunked loss to the ``train`` workload)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from .. import trainer
from ..config import OptimizerConfig, neuronx_distributed_config
from ..models.bert import BERT_LARGE
from ..models.gpt_neox import GPT_NEOX_20B
from ..models.llama import LLAMA3_8B, LlamaConfig
from ..models.mixtral import MIXTRAL_8X7B
from ..models.vit import VIT_HUGE


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


def _workload(cfg: LlamaConfig, seq: int, batch=None, loss_fn=None,
              **cfg_kw) -> TrainWorkload:
    """``cfg`` in fp32 params and bf16 compute with flash attention and no
    dropout, random weights (seed 0, std 0.02); AdamW at lr 1e-4 (b2 0.95,
    weight decay 0.01) clipped at global norm 1.0; one fixed batch (default
    ``seq`` tokens from numpy seed 0). ``cfg_kw`` sets more config fields
    (remat, ``loss_chunk``); ``loss_fn`` goes to ``make_train_step``."""
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
                         step=trainer.make_train_step(pm, tx,
                                                      loss_fn=loss_fn),
                         batch=(train_batch(cfg.vocab_size, seq)
                                if batch is None else batch))


def llama3_train_workload(layers: int = 4, seq: int = 4096,
                          **cfg_kw) -> TrainWorkload:
    """Llama-3-8B widths at ``layers`` layers (:func:`_workload`); with
    ``remat=True, remat_policy="save_attention", loss_chunk=512`` the
    model of ``chip_smoke.py``'s ``train_loop``."""
    return _workload(dataclasses.replace(LLAMA3_8B, num_layers=layers), seq,
                     **cfg_kw)


def mixtral_train_workload(layers: int = 2, seq: int = 4096,
                           **cfg_kw) -> TrainWorkload:
    """Mixtral 8x7B widths at ``layers`` layers, the experts dropless
    (``moe_dispatch="blockwise"``, block 64: K5 forward, K7 and K8
    backward), router coefficients 0.02 and 0.001 (:func:`_workload`);
    with ``remat=True`` the model of ``chip_smoke.py``'s
    ``train_mixtral_remat``."""
    return _workload(dataclasses.replace(
        MIXTRAL_8X7B, num_layers=layers, moe_dispatch="blockwise",
        moe_block_size=64), seq, **cfg_kw)


def mlm_batch(vocab: int, batch: int, seq: int, share: float = 0.15,
              seed: int = 0) -> Dict[str, torch.Tensor]:
    """``[batch, seq]`` token ids from numpy's ``RandomState(seed)`` with
    ``share`` of the positions labelled with their own id, the rest -100
    (BERT's masked-LM batch)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq))
    labels = np.where(rng.rand(batch, seq) < share, ids, -100)
    return {"input_ids": torch.from_numpy(ids),
            "labels": torch.from_numpy(labels)}


def image_batch(cfg, batch: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``[batch, C, H, W]`` normal pixels and integer labels from numpy's
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    px = rng.randn(batch, cfg.num_channels, cfg.image_size,
                   cfg.image_size).astype(np.float32)
    return {"pixel_values": torch.from_numpy(px),
            "labels": torch.from_numpy(rng.randint(0, cfg.num_labels,
                                                   (batch,)))}


def image_loss(module, params, batch):
    """ViT's train loss over a pixel batch, as the reference's
    ``loss_fn``."""
    return module.loss(batch["pixel_values"], batch["labels"])


def family_train_workload(family: str, **cfg_kw) -> TrainWorkload:
    """``chip_smoke.py``'s ``train_families`` cells (:func:`_workload`):
    ``"neox"`` GPT-NeoX-20B's widths at 4 layers, B=1, S=2048; ``"bert"``
    BERT-large at all 24 layers with the tied ``mlm_transform`` head, B=8,
    S=512, 15% of positions labelled; ``"vit"`` ViT-Huge/14 at all 32
    layers, B=32 images of 3x224x224 through :func:`image_loss`."""
    if family == "neox":
        return _workload(dataclasses.replace(GPT_NEOX_20B, num_layers=4),
                         2048, **cfg_kw)
    if family == "bert":
        cfg = dataclasses.replace(BERT_LARGE, mlm_transform=True)
        return _workload(cfg, 512, batch=mlm_batch(cfg.vocab_size, 8, 512),
                         **cfg_kw)
    if family == "vit":
        return _workload(VIT_HUGE, 0, batch=image_batch(VIT_HUGE, 32),
                         loss_fn=image_loss, **cfg_kw)
    raise ValueError(f"unknown family {family!r}")
