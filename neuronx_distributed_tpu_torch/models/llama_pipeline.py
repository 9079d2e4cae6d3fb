"""Pipeline-parallel Llama training (counterpart of
``neuronx_distributed_tpu/models/llama_pipeline.py``).

The decoder stack is cut over the ``pp`` ranks: with ``lv = ⌈L/S⌉``,
stage ``s`` holds layers ``[s·lv, min(L, (s+1)·lv))`` (the reference's
stack zero-padded to ``lv·S`` puts the same layers on the same stages;
the port holds no pad layers, so a stage may hold none: ``L = 1`` at
``S = 2`` leaves stage 1 the norm and the head). Stage 0 holds the
embedding, the last stage the final norm and the LM head, and with tied
embeddings both hold the table, whose gradient is the sum of the two
uses. A stage's module keeps every parameter's global name
(``layers.{i}.…``): :func:`build_stage` cuts it, and
``trainer.initialize_parallel_model`` builds it at ``pp > 1``.

:func:`make_pipeline_grad_fn` returns ``grad_fn(params, batch) -> (loss,
grads)`` for ``trainer.make_train_step(grad_fn=...)``, over the GPipe
executor (:mod:`..pipeline.spmd_engine`) or the 1F1B / interleaved one
(:mod:`..pipeline.engine_1f1b`). ``batch`` is the global batch; each rank
takes its data rows. ``loss`` is the mean over the data ranks, the same on
every rank; ``grads`` are this stage's parameters' gradients, summed over
tp under sequence parallelism and averaged over the data ranks, as the
reference's grad_fn returns them.

With ``num_chunks > 1`` the stack is held in the interleaved storage
order (:func:`interleave_pipeline_params` renames a state dict into it,
:func:`deinterleave_pipeline_params` back), so stage ``s``'s chunks are
its contiguous layers, as in the reference.

``vocab_pp`` needs the stages built with ``initialize_parallel_model(...,
vocab_pp=True)``: every stage holds a ``1/(S·tp)`` vocab shard of the
embedding table and of the LM head, and the final norm.

Attention dropout runs under the 1F1B executor only (the GPipe one raises,
as the reference's). Stage ``s`` seeds a ``torch.Generator`` from
``(dropout_seed, batch["dropout_step"], slot, s)`` and each layer draws
its seed from it in turn: masks are distinct per microbatch, chunk, stage
and layer, and a remat recompute reuses the forward's. The reference folds
the same four numbers into a threefry key, so the masks' law is the
reference's and their bits are not.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel import comm, grads as grads_mod, mappings
from ..parallel import mesh as ps
from ..parallel.layers import ColumnParallelLinear, ParallelEmbedding, \
    embedding_attend
from ..parallel.loss_functions import parallel_cross_entropy
from ..pipeline import engine_1f1b as e1
from ..pipeline import spmd_engine as eng

# ---------------------------------------------------------------------------
# the stage's layers and parameters
# ---------------------------------------------------------------------------

def stage_layers(num_layers: int, num_stages: int, stage: int) -> range:
    """The layers stage ``stage`` holds: ``[s·lv, min(L, (s+1)·lv))`` with
    ``lv = ⌈L/S⌉`` (JAX pads the stack to ``lv·S`` and shards it)."""
    lv = -(-num_layers // num_stages)
    return range(min(num_layers, stage * lv),
                 min(num_layers, (stage + 1) * lv))


def holders(names: List[str], num_layers: int, num_stages: int,
            tie_embeddings: bool, vocab_pp: bool = False
            ) -> Dict[str, Tuple[int, ...]]:
    """The stages that hold each parameter of a whole model's ``names``:
    a layer's on its stage; the embedding on stage 0 (and the last stage
    with tied embeddings); the final norm and the LM head on the last
    stage; with ``vocab_pp`` the embedding, the head and the norm on
    every stage."""
    S = num_stages
    every = tuple(range(S))
    where = {}
    for s in range(S):
        for i in stage_layers(num_layers, S, s):
            where[f"layers.{i}."] = (s,)
    out = {}
    for n in names:
        if n.startswith("layers."):
            out[n] = where[".".join(n.split(".")[:2]) + "."]
        elif vocab_pp:
            out[n] = every
        elif n.startswith("embed."):
            out[n] = (0, S - 1) if tie_embeddings and S > 1 else (0,)
        else:
            out[n] = (S - 1,)
    return out


def build_stage(model: nn.Module, num_stages: int, stage: int,
                vocab_pp: bool = False) -> nn.Module:
    """Cut a (meta) Llama or Mixtral ``model`` to stage ``stage``'s part,
    in place: its layers in an ``nn.ModuleDict`` keyed by global index, so
    every parameter keeps its global name; the embedding, norm and head
    where :func:`holders` puts them. With ``vocab_pp`` the embedding and
    head are made again at a ``(pp, tp)`` vocab shard."""
    cfg = model.cfg
    S, s = num_stages, stage
    keep = stage_layers(cfg.num_layers, S, s)
    model.layers = nn.ModuleDict({str(i): model.layers[i] for i in keep})
    first, last = s == 0, s == S - 1
    if vocab_pp:
        dev = model.embed.embedding.device
        n = comm.axis_size(ps.PP_TP_AXES)
        model.embed = ParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=dev,
            param_dtype=cfg.param_dtype, tp_size=n, axis=ps.PP_TP_AXES)
        if not cfg.tie_embeddings:
            model.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, tp_size=n,
                sequence_parallel=False, dtype=cfg.dtype, device=dev,
                param_dtype=cfg.param_dtype, axis=ps.PP_TP_AXES)
        return model
    if not (first or (last and cfg.tie_embeddings)):
        model.embed = None
    if not last:
        model.norm = None
        if not cfg.tie_embeddings:
            model.lm_head = None
    return model


def stage_layer_list(model: nn.Module) -> List[nn.Module]:
    """The stage's layers in stack order."""
    return [model.layers[k] for k in sorted(model.layers, key=int)]


def _rename_layers(sd: Mapping[str, Any], perm) -> Dict[str, Any]:
    """``out["layers.{j}.x"] = sd["layers.{perm[j]}.x"]``; the rest as it
    is."""
    inv = {int(p): j for j, p in enumerate(perm)}
    out = {}
    for name, t in sd.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            name = f"layers.{inv[int(i)]}.{rest}"
        out[name] = t
    return out


def unpad_pipeline_params(sd: Mapping[str, Any], cfg: Any
                          ) -> Dict[str, Any]:
    """The reference strips its stack's pad rows for export; the port
    holds no pad layers, so the state dict comes back as it is (a new
    dict of the same tensors)."""
    return dict(sd)


def interleave_pipeline_params(sd: Mapping[str, Any], cfg: Any,
                               num_stages: int, num_chunks: int
                               ) -> Dict[str, Any]:
    """Rename a canonical state dict's layers into the interleaved storage
    order (:func:`..pipeline.engine_1f1b.interleaved_layer_order`):
    ``layers.{j}`` holds canonical layer ``order[j]``."""
    return _rename_layers(sd, e1.interleaved_layer_order(
        cfg.num_layers, num_stages, num_chunks))


def deinterleave_pipeline_params(sd: Mapping[str, Any], cfg: Any,
                                 num_stages: int, num_chunks: int
                                 ) -> Dict[str, Any]:
    """The inverse of :func:`interleave_pipeline_params`."""
    order = e1.interleaved_layer_order(cfg.num_layers, num_stages,
                                       num_chunks)
    return _rename_layers(sd, np.argsort(order))


# ---------------------------------------------------------------------------
# the grad function
# ---------------------------------------------------------------------------

def _check_dropout_under_gpipe(cfg: Any) -> None:
    if getattr(cfg, "attention_dropout", 0.0) > 0.0:
        # the GPipe executor has no per-microbatch rng channel; a silent
        # skip would fake regularization
        raise ValueError(
            "attention_dropout under PP requires the 1F1B executor "
            "(make_pipeline_grad_fn(..., schedule='1f1b' or "
            "'interleaved')); the GPipe schedule has no per-microbatch "
            "rng channel")


def dropout_generator(dropout_seed: int, dstep: int, slot: int,
                      stage: int) -> torch.Generator:
    """The generator one stage call draws its layers' dropout seeds from:
    a function of ``(dropout_seed, step, slot, stage)``."""
    mixed = np.random.SeedSequence(
        [int(dropout_seed), int(dstep), int(slot), int(stage)])
    return torch.Generator().manual_seed(int(mixed.generate_state(1)[0]))


def _head_loss(model: nn.Module, act: torch.Tensor, labels: torch.Tensor,
               denom: torch.Tensor, ignore_index: int, vocab_pp: bool
               ) -> torch.Tensor:
    """Final norm, LM head (or the tied table) and the vocab-parallel
    cross-entropy of one microbatch, summed over its tokens over
    ``denom``."""
    cfg = model.cfg
    h = model.norm(act)
    axis = ps.PP_TP_AXES if vocab_pp else ps.TP_AXIS
    if vocab_pp and cfg.sp:
        # the head's entry all-reduces the gradient over (pp, tp), tp
        # included, so the gather's backward only splits it
        h = mappings.gather_from_sequence_parallel_region(
            h, ps.TP_AXIS, 1, to_model_parallel=False)
    if cfg.tie_embeddings:
        logits = embedding_attend(
            model.embed.embedding, h, cfg.dtype,
            tp_size=comm.axis_size(axis),
            sequence_parallel=cfg.sp and not vocab_pp, axis=axis)
    else:
        logits = model.lm_head(h)
    per_tok = parallel_cross_entropy(logits, labels,
                                     ignore_index=ignore_index, axis=axis)
    return per_tok.sum() / denom


def _chunks(layers: List[nn.Module], num_chunks: int) -> List[List]:
    lv = len(layers) // num_chunks
    return [layers[c * lv:(c + 1) * lv] for c in range(num_chunks)]


def _aux_weight(cfg: Any, num_microbatches: int,
                device: torch.device) -> Optional[torch.Tensor]:
    if not hasattr(cfg, "router_aux_coef"):
        return None
    return torch.tensor([cfg.router_aux_coef, cfg.router_z_coef],
                        dtype=torch.float32, device=device) / num_microbatches


def _stage_run(pm: Any, batch: Mapping[str, Any], num_microbatches: int,
               num_chunks: int, ignore_index: int) -> SimpleNamespace:
    """What the grad and the eval functions run on this rank's stage:
    its data rows of ``batch`` (``ids``, ``labels``, their counted labels
    ``denom``), ``embed_fn(ids)`` (stage 0's embedding, sequence-split
    under SP), ``stage_fn(c, act, gen)`` over chunk ``c`` of the stage's
    layers (each layer's dropout seed drawn from ``gen``; with a Mixtral
    config ``(act, aux)``, the router's aux summed over the chunk),
    ``act_like`` (one stage activation's shape, dtype and device) and
    ``moe``."""
    model = pm.module
    mcfg = model.cfg
    dev = pm.device
    ids = torch.as_tensor(batch["input_ids"]).to(dev)
    labels = torch.as_tensor(batch["labels"]).to(dev)
    rows = pm.rows(ids.shape[0])
    ids, labels = ids[rows], labels[rows]
    cos, sin = model.rope_tables(dev)
    chunks = _chunks(stage_layer_list(model), num_chunks)
    moe = hasattr(mcfg, "router_aux_coef")

    def embed_fn(ids_):
        x = model.embed(ids_)
        if mcfg.sp:
            x = mappings.scatter_to_sequence_parallel_region(x, ps.TP_AXIS,
                                                             1)
        return x

    def stage_fn(c, act, gen=None):
        aux = torch.zeros(2, dtype=torch.float32, device=dev)
        for layer in chunks[c]:
            act = model.run_layer(layer, act, cos, sin, None, gen)
            if moe:
                act, a = act
                aux = aux + a.float()
        return (act, aux) if moe else act

    seq = ids.shape[1] // (mcfg.tp if mcfg.sp else 1)
    return SimpleNamespace(
        ids=ids, labels=labels, moe=moe, embed_fn=embed_fn,
        stage_fn=stage_fn,
        denom=torch.clamp((labels != ignore_index).sum().float(), min=1.0),
        act_like=((ids.shape[0] // num_microbatches, seq, mcfg.hidden_size),
                  mcfg.dtype, dev))


def _pipeline_grad_fn(cfg: Any, num_microbatches: int, pm: Any,
                      schedule: str, num_chunks: int, ignore_index: int,
                      vocab_pp: bool, dropout_seed: int):
    """The grad function of both executors and both model families; with
    a Mixtral config its stage calls return the router's aux, weighted
    into the loss by the router coefficients over M."""
    C = num_chunks
    use_dropout = getattr(cfg, "attention_dropout", 0.0) > 0.0

    def grad_fn(params: Mapping[str, torch.Tensor],
                batch: Mapping[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model = pm.module
        S = comm.axis_size(ps.PP_AXIS)
        my = ps.axis_rank(ps.PP_AXIS) if S > 1 else 0
        M = num_microbatches
        L = model.cfg.num_layers
        if C > 1 and L % (S * C):
            raise ValueError(
                f"num_layers {L} not divisible by stages*chunks {S * C} "
                "(uneven partition is supported for num_chunks=1)")
        run = _stage_run(pm, batch, M, C, ignore_index)
        dstep = int(batch.get("dropout_step", 0))
        named = {n: p for n, p in params.items() if p.requires_grad}
        for p in named.values():
            p.grad = None
        aux_weight = _aux_weight(model.cfg, M, pm.device)

        def stage_fn(c, act, slot=None):
            return run.stage_fn(c, act, dropout_generator(
                dropout_seed, dstep, slot, my) if use_dropout else None)

        def head_loss_fn(act, lb):
            return _head_loss(model, act, lb, run.denom, ignore_index,
                              vocab_pp)

        ids_mb = eng.microbatch(run.ids, M)
        labels_mb = eng.microbatch(run.labels, M)
        stats: Dict[str, int] = {}
        if schedule == "gpipe":
            loss, aux = eng.pipeline_gpipe_grads(
                run.embed_fn, lambda a: stage_fn(0, a), head_loss_fn, ids_mb,
                labels_mb, S, M, run.act_like, aux_weight=aux_weight,
                stats=stats)
            loss = eng.last_stage_value(loss)
            if run.moe:
                aux = comm.all_reduce(aux, ps.PP_AXIS)
                loss = loss + torch.dot(aux, aux_weight)
        else:
            m_run = M
            if C > 1 and M % S:
                # pad microbatches whose labels are all ignored: their
                # loss, head gradients and stage cotangents are zero
                m_run = -(-M // S) * S
                pad = m_run - M
                ids_mb = torch.cat([ids_mb, ids_mb.new_zeros(
                    (pad,) + tuple(ids_mb.shape[1:]))])
                labels_mb = torch.cat([labels_mb, labels_mb.new_full(
                    (pad,) + tuple(labels_mb.shape[1:]), ignore_index)])
            loss, _ = e1.pipeline_1f1b_grads(
                run.embed_fn, stage_fn, head_loss_fn, ids_mb, labels_mb, S,
                m_run, run.act_like, num_chunks=C, aux_weight=aux_weight,
                num_real_microbatches=M, vocab_parallel_pp=vocab_pp,
                stage_takes_slot=use_dropout, stats=stats)
        grad_fn.last_stats = stats
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        pm.sum_shared_grads(grads)
        grads = grads_mod.allreduce_gradients(
            grads, pm.specs,
            sequence_parallel_names=[n for n in pm.sequence_parallel_names
                                     if n in grads])
        return eng.data_parallel_mean(loss), grads

    grad_fn.last_stats = {}
    return grad_fn


def make_pipeline_grad_fn(cfg: Any, num_microbatches: int, pm: Any,
                          ignore_index: int = -100,
                          schedule: str = "gpipe", num_chunks: int = 1,
                          vocab_pp: bool = False, dropout_seed: int = 0):
    """``grad_fn(params, batch) -> (loss, grads)`` for
    ``trainer.make_train_step(grad_fn=...)`` (JAX ``:158``).

    ``pm`` is the :class:`..trainer.ParallelModel` of this rank's stage
    (``initialize_parallel_model`` at ``pp > 1``), where the reference
    takes its param spec tree. ``schedule``: ``"gpipe"``
    (:mod:`..pipeline.spmd_engine`), ``"1f1b"`` or ``"interleaved"``
    (:mod:`..pipeline.engine_1f1b`, with ``num_chunks`` chunks a stage, the
    stack in the interleaved storage order). ``vocab_pp``: the vocab
    tables sharded over ``(pp, tp)`` (1F1B only). ``dropout_seed``: the
    seed of attention dropout under 1F1B, varied per step by an integer
    ``batch["dropout_step"]``. ``grad_fn.last_stats`` holds the executor's
    ``ticks`` and ``max_live`` graphs of the last call."""
    if schedule != "interleaved" and num_chunks != 1:
        raise ValueError(
            f"num_chunks={num_chunks} only applies to "
            f"schedule='interleaved', got schedule={schedule!r}")
    if schedule in ("1f1b", "interleaved"):
        return make_1f1b_grad_fn(cfg, num_microbatches, pm,
                                 num_chunks=num_chunks,
                                 ignore_index=ignore_index,
                                 vocab_pp=vocab_pp,
                                 dropout_seed=dropout_seed)
    if schedule != "gpipe":
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if vocab_pp:
        raise ValueError("vocab_pp requires schedule='1f1b'/'interleaved'")
    _check_dropout_under_gpipe(cfg)
    return _pipeline_grad_fn(cfg, num_microbatches, pm, "gpipe", 1,
                             ignore_index, False, 0)


def make_1f1b_grad_fn(cfg: Any, num_microbatches: int, pm: Any,
                      num_chunks: int = 1, ignore_index: int = -100,
                      vocab_pp: bool = False, dropout_seed: int = 0):
    """The 1F1B / interleaved grad function (JAX ``:266``): forward and
    backward interleave, and a stage holds the graphs of the microbatches
    in flight only (:mod:`..pipeline.engine_1f1b`), not all ``M``."""
    if vocab_pp and not pm.vocab_pp:
        raise ValueError("vocab_pp=True needs the stages built with "
                         "initialize_parallel_model(..., vocab_pp=True)")
    return _pipeline_grad_fn(cfg, num_microbatches, pm,
                             "interleaved" if num_chunks > 1 else "1f1b",
                             num_chunks, ignore_index, vocab_pp,
                             dropout_seed)


def make_pipeline_eval_fn(cfg: Any, num_microbatches: int, pm: Any,
                          ignore_index: int = -100):
    """The forward-only pipelined loss (reference ``NxDPPModel.run_eval``,
    JAX ``:541``): ``eval_fn(params, batch) -> loss``, the data-parallel
    mean, the same on every rank."""
    _check_dropout_under_gpipe(cfg)

    @torch.no_grad()
    def eval_fn(params, batch):
        model = pm.module
        mcfg = model.cfg
        S = comm.axis_size(ps.PP_AXIS)
        M = num_microbatches
        run = _stage_run(pm, batch, M, 1, ignore_index)
        res = eng.pipeline_spmd(lambda a: run.stage_fn(0, a),
                                eng.microbatch(run.ids, M), S, M,
                                run.act_like, with_aux=run.moe,
                                input_fn=run.embed_fn)
        outs, aux = res if run.moe else (res, None)
        loss = torch.zeros((), dtype=torch.float32, device=pm.device)
        if S == 1 or ps.axis_rank(ps.PP_AXIS) == S - 1:
            for o, lb in zip(outs, eng.microbatch(run.labels, M)):
                loss = loss + _head_loss(model, o, lb, run.denom,
                                         ignore_index, False)
        loss = eng.last_stage_value(loss)
        if run.moe:
            aux = comm.all_reduce(aux, ps.PP_AXIS) / M
            loss = loss + mcfg.router_aux_coef * aux[0] \
                + mcfg.router_z_coef * aux[1]
        return eng.data_parallel_mean(loss)

    return eval_fn
