"""The single-device train step of every model family of the port: Llama,
Mixtral, GPT-NeoX, BERT and ViT (counterpart of
``neuronx_distributed_tpu/trainer/trainer.py``).

The JAX package builds one jitted step (loss, grad, clip, AdamW) over
sharded params. Here the step runs eagerly on one device: the model's loss
(``LlamaForCausalLM.loss``, ``MixtralForCausalLM.loss`` with the router's
aux losses, ``GPTNeoXForCausalLM.loss``, ``BertForPreTraining.loss``; ViT
through a ``loss_fn`` over ``pixel_values`` and ``labels``, as in the
reference) through autograd, with flash attention on the flash kernels
when ``use_flash_attention`` is set (causal, or bidirectional for BERT and
ViT, at any head width up to 128) and, for Mixtral with
``moe_dispatch="blockwise"``, the experts on the grouped-GLU kernels (K5
forward, K7 and K8 backward), then the global gradient norm and the
optimizer. The model's parameters are the state:
every step updates them, the gradients and the Adam moments in place, and
returns the same :class:`TrainState`.

``loss_fn``, ``scan_steps``, ``integrity_every`` and ``grad_fn`` (the
pipeline executors' self-differentiating path) are the reference's
(:func:`make_train_step`); ``compression`` comes with a later slice, and
passing it raises.

Across ranks (a world above 1, laid out by
:func:`..config.neuronx_distributed_config`) a Llama or a Mixtral trains
tensor- and data-parallel, as the reference's explicit form: each rank
holds its shards (:func:`..models.convert.shard_state_dict`), takes its
data-parallel slice of the global batch, and after its backward the
gradients are synchronised (:func:`..parallel.grads.allreduce_gradients`;
with ZeRO-1 reduce-scattered), the global norm is taken over every shard
once, and each rank updates its parameters (with ZeRO-1 its slice of
them, then all-gathered). A Mixtral at ``expert_parallel_size > 1`` holds
``E / ep`` of the experts on each rank (the ranks of one ep group split
the data ranks); their gradients are summed over ``dp_exp`` and divided by
the data-parallel size, and ZeRO-1 shards their moments over ``dp_exp``
(:mod:`..parallel.grads`). ``loss`` and ``grad_norm`` are global and equal
on every rank; so are ``integrity_fp`` (each leaf's whole-tensor
fingerprint, :func:`..resilience.integrity.fingerprint_tree_sharded`) and
the attention-dropout masks, drawn at each rank's rows and heads of the
global array. The :class:`TrainState` carries the partition spec of each
of its tensors (``shard_specs``), by which :mod:`.checkpoint` saves each
rank's part and loads it onto another layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..config import NxDConfig
from ..device import DeviceLike, resolve_device
from ..models import family_of
from ..parallel import comm, grads as grads_mod
from ..parallel import mesh as ps
from . import optimizer as opt_mod


@dataclass
class TrainState:
    """Step count, the model's parameters (by state-dict name) and the
    optimizer state. Across ranks ``shard_specs`` maps the path of each
    tensor of the state (``"params/<name>"``, ``"opt_state/mu/<i>"``, as
    :func:`.checkpoint.state_to_tree` nests them) to its partition spec,
    per dim None, ``"tp"`` or ``"dp"`` (the merged data axes of ZeRO-1); it
    describes the state and is not saved with it; an expert bank at ep >
    1 has ``"ep"`` on its expert dim, and its ZeRO-1 moments ``"dp_exp"``
    (the expert view's data axis). At ``pp > 1`` a rank
    holds one stage's tensors, and ``global_paths`` maps the path of each
    to its path in the whole model's state (an optimizer tensor's index
    is then the parameter's among all the model's) and whether this rank
    writes it (not the tied table on the last stage: stage 0 does)."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: opt_mod.AdamWState
    shard_specs: Optional[Dict[str, tuple]] = field(
        default=None, repr=False, compare=False,
        metadata={"checkpoint": False})
    global_paths: Optional[Dict[str, Tuple[str, bool]]] = field(
        default=None, repr=False, compare=False,
        metadata={"checkpoint": False})


@dataclass
class ParallelModel:
    """What :func:`initialize_parallel_model` returns beside the params:
    the module, the config and the device; across ranks also each
    parameter's partition spec (:func:`..models.convert.param_specs`), the
    names whose gradients sum over tp under sequence parallelism, and each
    parameter's ZeRO-1 dim (None: not sharded over the data ranks)."""

    module: torch.nn.Module
    config: NxDConfig
    device: torch.device
    world: int = 1
    specs: Dict[str, tuple] = field(default_factory=dict)
    sequence_parallel_names: List[str] = field(default_factory=list)
    zero_dims: Dict[str, Optional[int]] = field(default_factory=dict)
    pp: int = 1
    stage: int = 0
    holders: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    global_names: List[str] = field(default_factory=list)
    shared_sum: Dict[str, Tuple[tuple, torch.dtype]] = field(
        default_factory=dict)
    vocab_pp: bool = False

    def owns(self, name: str) -> bool:
        """Whether this rank's stage is the one that counts and writes
        parameter ``name``: its only holder, the first of its holders (the
        tied table, held on the first and last stage), or any stage for a
        parameter sharded over pp (``vocab_pp``)."""
        if self.pp == 1 or ps.PP_AXIS in grads_mod.spec_axes(
                self.specs.get(name)):
            return True
        return self.stage == min(self.holders[name])

    def sum_shared_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum, in place, the gradients of a parameter two stages hold and
        use (the tied table: the embedding on stage 0, the head on the
        last) over pp; a stage that holds none of them adds zeros."""
        for name, (shape, dtype) in self.shared_sum.items():
            g = grads.get(name)
            if g is None:
                g = torch.zeros(shape, dtype=dtype, device=self.device)
            comm.all_reduce_(g, ps.PP_AXIS)

    def grad_norm(self, grads: Mapping[str, torch.Tensor],
                  specs: Mapping[str, tuple]) -> torch.Tensor:
        """The global norm of ``grads`` under ``specs``: each leaf counted
        once over the whole world (over pp, by the stage that
        :meth:`owns` it)."""
        if self.pp == 1:
            return grads_mod.global_grad_norm(grads, specs)
        return grads_mod.global_grad_norm_pp(
            {n: g for n, g in grads.items() if self.owns(n)}, specs,
            self.device)

    def zero_axis(self, name: str) -> ps.Axis:
        """The axis ZeRO-1 shards parameter ``name``'s moments over: the
        merged data axes, or ``dp_exp`` for one sharded over ``ep``."""
        if ps.EP_AXIS in grads_mod.spec_axes(self.specs.get(name)):
            return ps.EXP_DP_AXIS
        return ps.DATA_AXES

    def zero_view(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """This data rank's ZeRO-1 slice of parameter ``name`` (a view), or
        the parameter itself."""
        d = self.zero_dims.get(name)
        if d is None:
            return p
        axis = self.zero_axis(name)
        n = p.shape[d] // comm.axis_size(axis)
        return p.narrow(d, ps.axis_rank(axis) * n, n)

    def grad_specs(self) -> Dict[str, tuple]:
        """The specs of the synchronised gradients: a ZeRO-1 one is also
        sharded over the data axes."""
        out = {}
        for name, spec in self.specs.items():
            d = self.zero_dims.get(name)
            parts = list(spec)
            if d is not None:
                parts += [None] * (d + 1 - len(parts))
                parts[d] = self.zero_axis(name)
            out[name] = tuple(parts)
        return out

    def rows(self, n: int) -> slice:
        """This rank's data-parallel rows of a leading dim of ``n``: all of
        them in a world of 1."""
        return ps.data_slice(n) if self.world > 1 else slice(None)

    def sync(self, grads: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The local gradients made global
        (:func:`..parallel.grads.allreduce_gradients`: the tp sum under
        sequence parallelism, the mean over the data ranks, under ZeRO-1
        this rank's slice of it) and their global norm, each shard counted
        once. The identity and ``optax.global_norm`` in a world of 1."""
        grads = grads_mod.allreduce_gradients(
            grads, self.specs,
            sequence_parallel_names=self.sequence_parallel_names,
            zero_dims=self.zero_dims)
        return grads, self.grad_norm(grads, self.grad_specs())

    def zero_slices(self, grads: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Each whole synchronised gradient cut to this data rank's ZeRO-1
        slice (:meth:`zero_view`), as the moments are."""
        return {n: self.zero_view(n, g) for n, g in grads.items()}

    def state_specs(self, state: TrainState) -> Dict[str, tuple]:
        """``TrainState.shard_specs`` of ``state``: each parameter's spec,
        and the spec of its ZeRO-1 slice (:meth:`grad_specs`) for each
        optimizer tensor of the :func:`trainable` parameter at its index
        (moments and fp32 masters alike)."""
        from .checkpoint import state_to_tree, tree_leaves

        def norm(spec):
            return tuple("dp" if a == ps.DATA_AXES else a for a in spec)

        names = list(_trainable_named(state.params))
        zero = self.grad_specs()
        out = {f"params/{n}": norm(self.specs[n]) for n in state.params}
        tree = state_to_tree(state.opt_state, lambda t: t)
        for path, _ in tree_leaves(tree, ("opt_state",)):
            last = path.rsplit("/", 1)[-1]
            if last.isdigit() and int(last) < len(names):
                out[path] = norm(zero[names[int(last)]])
        return out

    def global_state_paths(self, state: TrainState
                           ) -> Dict[str, Tuple[str, bool]]:
        """``TrainState.global_paths`` of a stage's ``state``: for each
        local path, ``(path in the whole state, whether this rank writes
        it)``; a parameter's path is its own, an optimizer tensor's takes
        the index of its parameter among the whole model's, and a tensor
        of a parameter another stage :meth:`owns` is not written here."""
        from .checkpoint import state_to_tree, tree_leaves

        names = list(_trainable_named(state.params))
        index = {n: i for i, n in enumerate(self.global_names)}
        out = {f"params/{n}": (f"params/{n}", self.owns(n))
               for n in state.params}
        tree = state_to_tree(state.opt_state, lambda t: t)
        for path, _ in tree_leaves(tree, ("opt_state",)):
            head, last = path.rsplit("/", 1)
            if last.isdigit() and int(last) < len(names):
                n = names[int(last)]
                out[path] = (f"{head}/{index[n]}", self.owns(n))
            else:
                out[path] = (path, True)
        return out

    def gather_updated(self, params: Mapping[str, torch.Tensor]) -> None:
        """Under ZeRO-1, all-gather each parameter's updated slices over
        the data ranks into the whole parameter."""
        with torch.no_grad():
            for name, p in params.items():
                d = self.zero_dims.get(name)
                if d is not None:
                    # the slice is read into the collective's own buffers
                    # before the gathered whole is written over ``p``
                    comm.all_gather(self.zero_view(name, p),
                                    self.zero_axis(name), d, out=p)


def _world() -> int:
    return ps.get_world_size() if ps.model_parallel_is_initialized() else 1


def _sharded_model(cfg: NxDConfig, model_cfg: Any, seed: int,
                   state_dict: Optional[Mapping[str, torch.Tensor]],
                   dev: torch.device, std: float, vocab_pp: bool = False):
    """The local module of a rank of a world above 1, from the whole
    ``state_dict`` or the seed: every rank makes (or gets) the same whole
    weights and keeps its shards, one whole tensor at a time (made, cut,
    freed), so a rank never holds the whole model. At ``pp > 1`` the
    module is this rank's stage (:func:`..models.llama_pipeline.
    build_stage`), which keeps the tensors of its own parameters only."""
    from ..models import convert, llama, llama_pipeline as lpp, mixtral

    if type(model_cfg) not in (llama.LlamaConfig, mixtral.MixtralConfig):
        raise ValueError(f"{type(model_cfg).__name__} across ranks: not in "
                         "the port yet (a later slice); Llama and Mixtral "
                         "train tensor-, pipeline- and data-parallel")
    _, model_cls = family_of(model_cfg)
    tp = ps.get_tensor_model_parallel_size()
    pp = ps.get_pipeline_model_parallel_size()
    stage = ps.get_pipeline_model_parallel_rank()
    if vocab_pp and pp == 1:
        raise ValueError("vocab_pp needs pipeline_parallel_size > 1")
    if model_cfg.tp_size is None:
        model_cfg = replace(model_cfg, tp_size=tp)
    elif model_cfg.tp_size != tp:
        raise ValueError(f"the config's tp_size {model_cfg.tp_size} differs "
                         f"from the ranks' tensor-parallel size {tp}")
    ep = ps.get_expert_model_parallel_size()
    if ep > 1 and not hasattr(model_cfg, "ep_size"):
        raise ValueError(f"expert_parallel_size={ep} for a "
                         f"{type(model_cfg).__name__}: only a Mixtral has "
                         "experts to shard")
    if getattr(model_cfg, "ep_size", 1) not in (1, ep):
        raise ValueError(f"the config's ep_size {model_cfg.ep_size} differs "
                         f"from the ranks' expert-parallel size {ep}")
    if ep > 1:
        model_cfg = replace(model_cfg, ep_size=ep)
    whole = replace(model_cfg, tp_size=None, sequence_parallel=False,
                    **({"ep_size": 1} if ep > 1 else {}))
    model = model_cls(model_cfg, device="meta")
    shapes = {n: t.shape for n, t in model_cls(
        whole, device="meta").state_dict().items()}
    specs = convert.param_specs(model_cfg, [(n, len(s))
                                            for n, s in shapes.items()])
    extra = {}
    if pp > 1:
        if vocab_pp:
            specs["embed.embedding"] = (ps.PP_TP_AXES, None)
            if "lm_head.kernel" in specs:
                specs["lm_head.kernel"] = (None, ps.PP_TP_AXES)
        held = lpp.holders(list(shapes), model_cfg.num_layers, pp,
                           model_cfg.tie_embeddings, vocab_pp)
        local = model.state_dict()
        shared_sum = {n: (tuple(local[n].shape), local[n].dtype)
                      for n, h in held.items()
                      if len(h) > 1 and not vocab_pp}
        lpp.build_stage(model, pp, stage, vocab_pp)
        extra = dict(pp=pp, stage=stage, holders=held,
                     global_names=list(shapes), shared_sum=shared_sum,
                     vocab_pp=vocab_pp)
    want = model.state_dict()
    sizes = {ps.TP_AXIS: tp, ps.EP_AXIS: ep}
    coords = {ps.TP_AXIS: ps.axis_rank(ps.TP_AXIS),
              ps.EP_AXIS: ps.axis_rank(ps.EP_AXIS)}
    source = (llama.draw_state_dict(whole, seed, std, dev, model_cls)
              if state_dict is None else state_dict.items())
    sd = {}
    for name, t in source:
        if name in want:
            sd[name] = _shard(name, t, specs[name], sizes, coords).to(
                device=dev, dtype=want[name].dtype)
        del t
    model.load_state_dict(sd, strict=True, assign=True)
    specs = {n: specs[n] for n in want}
    zero_dims = {}
    for n in want:
        axis = (ps.EXP_DP_AXIS if ps.EP_AXIS in grads_mod.spec_axes(specs[n])
                else ps.DATA_AXES)
        zero_dims[n] = (opt_mod.zero1_dim(specs[n], shapes[n],
                                          comm.axis_size(axis))
                        if cfg.optimizer.zero_one_enabled else None)
    sp_names = convert.sequence_parallel_names(model_cfg, list(want))
    return model, dict(world=_world(), specs=specs, zero_dims=zero_dims,
                       sequence_parallel_names=sp_names, **extra)


def _shard(name: str, t: torch.Tensor, spec: tuple, sizes, coords
           ) -> torch.Tensor:
    """This rank's shard (a copy) of the whole tensor ``t``: over tp and ep
    by :func:`..models.convert.shard_tensor`, or along a dim sharded over
    ``(pp, tp)``."""
    from ..models import convert

    for d, a in enumerate(spec):
        if a == ps.PP_TP_AXES:
            n = t.shape[d] // comm.axis_size(a)
            return t.narrow(d, ps.axis_rank(a) * n, n).clone()
    return convert.shard_tensor(name, t, spec, sizes, coords)


def initialize_parallel_model(
        cfg: NxDConfig, model_cfg: Any, seed: int = 0,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device: DeviceLike = None, std: float = 0.02,
        vocab_pp: bool = False
) -> Tuple[ParallelModel, Dict[str, torch.nn.Parameter]]:
    """Build the model on ``device`` (None: the CUDA card) with parameters
    that require gradients: random normal(0, ``std``) from ``seed`` (unit
    norm scales, zero biases), or copies of ``state_dict`` (e.g.
    :func:`..models.convert.params_from_jax`), which is left as it is. The
    family follows the config's type (:func:`..models.family_of`): a
    ``MixtralConfig`` builds a ``MixtralForCausalLM``, a ``GPTNeoXConfig``
    a ``GPTNeoXForCausalLM``, a ``BertConfig`` a ``BertForPreTraining``, a
    ``ViTConfig`` a ``ViTForImageClassification``. Parameters are in
    ``model_cfg.param_dtype``, but for those the model holds in fp32 (the
    MoE router's kernel). Returns ``(ParallelModel, params)``.

    Across ranks (a world above 1) the config is a Llama or a Mixtral one,
    and every rank keeps its shards of the whole weights (``state_dict``,
    or those ``seed`` makes, the same on every rank, one tensor at a time)
    at the ranks' tensor-parallel size (``model_cfg.tp_size`` if set,
    which must agree);
    ``sequence_parallel`` is the model config's
    (:func:`..config.configure_model` carries the config's).

    At ``pipeline_parallel_size > 1`` each rank builds only its stage
    (:mod:`..models.llama_pipeline`: its layers, and the embedding, norm
    and head where its stage holds them), every parameter under its global
    name; train it with ``make_train_step(pm, tx, grad_fn=llama_pipeline.
    make_pipeline_grad_fn(...))``. ``vocab_pp`` shards the embedding and
    the LM head over ``(pp, tp)`` on every stage, for a grad function made
    with ``vocab_pp=True``."""
    dev = resolve_device(device)
    if _world() > 1:
        model, extra = _sharded_model(cfg, model_cfg, seed, state_dict, dev,
                                      std, vocab_pp)
        model.requires_grad_(True).train()
        return (ParallelModel(module=model, config=cfg, device=dev,
                              **extra), dict(model.named_parameters()))
    family, model_cls = family_of(model_cfg)
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
    :class:`TrainState` at step 0 with zeroed moments for the
    :func:`trainable` parameters; under ZeRO-1 the moments of this data
    rank's slice of each parameter (:meth:`ParallelModel.zero_view`);
    across ranks the state's ``shard_specs`` (:meth:`ParallelModel.
    state_specs`)."""
    tx = opt_mod.make_optimizer(pm.config, learning_rate=learning_rate,
                                weight_decay=weight_decay, **adam_kw)
    params = dict(params)
    state = TrainState(step=0, params=params, opt_state=tx.init(
        [pm.zero_view(n, p) for n, p in _trainable_named(params).items()]))
    if pm.world > 1:
        state.shard_specs = pm.state_specs(state)
    if pm.pp > 1:
        state.global_paths = pm.global_state_paths(state)
    return tx, state


def trainable(params: Mapping[str, torch.nn.Parameter]
              ) -> List[torch.nn.Parameter]:
    """The parameters the step differentiates and the optimizer updates,
    in ``params``' order: those that require gradients. A frozen one
    (``requires_grad=False``, as :func:`..lora.make_lora_optimizer` leaves
    the base) gets no gradient, no moments and no update."""
    return list(_trainable_named(params).values())


def _trainable_named(params: Mapping[str, torch.nn.Parameter]
                     ) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in params.items() if p.requires_grad}


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
    :func:`.mixed_precision.with_fp32_master_weights`. ``metrics`` holds
    0-dim device tensors: ``loss`` and ``grad_norm``, the global norm
    before clipping. A parameter the loss does not reach (BERT's
    ``type_embedding`` under a loss without token types) gets a zero
    gradient, as under ``jax.grad``. Only the :func:`trainable` parameters
    are differentiated and updated: under LoRA
    (:func:`..lora.make_lora_optimizer`) the adapters, and ``grad_norm`` is
    then their norm, where the reference's covers the frozen base's
    gradient too, which the port does not compute.

    ``loss_fn(module, params, batch) -> scalar``: the loss to
    differentiate instead of the model's own (``params`` is
    ``state.params``, the module's parameters by name; ``batch`` the
    batch, or one microbatch of it, with every leaf a tensor on the
    model's device). As in the reference it does not take
    ``dropout_generator``: a custom loss manages its own randomness.
    ``grad_accum_steps``: split the batch's leading dim into that many
    microbatches and accumulate their gradients before the one update; the
    loss and gradient are the mean over microbatch means.
    ``dropout_generator``: enables attention dropout (default loss only);
    each attention call of each microbatch draws its seed from it in turn.
    ``skip_nonfinite``: when the loss or the gradient norm is not finite,
    leave the parameters and the optimizer state as they were (the step
    still counts) and report ``metrics["nonfinite_skipped"]``; this reads
    both scalars on the host, one synchronisation per step.
    ``scan_steps=K``: every batch leaf carries a leading ``[K]`` dim and
    one call runs K updates, one per slice, returning the last one's
    metrics (the reference runs them as one ``lax.scan``).
    ``integrity_every=K``: ``metrics["integrity_fp"]`` is
    :func:`..resilience.integrity.fingerprint_tree` of the updated
    parameters, ``int32[n_params]``, when ``(step + 1) % K == 0``, and
    zeros of that shape on other steps (shapes never change, so
    ``step.cache_size()`` stays 1). With ``scan_steps > 1`` only the last
    update's metric surfaces, so keep K a multiple of ``scan_steps``.

    ``step.cache_size()`` counts the distinct batch shapes the step has
    met, the port's analog of the reference's compile count
    (:class:`..obs.accounting.CompileTracker` reads it).

    Across ranks ``batch`` is the global batch, the same on every rank:
    each rank takes its data-parallel rows (of each microbatch with
    ``grad_accum_steps``), as the reference shards the batch over dp. The
    default loss weighs each rank's local mean by its share of the
    microbatch's counted labels, so the step's loss and gradient are
    those of the global mean even where ranks count different labels; a
    ``loss_fn``'s local values are averaged over the data ranks. Every
    rank draws the same dropout seeds from ``dropout_generator`` (seed it
    alike on every rank) and the masks at its rows and heads of the
    global array; ``integrity_fp`` holds the whole tensors' fingerprints,
    the same on every rank.

    ``step.fingerprint(params)`` is the fingerprint the step reports,
    :func:`..resilience.integrity.fingerprint_tree` of ``params`` (across
    ranks of the whole tensors their shards make), for the
    :class:`..resilience.integrity.IntegrityMonitor`'s recompute.

    ``grad_fn(params, batch) -> (loss, grads)``: a path that computes its
    own gradients (the pipeline executors,
    :func:`..models.llama_pipeline.make_pipeline_grad_fn`), called on the
    global batch (or each global microbatch with ``grad_accum_steps``);
    ``grads`` by parameter name, already synchronised over the ranks, as
    the reference's are. Clipping, ZeRO-1, ``skip_nonfinite`` and
    ``integrity_every`` apply to them as to the default loss's; at
    ``pp > 1`` the step needs one. Passing it with ``loss_fn`` or with
    ``dropout_generator`` raises, as in the reference.

    ``compression`` comes with a later slice; passing it raises.
    """
    if compression is not None:
        raise ValueError("compression: not in the port yet (a later "
                         "slice)")
    if loss_fn is not None and grad_fn is not None:
        raise ValueError(
            "pass either loss_fn (differentiated here) or grad_fn "
            "(self-differentiating, e.g. the pipeline engine), not both")
    if dropout_generator is not None and (loss_fn is not None
                                          or grad_fn is not None):
        raise ValueError(
            "dropout_generator is only threaded through the default loss; "
            "a custom loss_fn or grad_fn must manage its own randomness")
    if pm.pp > 1 and grad_fn is None:
        raise ValueError(
            f"pipeline_parallel_size={pm.pp}: each rank holds one stage, "
            "so the step needs a pipeline grad_fn (models.llama_pipeline."
            "make_pipeline_grad_fn)")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    if integrity_every is not None and integrity_every < 1:
        raise ValueError(f"integrity_every must be >= 1, got "
                         f"{integrity_every}")
    model = pm.module
    n_data = comm.axis_size(ps.DATA_AXES)

    def microbatch_loss(params, mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        if loss_fn is not None:
            return loss_fn(model, params, mb)
        return data_parallel_loss(model, mb, dropout_generator)

    def one_step(state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, Any]:
        named = _trainable_named(state.params)
        a = grad_accum_steps
        for name, x in batch.items():
            if x.shape[0] % (a * n_data):
                raise ValueError(
                    f"batch dim {x.shape[0]} of {name!r} not divisible by "
                    f"grad_accum_steps {a}" + (
                        f" x data-parallel size {n_data}" if n_data > 1
                        else ""))
        chunks = {k: x.chunk(a) for k, x in batch.items()}
        if grad_fn is not None:
            loss, grads, grad_norm = grad_fn_grads(state, chunks)
            return update(state, named, loss, grads, grad_norm)
        for p in named.values():
            p.grad = None
        loss = None
        for i in range(a):
            mb = {k: c[i][pm.rows(c[i].shape[0])] for k, c in chunks.items()}
            mb_loss = microbatch_loss(state.params, mb)
            mb_loss.backward()
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        for p in named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if a > 1:
            loss = loss * (1.0 / a)
            torch._foreach_mul_([p.grad for p in named.values()], 1.0 / a)
        if n_data > 1:
            loss = comm.all_reduce(loss, ps.DATA_AXES) / n_data
        grads, grad_norm = pm.sync({n: p.grad for n, p in named.items()})
        # the synchronised gradients are all the update reads: a ZeRO-1
        # slice's whole gradient is freed before the update's temporaries
        for p in named.values():
            p.grad = None
        return update(state, named, loss, grads, grad_norm)

    def grad_fn_grads(state: TrainState, chunks):
        """``grad_fn`` over each of the ``grad_accum_steps`` global
        microbatches: the mean loss, the mean synchronised gradients (each
        cut to this rank's ZeRO-1 slice) and their global norm."""
        a = grad_accum_steps
        names = list(_trainable_named(state.params))
        loss, total = None, None
        for i in range(a):
            mb_loss, g = grad_fn(state.params, {k: c[i]
                                                for k, c in chunks.items()})
            g = [g[n] if g.get(n) is not None
                 else torch.zeros_like(state.params[n]) for n in names]
            loss = mb_loss if loss is None else loss + mb_loss
            if total is None:
                total = g
            else:
                torch._foreach_add_(total, g)
        if a > 1:
            loss = loss * (1.0 / a)
            torch._foreach_mul_(total, 1.0 / a)
        grads = dict(zip(names, total))
        grad_norm = pm.grad_norm(grads, pm.specs)
        return loss, pm.zero_slices(grads), grad_norm

    def update(state: TrainState, named, loss, grads, grad_norm
               ) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": grad_norm}
        ok = True
        if skip_nonfinite:
            ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
            metrics["nonfinite_skipped"] = int(not ok)
        if ok:
            tx.update([pm.zero_view(n, p) for n, p in named.items()],
                      [grads[n] for n in named], state.opt_state,
                      grad_norm=grad_norm)
            # the update has read them: their room goes to the gather
            grads.clear()
            pm.gather_updated(named)
        for p in named.values():
            p.grad = None
        if integrity_every is not None:
            if (state.step + 1) % integrity_every == 0:
                metrics["integrity_fp"] = fingerprint(state.params)
            else:
                metrics["integrity_fp"] = torch.zeros(
                    len(pm.global_names) if pm.pp > 1
                    else len(state.params), dtype=torch.int32,
                    device=pm.device)
        state.step += 1
        return metrics

    shapes = set()

    def step(state: TrainState, batch: Mapping[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        batch = {k: torch.as_tensor(v).to(pm.device)
                 for k, v in batch.items()}
        shapes.add(tuple(sorted((k, tuple(v.shape), v.dtype)
                                for k, v in batch.items())))
        if scan_steps == 1:
            return state, one_step(state, batch)
        for name, x in batch.items():
            if x.shape[0] != scan_steps:
                raise ValueError(f"{name!r} has leading dim {x.shape[0]}, "
                                 f"want scan_steps = {scan_steps}")
        for i in range(scan_steps):
            metrics = one_step(state, {k: x[i] for k, x in batch.items()})
        return state, metrics

    def fingerprint(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        # the lazy import keeps the resilience package off the step's
        # import path unless a fingerprint is asked for
        from ..resilience import integrity

        if pm.pp > 1:
            return integrity.fingerprint_tree_stages(
                {n: t for n, t in params.items() if pm.owns(n)}, pm.specs,
                pm.global_names)
        if pm.world > 1:
            return integrity.fingerprint_tree_sharded(params, pm.specs)
        return integrity.fingerprint_tree(params)

    step.cache_size = lambda: len(shapes)
    step.fingerprint = fingerprint
    return step


def data_parallel_loss(model: torch.nn.Module,
                       batch: Mapping[str, torch.Tensor],
                       dropout_generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """This rank's default loss over its rows ``batch``: the model's loss,
    across data ranks the local mean weighted by the rank's share of the
    labels counted over the data ranks (not ``-100``), so that its mean
    over the data ranks is the mean over the global batch, as the
    reference's loss over the dp-sharded batch. A model with
    ``loss_parts`` (Mixtral) has only its cross-entropy weighted; its
    router terms are global or plain means already."""
    data = ps.DATA_AXES
    if comm.axis_size(data) == 1:
        return model.loss(batch["input_ids"], batch["labels"],
                          dropout_generator=dropout_generator)
    if hasattr(model, "loss_parts"):
        loss, extra = model.loss_parts(batch["input_ids"], batch["labels"],
                                       dropout_generator=dropout_generator)
    else:
        loss = model.loss(batch["input_ids"], batch["labels"],
                          dropout_generator=dropout_generator)
        extra = 0.0
    count = (batch["labels"] != -100).sum().float()
    total = comm.all_reduce(count, data)
    return loss * (count * comm.axis_size(data)
                   / torch.clamp(total, min=1.0)) + extra
