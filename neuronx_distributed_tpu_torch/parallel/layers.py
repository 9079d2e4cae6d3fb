"""The layers of ``neuronx_distributed_tpu/parallel/layers.py``.

At one tensor-parallel rank the column- and row-parallel linears are the
same product, ``x @ kernel`` with the kernel in the JAX layout ``[in,
out]``, so one :class:`Linear` stands for both in the model families, and
the output- and input-channel convolutions are the same convolution. The
large products stay ``torch.matmul``, as the JAX package leaves them to
XLA.

The sharded forms (:class:`ColumnParallelLinear`,
:class:`RowParallelLinear`, the vocab-sharded :class:`ParallelEmbedding`,
:class:`GQAQKVColumnParallelLinear` at ``tp_size > 1``,
:func:`embedding_attend`) are the reference's explicit (``shard_map``)
path: each rank holds its local shard, ``tp_size`` ranks of the tp group
(:mod:`.mesh`) together hold the layer, and the collectives are the
differentiable pairs of :mod:`.mappings`. At ``tp_size=1`` they compute
what :class:`Linear` does, with no collective. LoRA runs at tp=1 only, and
collective-matmul overlap and activation compression are not ported: the
sharded layers refuse adapters.

As in flax (``dtype`` and ``param_dtype``), each layer holds its weights in
``param_dtype`` (default: ``dtype``) and casts them, and its input, to the
compute ``dtype`` at use; no second copy of the weights is stored. With
fp32 weights and bf16 compute, gradients arrive in fp32.

LoRA (``lora_rank > 0``; scale ``lora_alpha / lora_rank``) keeps the
reference's order of operations in each layer, since the two forms round
differently: the linears and the convolutions add the adapter in
activation space, ``y = x W + scale * ((x_l A) B)`` in the compute dtype
with the bias after; the embedding adds ``scale * lookup(A, ids) @ B``;
the fused QKV folds ``W + scale * A @ B`` in the parameter dtype (weight
space) unless dropout is live, when it too adds in activation space.
``x_l`` is the input under :func:`dropout` (JAX ``_lora_input``), live
only when ``lora_dropout > 0`` and the caller passes a ``lora_generator``,
as flax drops only with a ``"dropout"`` rng; the frozen base product
always sees ``x`` itself. Every factor is a parameter held in
``param_dtype``; :func:`..models.llama.init_state_dict` makes the zero
factor the reference zero-initialises (B, or A for the embedding), so a
fresh adapter leaves the output as it was.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import mappings
from . import mesh as ps


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _local(n: int, tp: int, what: str) -> int:
    """The local size of a dim of ``n`` sharded over ``tp`` ranks."""
    if n % tp:
        raise ValueError(f"{what} {n} not divisible by tp {tp}")
    return n // tp


def _refuse_lora_at_tp(tp_size: int, lora_rank: int) -> None:
    if tp_size > 1 and lora_rank:
        raise ValueError(f"LoRA at tp_size={tp_size}: not in the port yet "
                         "(adapters run at tp=1)")


def _enter(x: torch.Tensor, sequence_parallel: bool,
           seq_dim: int, axis: ps.Axis = ps.TP_AXIS) -> torch.Tensor:
    """Enter the TP region: all-gather the sequence (backward
    reduce-scatter) under sequence parallelism, else identity (backward
    all-reduce over ``axis``)."""
    if sequence_parallel:
        return mappings.gather_from_sequence_parallel_region(
            x, ps.TP_AXIS, seq_dim, to_model_parallel=True)
    return mappings.copy_to_tensor_parallel_region(x, axis)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y + bias`` with the bias cast to ``y``'s (compute) dtype, as the
    JAX layers add it."""
    return y if bias is None else y + bias.to(y.dtype)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - p``
    and scale the kept ones by ``1 / (1 - p)``; ``x`` unchanged without a
    generator or at ``p == 0``. The masks come from ``generator``, so they
    differ from flax's; their law does not."""
    if generator is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class _LoraFactors:
    """The adapter fields every LoRA-capable layer shares."""

    def _lora_init(self, lora_rank: int, lora_alpha: float,
                   lora_dropout: float) -> None:
        self.lora_rank = lora_rank
        self.lora_scale = lora_alpha / lora_rank if lora_rank else 0.0
        self.lora_dropout = lora_dropout

    def _adapter(self, x_l: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
        """``scale * ((x_l A) B)`` in the compute dtype."""
        return self.lora_scale * torch.matmul(
            torch.matmul(x_l, a.to(self.dtype)), b.to(self.dtype))


class Linear(nn.Module, _LoraFactors):
    """``ColumnParallelLinear`` / ``RowParallelLinear`` at tp=1: ``y = x @
    kernel``, plus ``bias [out]`` with ``use_bias`` (Llama uses none; the
    GPT-NeoX, BERT and ViT projections do). With ``lora_rank`` the adapter
    ``lora_a [in, r]``, ``lora_b [r, out]`` adds in activation space
    (JAX ``:170-175``, ``:455-468``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 use_bias: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.kernel = _empty((in_features, out_features), pdt, device)
        self.bias = _empty((out_features,), pdt, device) if use_bias else None
        self._lora_init(lora_rank, lora_alpha, lora_dropout)
        self.lora_a = self.lora_b = None
        if lora_rank:
            self.lora_a = _empty((in_features, lora_rank), pdt, device)
            self.lora_b = _empty((lora_rank, out_features), pdt, device)

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.to(self.dtype)
        y = torch.matmul(x, self.kernel.to(self.dtype))
        if self.lora_a is not None:
            y = y + self._adapter(
                dropout(x, self.lora_dropout, lora_generator),
                self.lora_a, self.lora_b)
        return _add_bias(y, self.bias)


class ParallelEmbedding(nn.Module, _LoraFactors):
    """Vocab embedding: a row lookup in ``embedding [V, H]``, cast to
    ``dtype``. At ``tp_size > 1`` each rank holds the rows of its vocab
    shard ``[V / tp, H]``, looks up the ids inside it, zeroes the others
    and all-reduces (JAX ``:483``). The lookup is ``F.embedding``, whose backward sums a
    row's gradients in a fixed order: the backward of an indexed read
    (``index_put_`` with accumulate) gave other bits from run to run on
    the CPU, which broke bitwise resume and remat checks. With
    ``lora_rank``, ``out + scale * lookup(lora_a, ids) @ lora_b`` (``lora_a
    [V, r]``, ``lora_b [r, H]``; JAX ``:513-533``); the input is ids, so
    ``lora_dropout`` is accepted and never applied, as in the reference.
    ``axis`` names the ranks the vocab is sharded over, ``tp_size`` of
    them: ``(pp, tp)`` for a pipeline's ``vocab_pp`` table (JAX
    ``axis=``)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_dropout: float = 0.0, tp_size: int = 1,
                 axis: ps.Axis = ps.TP_AXIS):
        super().__init__()
        _refuse_lora_at_tp(tp_size, lora_rank)
        self.dtype, self.tp_size, self.axis = dtype, tp_size, axis
        pdt = param_dtype or dtype
        num_embeddings = _local(num_embeddings, tp_size, "vocab")
        self.embedding = _empty((num_embeddings, features), pdt, device)
        self._lora_init(lora_rank, lora_alpha, lora_dropout)
        self.lora_a = self.lora_b = None
        if lora_rank:
            self.lora_a = _empty((num_embeddings, lora_rank), pdt, device)
            self.lora_b = _empty((lora_rank, features), pdt, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        if self.tp_size > 1:
            local = self.embedding.shape[0]
            ids = ids - ps.axis_rank(self.axis) * local
            valid = (ids >= 0) & (ids < local)
            out = F.embedding(torch.where(valid, ids, 0),
                              self.embedding).to(self.dtype)
            out = torch.where(valid[..., None], out, 0.0)
            return mappings.reduce_from_tensor_parallel_region(out,
                                                               self.axis)
        out = F.embedding(ids, self.embedding).to(self.dtype)
        if self.lora_a is not None:
            out = out + self.lora_scale * torch.matmul(
                F.embedding(ids, self.lora_a).to(self.dtype),
                self.lora_b.to(self.dtype))
        return out


class GQAQKVColumnParallelLinear(nn.Module, _LoraFactors):
    """Fused Q/K/V projection with grouped-query attention:
    ``q_kernel [H, N*D]``, ``k_kernel``/``v_kernel`` ``[H, KV*D]``, and with
    ``use_bias`` ``q_bias [N*D]``, ``k_bias``/``v_bias`` ``[KV*D]``. With
    ``lora_rank`` each kernel has ``{q,k,v}_lora_a [H, r]`` and
    ``{q,k,v}_lora_b [r, out]``, folded into the kernel in the parameter
    dtype (``wq + scale * (qa @ qb)``, then cast: JAX ``:634-662``), or,
    when dropout is live, added in activation space with one dropped input
    for the three (``:738-745``).

    At ``tp_size > 1`` (JAX ``:547``) each rank holds ``N / tp`` query
    heads, and ``KV / tp`` kv heads when tp divides them. When ``KV < tp``
    the kv kernels stay whole (true GQA, one stored copy per kv head: the
    reference's ``kv_size_multiplier = tp / KV``): rank ``r`` takes head
    ``r // kv_size_multiplier`` from the replicated kernel behind
    ``copy_to_tensor_parallel_region``, whose backward sums every rank's
    head-slice gradient. The input enters the TP region by identity, or
    by the sequence all-gather with ``sequence_parallel``."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.bfloat16,
                 device=None, param_dtype: Optional[torch.dtype] = None,
                 use_bias: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_dropout: float = 0.0,
                 tp_size: int = 1, sequence_parallel: bool = False,
                 seq_dim: int = 1):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        _refuse_lora_at_tp(tp_size, lora_rank)
        mult = max(1, tp_size // num_kv_heads)
        if mult > 1 and tp_size % num_kv_heads:
            raise ValueError(
                f"tp size {tp_size} must be a multiple of num_kv_heads "
                f"{num_kv_heads} when tp > num_kv_heads")
        if mult == 1 and num_kv_heads % tp_size:
            raise ValueError(f"num_kv_heads {num_kv_heads} not divisible "
                             f"by tp {tp_size}")
        self.dtype, self.head_dim = dtype, head_dim
        self.tp_size, self.kv_size_multiplier = tp_size, mult
        self.sequence_parallel, self.seq_dim = sequence_parallel, seq_dim
        pdt = param_dtype or dtype
        kv = num_kv_heads * head_dim
        widths = {"q": _local(num_heads * head_dim, tp_size, "q features"),
                  "k": kv if mult > 1 else kv // tp_size,
                  "v": kv if mult > 1 else kv // tp_size}
        self.q_kernel = _empty((hidden, widths["q"]), pdt, device)
        self.k_kernel = _empty((hidden, widths["k"]), pdt, device)
        self.v_kernel = _empty((hidden, widths["v"]), pdt, device)
        self.q_bias = self.k_bias = self.v_bias = None
        if use_bias:
            self.q_bias = _empty((widths["q"],), pdt, device)
            self.k_bias = _empty((widths["k"],), pdt, device)
            self.v_bias = _empty((widths["v"],), pdt, device)
        self._lora_init(lora_rank, lora_alpha, lora_dropout)
        if lora_rank:
            for j, width in widths.items():
                setattr(self, f"{j}_lora_a",
                        _empty((hidden, lora_rank), pdt, device))
                setattr(self, f"{j}_lora_b",
                        _empty((lora_rank, width), pdt, device))

    def _kv_head(self, w: Optional[torch.Tensor], dim: int
                 ) -> Optional[torch.Tensor]:
        """This rank's kv head of a replicated kv kernel or bias."""
        if w is None:
            return None
        w = mappings.copy_to_tensor_parallel_region(w)
        head = ps.get_tensor_model_parallel_rank() // self.kv_size_multiplier
        return w.narrow(dim, head * self.head_dim, self.head_dim)

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        kernels = [self.q_kernel, self.k_kernel, self.v_kernel]
        biases = [self.q_bias, self.k_bias, self.v_bias]
        if self.tp_size > 1:
            x = _enter(x, self.sequence_parallel, self.seq_dim)
            if self.kv_size_multiplier > 1:
                kernels[1:] = [self._kv_head(w, 1) for w in kernels[1:]]
                biases[1:] = [self._kv_head(b, 0) for b in biases[1:]]
        x = x.to(self.dtype)
        live = (self.lora_rank > 0 and self.lora_dropout > 0.0
                and lora_generator is not None)
        factors = [(getattr(self, f"{j}_lora_a"), getattr(self, f"{j}_lora_b"))
                   for j in "qkv"] if self.lora_rank else []
        if factors and not live:
            kernels = [w + self.lora_scale * (a @ b)
                       for w, (a, b) in zip(kernels, factors)]
        outs = [torch.matmul(x, w.to(self.dtype)) for w in kernels]
        if live:
            x_l = dropout(x, self.lora_dropout, lora_generator)
            outs = [y + self._adapter(x_l, a, b)
                    for y, (a, b) in zip(outs, factors)]
        return tuple(_add_bias(y, b) for y, b in zip(outs, biases))


Padding = Union[str, Sequence[Tuple[int, int]]]


def _same_pads(size: Sequence[int], kernel: Sequence[int],
               strides: Sequence[int]):
    """XLA's ``SAME`` padding: each output dim ``ceil(n / stride)``, the
    needed padding split with the odd element at the end."""
    pads = []
    for n, k, s in zip(size, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              strides: Sequence[int] = (1, 1),
              padding: Padding = "SAME") -> torch.Tensor:
    """``jax.lax.conv_general_dilated`` with ``("NHWC", "HWIO", "NHWC")``:
    ``x [B, H, W, Cin]``, ``kernel [kh, kw, Cin, Cout]``, ``padding``
    ``"SAME"``, ``"VALID"`` or ``((lo, hi), (lo, hi))``."""
    kh, kw = kernel.shape[:2]
    if padding == "SAME":
        pads = _same_pads(x.shape[1:3], (kh, kw), strides)
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    elif isinstance(padding, str):
        raise ValueError(f"unknown padding {padding!r}")
    else:
        pads = [tuple(p) for p in padding]
    x = F.pad(x.permute(0, 3, 1, 2),
              (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


class _ChannelParallelConv2d(nn.Module, _LoraFactors):
    """A conv2d over NHWC inputs with an HWIO ``kernel [kh, kw, Cin,
    Cout]`` and ``bias [Cout]`` (``use_bias``), computed in ``dtype``.
    With ``lora_rank``, the reference's conv adapter: ``lora_a [kh, kw,
    Cin, r]``, a conv of the base's geometry into the rank, then ``lora_b
    [1, 1, r, Cout]``, a 1x1 conv out of it, added in activation space
    before the bias."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.strides, self.padding = tuple(strides), padding
        pdt = param_dtype or dtype
        kh, kw = kernel_size
        self.kernel = _empty((kh, kw, in_features, features), pdt, device)
        self.bias = _empty((features,), pdt, device) if use_bias else None
        self._lora_init(lora_rank, lora_alpha, lora_dropout)
        self.lora_a = self.lora_b = None
        if lora_rank:
            self.lora_a = _empty((kh, kw, in_features, lora_rank), pdt,
                                 device)
            self.lora_b = _empty((1, 1, lora_rank, features), pdt, device)

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        dt = self.dtype
        y = conv_nhwc(x.to(dt), self.kernel.to(dt), self.strides,
                      self.padding)
        if self.lora_a is not None:
            # the reference drops the input before its cast
            x_l = dropout(x, self.lora_dropout, lora_generator)
            ya = conv_nhwc(x_l.to(dt), self.lora_a.to(dt), self.strides,
                           self.padding)
            y = y + self.lora_scale * conv_nhwc(ya, self.lora_b.to(dt),
                                                (1, 1), "VALID")
        return _add_bias(y, self.bias)


class OutputChannelParallelConv2d(_ChannelParallelConv2d):
    """JAX ``OutputChannelParallelConv2d`` (``parallel/layers.py:188``) at
    tp=1, where its output-channel shard is the whole kernel."""


class InputChannelParallelConv2d(_ChannelParallelConv2d):
    """JAX ``InputChannelParallelConv2d`` (``parallel/layers.py:260``) at
    tp=1, where its input-channel shard is the whole kernel and the exit
    all-reduce is the identity."""


def embedding_attend(table: torch.Tensor, x: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16, *,
                     tp_size: int = 1, sequence_parallel: bool = False,
                     seq_dim: int = 1, gather_output: bool = False,
                     axis: ps.Axis = ps.TP_AXIS) -> torch.Tensor:
    """The tied LM head: ``x @ table^T`` in ``dtype`` (JAX
    ``embedding_attend``, ``:326``); the table's gradient sums over both
    its uses. At ``tp_size > 1`` the table is the vocab shard over
    ``axis``, ``x`` enters the TP region as in
    :class:`ColumnParallelLinear`, and the logits stay vocab-sharded
    unless ``gather_output``."""
    if tp_size > 1:
        x = _enter(x, sequence_parallel, seq_dim, axis)
    y = torch.matmul(x.to(dtype), table.to(dtype).t())
    if tp_size > 1 and gather_output:
        y = mappings.gather_from_tensor_parallel_region(y, axis, -1)
    return y


class ColumnParallelLinear(Linear):
    """Linear with the output features sharded over tp (JAX ``:73``):
    ``kernel [in, out / tp]`` (and ``bias [out / tp]``). The input enters
    the TP region by identity (backward all-reduce), or by the sequence
    all-gather with ``sequence_parallel`` (backward reduce-scatter); the
    output stays sharded unless ``gather_output``. At ``tp_size=1`` it is
    :class:`Linear`. ``axis`` names the ``tp_size`` ranks the output
    features are sharded over: ``(pp, tp)`` for a pipeline's ``vocab_pp``
    LM head (JAX ``axis=``)."""

    def __init__(self, in_features: int, out_features: int,
                 gather_output: bool = False,
                 sequence_parallel: bool = False, tp_size: int = 1,
                 seq_dim: int = 1, axis: ps.Axis = ps.TP_AXIS, **kw):
        _refuse_lora_at_tp(tp_size, kw.get("lora_rank", 0))
        super().__init__(in_features,
                         _local(out_features, tp_size, "out_features"), **kw)
        self.tp_size, self.gather_output = tp_size, gather_output
        self.sequence_parallel, self.seq_dim = sequence_parallel, seq_dim
        self.axis = axis

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.tp_size == 1:
            return super().forward(x, lora_generator)
        y = super().forward(_enter(x, self.sequence_parallel, self.seq_dim,
                                   self.axis))
        if self.gather_output:
            y = mappings.gather_from_tensor_parallel_region(y, self.axis, -1)
        return y


class RowParallelLinear(Linear):
    """Linear with the input features sharded over tp (JAX ``:353``):
    ``kernel [in / tp, out]``, ``bias [out]`` added after the exit
    collective. The partial products leave the TP region by all-reduce,
    or by reduce-scatter along the sequence with ``sequence_parallel``;
    ``input_is_parallel=False`` first splits a replicated input. At
    ``tp_size=1`` it is :class:`Linear`."""

    def __init__(self, in_features: int, out_features: int,
                 input_is_parallel: bool = True,
                 sequence_parallel: bool = False, tp_size: int = 1,
                 seq_dim: int = 1, **kw):
        _refuse_lora_at_tp(tp_size, kw.get("lora_rank", 0))
        super().__init__(_local(in_features, tp_size, "in_features"),
                         out_features, **kw)
        self.tp_size, self.input_is_parallel = tp_size, input_is_parallel
        self.sequence_parallel, self.seq_dim = sequence_parallel, seq_dim

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.tp_size == 1:
            return super().forward(x, lora_generator)
        if not self.input_is_parallel:
            x = mappings.scatter_to_tensor_parallel_region(x, ps.TP_AXIS, -1)
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.sequence_parallel:
            y = mappings.reduce_scatter_to_sequence_parallel_region(
                y, ps.TP_AXIS, self.seq_dim)
        else:
            y = mappings.reduce_from_tensor_parallel_region(y, ps.TP_AXIS)
        return _add_bias(y, self.bias)


class SPMDRank(nn.Module):
    """This rank's tp index as a parameter (JAX ``:759``, reference
    ``layers.py:1543``): ``rank int32 [1]``, so a traced graph can read
    the rank without a host value; ``forward`` returns it as a 0-dim
    tensor."""

    def __init__(self, device=None):
        super().__init__()
        r = (ps.get_tensor_model_parallel_rank()
             if ps.model_parallel_is_initialized() else 0)
        self.rank = nn.Parameter(torch.tensor([r], dtype=torch.int32,
                                              device=device),
                                 requires_grad=False)

    def forward(self) -> torch.Tensor:
        return self.rank[0]
