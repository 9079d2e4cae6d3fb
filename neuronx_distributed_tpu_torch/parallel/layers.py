"""The tp=1 forward of the layers the model families use from
``neuronx_distributed_tpu/parallel/layers.py``.

At one tensor-parallel rank the column- and row-parallel linears are the
same product, ``x @ kernel`` with the kernel in the JAX layout ``[in,
out]``, so one :class:`Linear` stands for both, and the output- and
input-channel convolutions are the same convolution. The large products
stay ``torch.matmul``, as the JAX package leaves them to XLA. The sharded
forms come with the parallel substrate in a later slice.

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


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


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
    """Vocab embedding at tp=1: a row lookup in ``embedding [V, H]``, cast
    to ``dtype``. The lookup is ``F.embedding``, whose backward sums a
    row's gradients in a fixed order: the backward of an indexed read
    (``index_put_`` with accumulate) gave other bits from run to run on
    the CPU, which broke bitwise resume and remat checks. With
    ``lora_rank``, ``out + scale * lookup(lora_a, ids) @ lora_b`` (``lora_a
    [V, r]``, ``lora_b [r, H]``; JAX ``:513-533``); the input is ids, so
    ``lora_dropout`` is accepted and never applied, as in the reference."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.embedding = _empty((num_embeddings, features), pdt, device)
        self._lora_init(lora_rank, lora_alpha, lora_dropout)
        self.lora_a = self.lora_b = None
        if lora_rank:
            self.lora_a = _empty((num_embeddings, lora_rank), pdt, device)
            self.lora_b = _empty((lora_rank, features), pdt, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        out = F.embedding(ids, self.embedding).to(self.dtype)
        if self.lora_a is not None:
            out = out + self.lora_scale * torch.matmul(
                F.embedding(ids, self.lora_a).to(self.dtype),
                self.lora_b.to(self.dtype))
        return out


class GQAQKVColumnParallelLinear(nn.Module, _LoraFactors):
    """Fused Q/K/V projection with grouped-query attention at tp=1:
    ``q_kernel [H, N*D]``, ``k_kernel``/``v_kernel`` ``[H, KV*D]``, and with
    ``use_bias`` ``q_bias [N*D]``, ``k_bias``/``v_bias`` ``[KV*D]``. With
    ``lora_rank`` each kernel has ``{q,k,v}_lora_a [H, r]`` and
    ``{q,k,v}_lora_b [r, out]``, folded into the kernel in the parameter
    dtype (``wq + scale * (qa @ qb)``, then cast: JAX ``:634-662``), or,
    when dropout is live, added in activation space with one dropped input
    for the three (``:738-745``)."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.bfloat16,
                 device=None, param_dtype: Optional[torch.dtype] = None,
                 use_bias: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_dropout: float = 0.0):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        self.dtype = dtype
        pdt = param_dtype or dtype
        widths = {"q": num_heads * head_dim, "k": num_kv_heads * head_dim,
                  "v": num_kv_heads * head_dim}
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

    def forward(self, x: torch.Tensor,
                lora_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        kernels = [self.q_kernel, self.k_kernel, self.v_kernel]
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
        return tuple(_add_bias(y, b) for y, b in zip(
            outs, (self.q_bias, self.k_bias, self.v_bias)))


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
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The tied LM head at tp=1: ``x @ table^T`` in ``dtype`` (JAX
    ``embedding_attend``); the table's gradient sums over both its uses."""
    return torch.matmul(x.to(dtype), table.to(dtype).t())
