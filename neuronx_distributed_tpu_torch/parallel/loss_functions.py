"""Vocab-parallel cross-entropy (counterpart of
``neuronx_distributed_tpu/parallel/loss_functions.py``, JAX ``:37-188``).

The logits' last dim is this rank's vocab shard (the whole vocabulary at
tp=1, where every collective below is the identity): the max shift is a
max all-reduce that carries no gradient, the sum of exponents and the label
logit (taken from the shifted logits, only for labels inside the shard)
are sums over tp through ``reduce_from_tensor_parallel_region``, so the
full ``[..., V]`` logits never exist on one rank. Then ``ignore_index``
zeroing and the mean over the tokens that are not ignored, with the fp32
upcast throughout.

:func:`fused_linear_cross_entropy` is the LM head and the loss in one,
chunked over the sequence so the ``[B, S, V]`` logits never exist at once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import comm, mappings
from . import mesh as ps


def _shard_start(axis: ps.Axis, vocab_local: int) -> int:
    return (ps.axis_rank(axis) * vocab_local
            if comm.axis_size(axis) > 1 else 0)


def _global_max(logits: torch.Tensor, axis: ps.Axis) -> torch.Tensor:
    """The max over the whole vocabulary, ``[..., 1]``, no gradient."""
    return comm.all_reduce(logits.amax(dim=-1, keepdim=True).detach(),
                           axis, op="max")


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           ignore_index: Optional[int] = None,
                           axis: ps.Axis = ps.TP_AXIS,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token cross-entropy: ``logits [..., V_local]`` (this rank's
    vocab shard), integer global ``labels [...]``; returns fp32 losses
    ``[...]``, 0 where ``labels == ignore_index``."""
    logits = logits.float()
    vocab_local = logits.shape[-1]
    shifted = logits - _global_max(logits, axis)
    sum_exp = mappings.reduce_from_tensor_parallel_region(
        torch.exp(shifted).sum(dim=-1), axis)
    labels = labels.long()
    local = labels - _shard_start(axis, vocab_local)
    valid = (local >= 0) & (local < vocab_local)
    safe = torch.where(valid, local, 0)
    label_logit = torch.gather(shifted, -1, safe[..., None])[..., 0]
    label_logit = mappings.reduce_from_tensor_parallel_region(
        torch.where(valid, label_logit, 0.0), axis)
    loss = torch.log(sum_exp) - label_logit
    if label_smoothing > 0.0:
        vocab = vocab_local * comm.axis_size(axis)
        mean_logit = mappings.reduce_from_tensor_parallel_region(
            shifted.sum(dim=-1), axis) / vocab
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (
            torch.log(sum_exp) - mean_logit)
    if ignore_index is not None:
        loss = torch.where(labels == ignore_index, 0.0, loss)
    return loss


def distributed_log_softmax(logits: torch.Tensor,
                            axis: ps.Axis = ps.TP_AXIS) -> torch.Tensor:
    """Log-softmax over the sharded vocab dim (reference
    ``DistributedLogprob:152``): this rank's shard of the fp32 log-probs."""
    logits = logits.float()
    shifted = logits - _global_max(logits, axis)
    sum_exp = mappings.reduce_from_tensor_parallel_region(
        torch.exp(shifted).sum(dim=-1), axis)
    return shifted - torch.log(sum_exp)[..., None]


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100,
                   axis: ps.Axis = ps.TP_AXIS) -> torch.Tensor:
    """Mean vocab-parallel cross-entropy over the tokens whose label is
    not ``ignore_index`` (at least one in the denominator)."""
    per_tok = parallel_cross_entropy(logits, labels,
                                     ignore_index=ignore_index, axis=axis)
    denom = torch.clamp((labels != ignore_index).sum(), min=1)
    return per_tok.sum() / denom


def _chunk_softmax_grad(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int, scale: torch.Tensor,
                        axis: ps.Axis = ps.TP_AXIS) -> torch.Tensor:
    """The cotangent of one chunk's (vocab-shard) logits for a loss
    cotangent ``scale`` per token: ``scale (softmax - onehot(label))`` in
    fp32, the softmax over the whole vocabulary (its max and sum over tp),
    the onehot only for labels inside this shard, as
    :func:`parallel_cross_entropy` takes the label logit; zero on
    ``ignore_index`` rows, cast to the logits' dtype as the backward of the
    fp32 upcast does."""
    l32 = logits.float()
    shifted = l32 - _global_max(l32, axis)
    e = torch.exp(shifted)
    d = e / comm.all_reduce(e.sum(dim=-1, keepdim=True), axis) * scale
    vocab = logits.shape[-1]
    labels = labels - _shard_start(axis, vocab)
    valid = (labels >= 0) & (labels < vocab)
    safe = torch.where(valid, labels, 0)
    d.scatter_add_(-1, safe[..., None],
                   torch.where(valid, -scale, 0.0)[..., None].expand(
                       *safe.shape, 1).to(d.dtype))
    d = torch.where((labels + _shard_start(axis, vocab)
                     == ignore_index)[..., None], 0.0, d)
    return d.to(logits.dtype)


class FusedLinearCrossEntropy(torch.autograd.Function):
    """Forward: ``sum over chunks of CE(x_c @ W)`` over ``denom``, no
    chunk's logits kept. Backward: each chunk's logits recomputed (one more
    chunk product, as the reference's ``nothing_saveable`` chunk body),
    then ``dx_c = dlogits_c W^T`` and ``dW += x_c^T dlogits_c``.

    ``dW`` sums in ``dtype`` over the chunks taken last to first: the
    reference's ``kern`` is a bf16 value closed over by a ``lax.scan``,
    whose transpose accumulates its cotangent in the carry, in bf16, from
    the last chunk back; the sum is cast to the kernel's dtype at the end
    (``tests/test_torch_fused_loss_remat.py`` holds both to JAX).

    At tp > 1 ``kernel`` is this rank's vocab shard and the softmax's max
    and sums go over ``axis``; ``dx`` is then this shard's partial sum,
    which the caller's entry into the TP region reduces."""

    @staticmethod
    def forward(ctx, x, kernel, labels, ignore_index, chunk, dtype,
                axis=ps.TP_AXIS):
        b, s, _ = x.shape
        nc = -(-s // chunk)
        pad = nc * chunk - s
        labels = labels.long()
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=ignore_index)
        denom = torch.clamp((labels != ignore_index).sum(), min=1)
        kern = kernel.to(dtype)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(nc):
            at = slice(c * chunk, (c + 1) * chunk)
            logits = torch.matmul(x[:, at].to(dtype), kern)
            total = total + parallel_cross_entropy(
                logits, labels[:, at], ignore_index=ignore_index,
                axis=axis).sum()
        ctx.save_for_backward(x, kernel, labels, denom)
        ctx.meta = (s, ignore_index, chunk, dtype, axis)
        return total / denom

    @staticmethod
    def backward(ctx, g):
        x, kernel, labels, denom = ctx.saved_tensors
        s, ignore_index, chunk, dtype, axis = ctx.meta
        kern = kernel.to(dtype)
        scale = g.float() / denom
        dx = torch.empty(x.shape, dtype=dtype, device=x.device)
        # a frozen kernel (LoRA's base) gets no dW
        dw = torch.zeros_like(kern) if ctx.needs_input_grad[1] else None
        for c in reversed(range(x.shape[1] // chunk)):
            at = slice(c * chunk, (c + 1) * chunk)
            xc = x[:, at].to(dtype)
            dlogits = _chunk_softmax_grad(torch.matmul(xc, kern),
                                          labels[:, at], ignore_index, scale,
                                          axis)
            dx[:, at] = torch.matmul(dlogits, kern.t())
            if dw is not None:
                dw = dw + torch.matmul(xc.flatten(0, 1).t(),
                                       dlogits.flatten(0, 1))
        return (dx[:, :s].to(x.dtype),
                None if dw is None else dw.to(kernel.dtype), None, None,
                None, None, None)


def fused_linear_cross_entropy(x: torch.Tensor, kernel: torch.Tensor,
                               labels: torch.Tensor,
                               ignore_index: int = -100, chunk: int = 512,
                               dtype: torch.dtype = torch.bfloat16,
                               axis: ps.Axis = ps.TP_AXIS) -> torch.Tensor:
    """The LM-head product and the mean causal-LM loss, chunked over the
    sequence (the JAX ``fused_linear_cross_entropy``,
    ``parallel/loss_functions.py:127-188``): ``x [B, S, H]``, ``kernel [H,
    V]``, ``labels [B, S]``. S is padded to a multiple of ``chunk`` with
    ``ignore_index``; each chunk's product runs in ``dtype`` and its loss
    in fp32. Peak memory is O(B chunk V) in the forward and the backward;
    the result equals :func:`causal_lm_loss` of ``x @ kernel`` up to the
    order of the sums. At tp > 1, ``kernel [H, V_local]`` is the vocab
    shard and ``x`` must already be inside the TP region (the caller makes
    the ``copy_to`` or sequence gather a column-parallel head would)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return FusedLinearCrossEntropy.apply(x, kernel, labels, ignore_index,
                                         chunk, dtype, axis)
