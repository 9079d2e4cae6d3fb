"""Cross-entropy losses at tp=1 (counterpart of
``neuronx_distributed_tpu/parallel/loss_functions.py``).

The vocab dim is whole on one rank, so the JAX package's pmax/psum over the
tp axis are identities here; what carries over is the arithmetic: the fp32
upcast, the max shift that carries no gradient, the label logit taken from
the shifted logits, ``ignore_index`` zeroing, and the mean over the tokens
that are not ignored. The sharded form comes with the parallel substrate.

:func:`fused_linear_cross_entropy` is the LM head and the loss in one,
chunked over the sequence so the ``[B, S, V]`` logits never exist at once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           ignore_index: Optional[int] = None
                           ) -> torch.Tensor:
    """Per-token cross-entropy: ``logits [..., V]``, integer ``labels
    [...]``; returns fp32 losses ``[...]``, 0 where ``labels ==
    ignore_index``."""
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    sum_exp = torch.exp(shifted).sum(dim=-1)
    vocab = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < vocab)
    safe = torch.where(valid, labels, 0)
    label_logit = torch.gather(shifted, -1, safe[..., None])[..., 0]
    label_logit = torch.where(valid, label_logit, 0.0)
    loss = torch.log(sum_exp) - label_logit
    if ignore_index is not None:
        loss = torch.where(labels == ignore_index, 0.0, loss)
    return loss


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is not
    ``ignore_index`` (at least one in the denominator)."""
    per_tok = parallel_cross_entropy(logits, labels,
                                     ignore_index=ignore_index)
    denom = torch.clamp((labels != ignore_index).sum(), min=1)
    return per_tok.sum() / denom


def _chunk_softmax_grad(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int, scale: torch.Tensor
                        ) -> torch.Tensor:
    """The cotangent of one chunk's logits for a loss cotangent ``scale``
    per token: ``scale (softmax - onehot(label))`` in fp32 (the onehot only
    for labels inside the vocabulary, as :func:`parallel_cross_entropy`
    takes the label logit), zero on ``ignore_index`` rows, cast to the
    logits' dtype as the backward of the fp32 upcast does."""
    l32 = logits.float()
    shifted = l32 - l32.amax(dim=-1, keepdim=True)
    e = torch.exp(shifted)
    d = e / e.sum(dim=-1, keepdim=True) * scale
    vocab = logits.shape[-1]
    valid = (labels >= 0) & (labels < vocab)
    safe = torch.where(valid, labels, 0)
    d.scatter_add_(-1, safe[..., None],
                   torch.where(valid, -scale, 0.0)[..., None].expand(
                       *safe.shape, 1).to(d.dtype))
    d = torch.where((labels == ignore_index)[..., None], 0.0, d)
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
    (``tests/test_torch_fused_loss_remat.py`` holds both to JAX)."""

    @staticmethod
    def forward(ctx, x, kernel, labels, ignore_index, chunk, dtype):
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
                logits, labels[:, at], ignore_index=ignore_index).sum()
        ctx.save_for_backward(x, kernel, labels, denom)
        ctx.meta = (s, ignore_index, chunk, dtype)
        return total / denom

    @staticmethod
    def backward(ctx, g):
        x, kernel, labels, denom = ctx.saved_tensors
        s, ignore_index, chunk, dtype = ctx.meta
        kern = kernel.to(dtype)
        scale = g.float() / denom
        dx = torch.empty(x.shape, dtype=dtype, device=x.device)
        # a frozen kernel (LoRA's base) gets no dW
        dw = torch.zeros_like(kern) if ctx.needs_input_grad[1] else None
        for c in reversed(range(x.shape[1] // chunk)):
            at = slice(c * chunk, (c + 1) * chunk)
            xc = x[:, at].to(dtype)
            dlogits = _chunk_softmax_grad(torch.matmul(xc, kern),
                                          labels[:, at], ignore_index, scale)
            dx[:, at] = torch.matmul(dlogits, kern.t())
            if dw is not None:
                dw = dw + torch.matmul(xc.flatten(0, 1).t(),
                                       dlogits.flatten(0, 1))
        return (dx[:, :s].to(x.dtype),
                None if dw is None else dw.to(kernel.dtype), None, None,
                None, None)


def fused_linear_cross_entropy(x: torch.Tensor, kernel: torch.Tensor,
                               labels: torch.Tensor,
                               ignore_index: int = -100, chunk: int = 512,
                               dtype: torch.dtype = torch.bfloat16
                               ) -> torch.Tensor:
    """The LM-head product and the mean causal-LM loss, chunked over the
    sequence (the JAX ``fused_linear_cross_entropy``,
    ``parallel/loss_functions.py:127-188``): ``x [B, S, H]``, ``kernel [H,
    V]``, ``labels [B, S]``. S is padded to a multiple of ``chunk`` with
    ``ignore_index``; each chunk's product runs in ``dtype`` and its loss
    in fp32. Peak memory is O(B chunk V) in the forward and the backward;
    the result equals :func:`causal_lm_loss` of ``x @ kernel`` up to the
    order of the sums."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return FusedLinearCrossEntropy.apply(x, kernel, labels, ignore_index,
                                         chunk, dtype)
