"""Speculative decoding: the greedy accept rules, the Medusa tree buffers,
the engine-facing :class:`SpeculationConfig`, and draft-model and Medusa
generation over the contiguous KV cache (counterpart of
``neuronx_distributed_tpu/inference/speculative.py``).

The accept rules and the tree are plain tensor code; they run wherever
their inputs lie. The generation loops keep the reference's cache
rollback: rejected rows are masked, not rewound — a rejected draft row's
stored position becomes PAD_POSITION, which the causal mask never passes,
so every round writes ``k + 1`` rows at the same cache index for every
batch row. The reference's ``lax.while_loop`` is a Python loop that reads
one flag a round to stop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.llama import LlamaForCausalLM, llama_forward_with_cache
from ..parallel.layers import Linear
from .kv_cache import PAD_POSITION, KVCache, init_kv_cache, write_slots


def verify_draft_greedy(target_logits: torch.Tensor,
                        draft_tokens: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy speculative acceptance.

    ``target_logits [B, K+1, V]``: the target's logits at each drafted
    position (position j conditions on the drafts before j);
    ``draft_tokens [B, K]``. Returns ``(num_accepted [B], next_tokens [B,
    K+1])``: ``next_tokens[:, j]`` is the target's greedy token at j, so a
    round emits the accepted drafts and then the target's token at the
    first mismatch (the bonus token when every draft was accepted)."""
    k = target_logits.shape[1] - 1
    greedy = torch.argmax(target_logits, dim=-1)          # [B, K+1]
    match = greedy[:, :k] == draft_tokens
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    return accepted, greedy


def top_k_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row in descending
    order, ties at the lower index first, as ``jax.lax.top_k`` orders
    them (``torch.topk`` promises no order among ties): a stable
    descending sort."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[..., :k]


@dataclass(frozen=True)
class MedusaBuffers:
    """Static tree-attention buffers (the reference's
    ``generate_medusa_buffers``), host tensors; :meth:`to` moves them."""

    tree_mask: torch.Tensor       # [T, T] ancestor mask over tree nodes
    tree_positions: torch.Tensor  # [T] depth of each node
    parent: torch.Tensor          # [T] parent node index (-1 for the root)
    head_of_node: torch.Tensor    # [T] which head proposed the node

    def to(self, device: torch.device) -> "MedusaBuffers":
        return MedusaBuffers(*(t.to(device) for t in (
            self.tree_mask, self.tree_positions, self.parent,
            self.head_of_node)))


def build_medusa_tree(tree_choices: Sequence[Tuple[int, ...]]
                      ) -> MedusaBuffers:
    """Tree buffers from path choices (each entry a path of head-candidate
    indices, e.g. ``((0,), (1,), (0, 0), (0, 1))``); node 0 is the root."""
    paths = [()] + [tuple(p) for p in tree_choices]
    index = {p: i for i, p in enumerate(paths)}
    t = len(paths)
    mask = torch.zeros((t, t), dtype=torch.bool)
    parent, depth, head = [], [], []
    for i, p in enumerate(paths):
        depth.append(len(p))
        parent.append(index[p[:-1]] if p else -1)
        head.append(p[-1] if p else -1)
        mask[i, [index[p[:j]] for j in range(len(p) + 1)]] = True
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return MedusaBuffers(tree_mask=mask, tree_positions=as_i32(depth),
                         parent=as_i32(parent), head_of_node=as_i32(head))


@dataclass(frozen=True)
class SpeculationConfig:
    """Engine-facing speculation knobs.

    ``speculation_length`` (k): drafted tokens per branch per round;
    ``num_branches`` (B): first-token branches verified by one tree
    forward of the target; ``max_spec_slots``: cap on the slots that
    speculate in one round (None: derived from the engine's token budget);
    ``slo_adaptive``: let a router toggle speculation from its SLO verdict;
    ``start_on``: initial toggle state; ``draft_cost_ratio``: draft-step
    cost relative to a target step, for a planner only."""

    speculation_length: int = 4
    num_branches: int = 1
    max_spec_slots: Optional[int] = None
    slo_adaptive: bool = False
    start_on: bool = True
    draft_cost_ratio: float = 0.15

    def __post_init__(self):
        if self.speculation_length < 1:
            raise ValueError("speculation_length must be >= 1")
        if self.num_branches < 1:
            raise ValueError("num_branches must be >= 1")

    @property
    def tree_size(self) -> int:
        """Nodes in the uniform verification tree (root + B chains of k)."""
        return 1 + self.num_branches * self.speculation_length

    def tree_choices(self) -> Tuple[Tuple[int, ...], ...]:
        """Uniform tree paths: a fan of ``num_branches`` at depth 1, chains
        below, branch-major: node ``(b, d)`` sits at ``1 + b * k + d - 1``
        in :func:`build_medusa_tree`'s node order."""
        k, nb = self.speculation_length, self.num_branches
        return tuple((b,) + (0,) * (d - 1)
                     for b in range(nb) for d in range(1, k + 1))


def branch_of_nodes(spec: SpeculationConfig) -> torch.Tensor:
    """``[T]`` branch index per tree node (-1 for the root) of the uniform
    tree of :meth:`SpeculationConfig.tree_choices` (host int64)."""
    idx = torch.arange(spec.tree_size)
    return torch.where(idx == 0, torch.full_like(idx, -1),
                       (idx - 1) // spec.speculation_length)


def medusa_accept_longest(tree_logits: torch.Tensor,
                          tree_tokens: torch.Tensor,
                          buffers: MedusaBuffers
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deepest tree path whose every node matches the target's greedy
    choice at its parent.

    ``tree_logits [B, T, V]``: the target's logits at each node;
    ``tree_tokens [B, T]``: the drafted token at each node (the root holds
    the committed token). Returns ``(best_node [B], accept_len [B])``; a
    tie in depth goes to the lowest node index, as ``jnp.argmax`` does."""
    dev = tree_logits.device
    buffers = buffers.to(dev)
    b, t = tree_tokens.shape
    greedy = torch.argmax(tree_logits, dim=-1)               # [B, T]
    parent = buffers.parent.long()
    at_parent = torch.gather(
        greedy, 1, parent.clamp(min=0)[None].expand(b, t))
    parent_greedy = torch.where(parent[None] >= 0, at_parent,
                                tree_tokens[:, :1].to(greedy.dtype))
    ok = parent_greedy == tree_tokens
    ok[:, 0] = True                                          # the root
    # a path is valid when every ancestor is: AND over the ancestor mask
    path_ok = torch.where(buffers.tree_mask[None], ok[:, None, :],
                          torch.ones_like(ok[:, None, :])).all(dim=-1)
    depth = torch.where(path_ok, buffers.tree_positions.long()[None],
                        torch.full_like(path_ok, -1, dtype=torch.long))
    best = torch.argmax(depth, dim=-1)
    accept_len = torch.gather(depth, 1, best[:, None])[:, 0]
    return best, accept_len


# ---------------------------------------------------------------------------
# draft-model speculative generation over the contiguous cache
# ---------------------------------------------------------------------------

def _mask_rejected_slots(cache: KVCache, start_index: int, num_slots: int,
                         accepted: torch.Tensor) -> KVCache:
    """In place: cache slots ``start_index + j`` with ``j > accepted`` get
    PAD_POSITION (the rollback that draft and Medusa speculation share)."""
    jj = torch.arange(num_slots, device=accepted.device)[None, :]
    at = write_slots(start_index, num_slots, cache.max_len)
    cache.pos[:, at] = cache.pos[:, at].masked_fill(jj > accepted[:, None],
                                                    PAD_POSITION)
    return cache


def _emit_and_scatter(out: torch.Tensor, filled: torch.Tensor,
                      drafted: torch.Tensor, greedy: torch.Tensor,
                      accepted: torch.Tensor, max_new_tokens: int):
    """Write the accepted drafts and the target's token at each row's own
    offset, in place; entries past ``max_new_tokens`` or past the accepted
    ones land in the sacrificial last column. Returns ``(out, emit,
    new_filled)``."""
    b, k = drafted.shape
    jj = torch.arange(k + 1, device=out.device)[None, :]
    emit = torch.where(jj < accepted[:, None],
                       F.pad(drafted, (0, 1)).to(greedy.dtype), greedy)
    valid = jj <= accepted[:, None]
    dest = filled[:, None] + jj
    dest = torch.where(valid & (dest < max_new_tokens), dest,
                       torch.full_like(dest, out.shape[1] - 1))
    rows = torch.arange(b, device=out.device)[:, None].expand_as(dest)
    out[rows, dest] = emit.to(out.dtype)
    return out, emit, torch.clamp(filled + accepted + 1, max=max_new_tokens)


def make_speculation_round_fn(model: LlamaForCausalLM,
                              draft_model: LlamaForCausalLM,
                              speculation_length: int, max_new_tokens: int,
                              forward: Callable = llama_forward_with_cache,
                              draft_forward: Callable =
                              llama_forward_with_cache):
    """One speculative round: ``(tcache, dcache, committed [B], pos [B],
    filled [B], out [B, max_new + K + 1]) -> (tcache, dcache, committed,
    pos, filled, out, accepted [B])``. Both caches are written in place and
    advance ``K + 1`` slots."""
    k = speculation_length

    def round_fn(tcache, dcache, committed, pos, filled, out):
        # 1. draft K tokens. The loop runs K+1 forwards, not K: forward j
        # writes token j's K/V and proposes token j+1, so a fully accepted
        # round needs the extra one to land draft token K's K/V (else the
        # next round drafts over a hole at pos + K); its proposal is
        # discarded
        tok, p, drafted = committed, pos, []
        for _ in range(k + 1):
            logits, dcache = draft_forward(draft_model, tok[:, None],
                                           p[:, None], dcache)
            tok = torch.argmax(logits[:, 0], dim=-1)
            p = p + 1
            drafted.append(tok)
        drafted = torch.stack(drafted, dim=1)[:, :k]           # [B, K]
        # 2. one target forward over [committed, drafts]
        block = torch.cat([committed[:, None], drafted], dim=1)
        positions = pos[:, None] + torch.arange(
            k + 1, dtype=pos.dtype, device=pos.device)[None, :]
        t_index = tcache.index
        logits, tcache = forward(model, block, positions, tcache)
        # 3. accept, 4. roll back (row j of the K+1 survives iff j <=
        # accepted, in both caches), 5. emit
        accepted, greedy = verify_draft_greedy(logits, drafted)
        _mask_rejected_slots(tcache, t_index, k + 1, accepted)
        _mask_rejected_slots(dcache, dcache.index - (k + 1), k + 1,
                             accepted)
        out, _, filled = _emit_and_scatter(out, filled, drafted, greedy,
                                           accepted, max_new_tokens)
        new_committed = torch.gather(greedy, 1, accepted[:, None])[:, 0]
        return (tcache, dcache, new_committed,
                pos + accepted.to(pos.dtype) + 1, filled, out, accepted)

    return round_fn


def _bucketed_prompts(model, input_ids, prompt_len, buckets):
    from .generation import pick_bucket

    dev = model.embed.embedding.device
    input_ids = torch.as_tensor(input_ids, dtype=torch.int32).to(dev)
    prompt_len = torch.as_tensor(prompt_len, dtype=torch.int32).to(dev)
    s = input_ids.shape[1]
    bucket = pick_bucket(s, buckets)
    if bucket > s:
        input_ids = F.pad(input_ids, (0, bucket - s))
    return input_ids, prompt_len, bucket


def _run_rounds(round_body, carry, filled_at: int, b: int,
                max_new_tokens: int):
    """The reference's ``while any(filled < max_new)`` loop: one flag read
    a round. Returns the final carry, accepted drafts summed, rounds."""
    acc_sum, rounds = 0, 0
    while bool((carry[filled_at] < max_new_tokens).any()):
        carry, accepted = round_body(carry)
        acc_sum += int(accepted.sum())
        rounds += 1
    return carry, {"mean_accepted": acc_sum / max(rounds * b, 1),
                   "rounds": rounds}


def speculative_generate(model: LlamaForCausalLM,
                         draft_model: LlamaForCausalLM, input_ids,
                         prompt_len, max_new_tokens: int,
                         speculation_length: int = 4,
                         buckets: Sequence[int] = (128, 512, 2048),
                         kv_dtype: Optional[torch.dtype] = None):
    """Greedy speculative decoding with a draft model, on the device of
    ``model``'s weights.

    The output equals the target's own greedy decoding for any draft.
    Returns ``(tokens [B, max_new_tokens], stats)`` with
    ``stats["mean_accepted"]``, the accepted drafts per row and round, and
    ``stats["rounds"]``."""
    from .generation import prefill

    input_ids, prompt_len, bucket = _bucketed_prompts(
        model, input_ids, prompt_len, buckets)
    b = input_ids.shape[0]
    dev = input_ids.device
    k = speculation_length
    cfg, dcfg = model.cfg, draft_model.cfg
    # both caches advance K+1 slots a round
    slack = max_new_tokens * (k + 1) + k + 2
    tcache = init_kv_cache(cfg.num_layers, b, bucket + slack,
                           cfg.num_kv_heads, cfg.head_dim_,
                           dtype=kv_dtype or cfg.dtype, device=dev)
    dcache = init_kv_cache(dcfg.num_layers, b, bucket + slack,
                           dcfg.num_kv_heads, dcfg.head_dim_,
                           dtype=kv_dtype or dcfg.dtype, device=dev)
    tlogits, tcache = prefill(model, input_ids, prompt_len, tcache)
    _, dcache = prefill(draft_model, input_ids, prompt_len, dcache)
    committed0 = torch.argmax(tlogits, dim=-1)
    out = torch.zeros((b, max_new_tokens + k + 1), dtype=torch.int32,
                      device=dev)
    out[:, 0] = committed0.to(torch.int32)
    round_fn = make_speculation_round_fn(model, draft_model, k,
                                         max_new_tokens)

    def body(carry):
        tcache, dcache, committed, pos, filled, out = carry
        *carry, accepted = round_fn(tcache, dcache, committed, pos, filled,
                                    out)
        return tuple(carry), accepted

    carry = (tcache, dcache, committed0, prompt_len,
             torch.ones((b,), dtype=torch.long, device=dev), out)
    carry, stats = _run_rounds(body, carry, 4, b, max_new_tokens)
    return carry[5][:, :max_new_tokens], stats


# ---------------------------------------------------------------------------
# Medusa: extra decode heads on the target propose the draft
# ---------------------------------------------------------------------------

class MedusaHeads(nn.Module):
    """K residual-MLP decode heads: head k predicts the token at offset
    k+1 from the current hidden state. Head k is ``res_k`` (a linear with
    bias, ``kernel [H, H]``, ``bias [H]``), ``z = h + silu(res_k(h))``,
    then ``head_k`` (``kernel [H, V]``, no bias), as the reference's
    ``ColumnParallelLinear`` pair; parameters are allocated uninitialised
    (load them, e.g. :func:`..models.convert.medusa_params_from_jax`)."""

    def __init__(self, hidden_size: int, vocab_size: int,
                 num_heads: int = 4, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size, self.vocab_size = hidden_size, vocab_size
        self.num_heads, self.dtype = num_heads, dtype
        for k in range(num_heads):
            res = Linear(hidden_size, hidden_size, dtype=dtype, device=dev,
                         param_dtype=param_dtype)
            res.bias = nn.Parameter(torch.empty(
                (hidden_size,), dtype=param_dtype, device=dev))
            setattr(self, f"res_{k}", res)
            setattr(self, f"head_{k}", Linear(
                hidden_size, vocab_size, dtype=dtype, device=dev,
                param_dtype=param_dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """``h [B, H]`` -> logits ``[B, K, V]``."""
        outs = []
        for k in range(self.num_heads):
            res = getattr(self, f"res_{k}")
            z = h + F.silu(res(h) + res.bias.to(self.dtype))
            outs.append(getattr(self, f"head_{k}")(z))
        return torch.stack(outs, dim=1)


@torch.no_grad()
def medusa_generate(model: LlamaForCausalLM, medusa: MedusaHeads, input_ids,
                    prompt_len, max_new_tokens: int,
                    buckets: Sequence[int] = (128, 512, 2048),
                    kv_dtype: Optional[torch.dtype] = None):
    """Greedy Medusa decoding (the top-1 path through the heads), on the
    device of ``model``'s weights. Like :func:`speculative_generate`, the
    output equals the target's own greedy decoding whatever the heads
    propose. Returns ``(tokens [B, max_new_tokens], stats)``."""
    input_ids, prompt_len, bucket = _bucketed_prompts(
        model, input_ids, prompt_len, buckets)
    b = input_ids.shape[0]
    dev = input_ids.device
    k = medusa.num_heads
    cfg = model.cfg
    slack = max_new_tokens * (k + 1) + k + 1
    tcache = init_kv_cache(cfg.num_layers, b, bucket + slack,
                           cfg.num_kv_heads, cfg.head_dim_,
                           dtype=kv_dtype or cfg.dtype, device=dev)
    ar = torch.arange(bucket, dtype=torch.int32, device=dev).expand(
        b, bucket)
    positions = torch.where(ar < prompt_len[:, None], ar,
                            torch.full_like(ar, PAD_POSITION))
    tlogits, tcache, hidden = llama_forward_with_cache(
        model, input_ids, positions, tcache, return_hidden=True)
    rows = torch.arange(b, device=dev)
    last = prompt_len.long() - 1
    committed0 = torch.argmax(tlogits[rows, last], dim=-1)
    h0 = hidden[rows, last]
    out = torch.zeros((b, max_new_tokens + k + 1), dtype=torch.int32,
                      device=dev)
    out[:, 0] = committed0.to(torch.int32)

    def body(carry):
        tcache, committed, h, pos, filled, out = carry
        # the heads draft the top-1 path from the current hidden state
        drafted = torch.argmax(medusa(h), dim=-1)              # [B, K]
        block = torch.cat([committed[:, None], drafted], dim=1)
        positions = pos[:, None] + torch.arange(
            k + 1, dtype=pos.dtype, device=dev)[None, :]
        t_index = tcache.index
        logits, tcache, hid = llama_forward_with_cache(
            model, block, positions, tcache, return_hidden=True)
        accepted, greedy = verify_draft_greedy(logits, drafted)
        _mask_rejected_slots(tcache, t_index, k + 1, accepted)
        out, _, filled = _emit_and_scatter(out, filled, drafted, greedy,
                                           accepted, max_new_tokens)
        new_committed = torch.gather(greedy, 1, accepted[:, None])[:, 0]
        # the hidden at the last accepted position feeds the next round's
        # heads
        new_h = hid[rows, accepted]
        return (tcache, new_committed, new_h,
                pos + accepted.to(pos.dtype) + 1, filled, out), accepted

    carry = (tcache, committed0, h0, prompt_len,
             torch.ones((b,), dtype=torch.long, device=dev), out)
    carry, stats = _run_rounds(body, carry, 4, b, max_new_tokens)
    return carry[5][:, :max_new_tokens], stats
