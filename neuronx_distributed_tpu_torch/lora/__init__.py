"""LoRA adapters at tp=1 (counterpart of ``neuronx_distributed_tpu/lora``).

The adapters live inside the parallel layers (``lora_rank`` of
:mod:`..parallel.layers`, the fused MLP of :mod:`..models.llama`), and the
reference's pytree utilities work here on the port's flat state dicts,
whose names are the JAX paths joined by dots (``layers.3.attn.qkv.
q_lora_a``, ``layers.3.mlp.lora_b``, ``embed.lora_a``):

* :func:`lora_mask`: ``{name: is an adapter}``;
* :func:`make_lora_optimizer`: freezes every parameter that is not an
  adapter (``requires_grad=False``), so autograd computes no gradient for
  the base and the optimizer keeps moments for the adapters only, and the
  base stays bit for bit (the reference's ``optax.multi_transform`` with
  ``set_to_zero`` on the frozen leaves);
* :func:`extract_lora_state` / :func:`merge_lora_state`: adapter-only
  checkpoints;
* :func:`merge_lora_params`: fold ``scale * A @ B`` into the base kernels
  for serving without adapters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import torch

LORA_KEYS = ("lora_a", "lora_b", "q_lora_a", "q_lora_b", "k_lora_a",
             "k_lora_b", "v_lora_a", "v_lora_b")

# (kernel key, A key, B key) triples that merge_lora_params folds together;
# the fused MLP's gate_up_kernel [H, 2, I] takes B [r, 2, I]
_MERGE_TRIPLES = (
    ("kernel", "lora_a", "lora_b"),
    ("embedding", "lora_a", "lora_b"),
    ("q_kernel", "q_lora_a", "q_lora_b"),
    ("k_kernel", "k_lora_a", "k_lora_b"),
    ("v_kernel", "v_lora_a", "v_lora_b"),
    ("gate_up_kernel", "lora_a", "lora_b"),
)


@dataclass(frozen=True)
class LoraConfig:
    """The reference's ``LoraConfig``: rank ``r``, ``alpha`` (the adapter's
    scale is ``alpha / r``), the dropout on the adapter's input (live only
    when the caller passes a ``dropout_generator``), the sublayers that get
    adapters (of Llama's ``qkv``, ``o_proj``, ``gate_up``, ``down``,
    ``embed`` and ``lm_head``), and ``save_lora_base``, carried as the
    reference carries it."""

    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: Tuple[str, ...] = ("qkv", "o_proj")
    save_lora_base: bool = False

    @property
    def scale(self) -> float:
        return self.alpha / self.r


Path = Union[str, Sequence[str]]


def is_lora_path(path: Path) -> bool:
    """Whether a parameter name (dotted, or a sequence of keys) names an
    adapter factor."""
    keys = path.split(".") if isinstance(path, str) else path
    return bool(set(keys) & set(LORA_KEYS))


def lora_mask(params: Mapping[str, Any]) -> Dict[str, bool]:
    """``{name: True}`` for the adapter entries of a flat state dict."""
    return {name: is_lora_path(name) for name in params}


def make_lora_optimizer(tx, params: Mapping[str, torch.Tensor]):
    """Update only the adapters: every parameter of ``params`` that is not
    one gets ``requires_grad=False`` (an adapter gets ``True``), and ``tx``
    is returned. The train step and ``tx.init`` take only the parameters
    that require gradients, so the clip's norm, the weight decay and the
    moments cover the adapters alone, as the reference's inner
    transformation sees only the adapter leaves. Raises when ``params``
    holds no adapter."""
    mask = lora_mask(params)
    if not any(mask.values()):
        raise ValueError("make_lora_optimizer: no LoRA adapter among the "
                         "parameters (is the config's lora set?)")
    for name, p in params.items():
        p.requires_grad_(mask[name])
    return tx


def extract_lora_state(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The adapter entries of a flat state dict (an adapter checkpoint)."""
    return {name: t for name, t in params.items() if is_lora_path(name)}


def merge_lora_state(params: Mapping[str, Any],
                     lora_state: Mapping[str, Any]) -> Dict[str, Any]:
    """``params`` with the adapter entries of ``lora_state`` put back (a
    new dict; the tensors are not copied)."""
    out = dict(params)
    out.update(lora_state)
    return out


def _fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` in the factors' layout: ``a [h, r]`` with ``b [r, ...]``
    (the fused gate_up's B is ``[r, 2, I]``), or a conv pair, ``a [kh, kw,
    cin, r]`` with the 1x1 ``b [1, 1, r, cout]``, which compose into one
    conv kernel exactly (B is pointwise)."""
    if a.dim() == 4 and b.dim() == 4:
        return torch.einsum("hwir,ro->hwio", a, b[0, 0])
    return torch.einsum("hr,r...->h...", a, b)


def merge_lora_params(params: Mapping[str, torch.Tensor],
                      cfg: LoraConfig) -> Dict[str, torch.Tensor]:
    """Fold each adapter into its base kernel, ``W + scale * A @ B`` (in
    the dtype the two promote to), and drop the adapters: 2-D kernels, the
    embedding table, the three GQA kernels, the fused ``gate_up_kernel``
    and the conv pairs. A new dict; kernels without an adapter are the
    same tensors."""
    out = {name: t for name, t in params.items() if not is_lora_path(name)}
    prefixes = {name.rpartition(".")[0] for name in params
                if is_lora_path(name)}
    for prefix in prefixes:
        at = (lambda key: f"{prefix}.{key}") if prefix else (lambda key: key)
        for kern, a, b in _MERGE_TRIPLES:
            if all(at(k) in params for k in (kern, a, b)):
                out[at(kern)] = params[at(kern)] + cfg.scale * _fold(
                    params[at(a)], params[at(b)])
    return out


__all__ = ["LORA_KEYS", "LoraConfig", "extract_lora_state",
           "is_lora_path", "lora_mask", "make_lora_optimizer",
           "merge_lora_params", "merge_lora_state"]
