"""Debug capture and replacement of tensors in a forward (counterpart of
``neuronx_distributed_tpu/utils/tensor_capture.py``).

* :func:`capture_intermediates`: every (or a filtered set of) submodule
  output of one forward, through forward hooks, keyed by the module's path
  in the model (``"layers.0.attn"``; the model itself is ``""``), where
  flax sows them into its ``intermediates`` collection;
* :func:`apply_with_replacements`: a forward with chosen parameters or
  buffers replaced (``torch.func.functional_call``), named as in the
  state dict;
* :func:`max_diff`: the max absolute difference per tensor between two
  captures (or any nests of dicts, lists and tuples of tensors).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn


def capture_intermediates(module: nn.Module, *args,
                          filter_fn: Optional[Callable[[nn.Module, str],
                                                       bool]] = None,
                          **kwargs) -> Tuple[Any, Dict[str, tuple]]:
    """Run ``module(*args, **kwargs)`` and return ``(outputs,
    intermediates)``: ``{path: (output of each call, ...)}`` for every
    submodule ``filter_fn(submodule, path)`` accepts (all by default). The
    hooks are removed when the forward ends, also on an error."""
    captured: Dict[str, list] = {}
    handles = []
    for path, sub in module.named_modules():
        if filter_fn is not None and not filter_fn(sub, path):
            continue

        def hook(mod, inputs, output, path=path):
            captured.setdefault(path, []).append(output)

        handles.append(sub.register_forward_hook(hook))
    try:
        out = module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out, {path: tuple(outs) for path, outs in captured.items()}


def apply_with_replacements(module: nn.Module,
                            replacements: Mapping[str, torch.Tensor],
                            *args, **kwargs):
    """``module(*args, **kwargs)`` with the parameters and buffers that
    ``replacements`` names (state-dict names, e.g. ``"norm.scale"``)
    replaced for this call only. An unknown name raises ``KeyError``, as
    the reference's unknown path does."""
    known = set(module.state_dict())
    missing = set(replacements) - known
    if missing:
        raise KeyError(f"replacement paths not found: {sorted(missing)}; "
                       f"available e.g. {sorted(known)[:5]}")
    return torch.func.functional_call(module, dict(replacements), args,
                                      kwargs)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}[{k!r}]"))
    return out


def max_diff(a: Any, b: Any) -> Dict[str, float]:
    """``{key: max|a - b|}`` in fp32 per tensor of ``a`` (keys as
    ``['layers.0.attn'][0]``), ``nan`` where ``b`` has none."""
    fb = _flatten(b)
    out = {}
    for key, leaf in _flatten(a).items():
        other = fb.get(key)
        out[key] = (float("nan") if other is None else float(
            (torch.as_tensor(leaf).float()
             - torch.as_tensor(other).float()).abs().max()))
    return out
