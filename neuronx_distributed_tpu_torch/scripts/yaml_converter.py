"""YAML -> the port's training config (counterpart of
``neuronx_distributed_tpu/scripts/yaml_converter.py``).

A YAML document maps onto :func:`..config.neuronx_distributed_config`,
with the reference's keys:

.. code-block:: yaml

    tensor_parallel_size: 1
    optimizer:
      max_grad_norm: 1.0
    activation_checkpoint:
      mode: full

``tensor_parallel_size``, ``pipeline_parallel_size``,
``expert_parallel_size`` with ``moe_ep_wire_dtype`` and
``moe_overlap_dispatch``, the ``pipeline`` section
(:class:`..config.PipelineConfig`), ``sequence_parallel`` and ZeRO-1
(``optimizer.zero_one_enabled``) map onto the port's config; what
the port cannot run is refused, not ignored: the reference's other keys
(``context_parallel_size``, the gradient-compression fields of
``optimizer``, ...) are accepted only at the reference's defaults, which
is what the port runs. Unknown keys raise, as in the
reference. :func:`config_to_dict` writes the reference's dict for the
same config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from .. import config as _cfg

_SECTIONS = {
    "optimizer": ("optimizer_config", _cfg.OptimizerConfig),
    "mixed_precision": ("mixed_precision_config",
                        _cfg.MixedPrecisionConfig),
    "activation_checkpoint": ("activation_checkpoint_config",
                              _cfg.ActivationCheckpointConfig),
    "pipeline": ("pipeline_config", _cfg.PipelineConfig),
    "checkpoint": ("checkpoint_config", _cfg.CheckpointConfig),
}

# the reference's fields the port does not have, at the reference's
# defaults: a section's own, a whole section, and the top-level scalars
_REFERENCE_FIELDS = {
    "optimizer": {"grad_comm_dtype": "fp32", "grad_comm_hierarchical": False,
                  "grad_comm_block_size": 256,
                  "grad_comm_error_feedback": True},
}
_REFERENCE_SECTIONS: Dict[str, Dict[str, Any]] = {}
_REFERENCE_SCALARS = {
    "context_parallel_size": 1, "dcn_data_parallel_size": None,
    "tp_overlap_comm": None, "tp_activation_comm_dtype": "fp32",
    "tp_activation_sync_fraction": 1.0, "weight_quant": None, "seed": 0,
}
# the top-level scalars the port's config takes, with their defaults
_SCALARS = {"tensor_parallel_size": 1, "pipeline_parallel_size": 1,
            "expert_parallel_size": 1, "moe_ep_wire_dtype": "fp32",
            "moe_overlap_dispatch": None, "sequence_parallel": False}


def _at_defaults(where: str, given: Dict[str, Any],
                 defaults: Dict[str, Any]) -> None:
    for key, value in given.items():
        want = defaults[key]
        if value != want and not (isinstance(want, tuple)
                                  and list(want) == value):
            raise ValueError(
                f"{where}{key}={value!r}: not in the port yet (it runs "
                f"{want!r}, the reference's default)")


def dict_to_config_kwargs(doc: Dict[str, Any]) -> Dict[str, Any]:
    """A parsed YAML dict -> ``neuronx_distributed_config`` kwargs. Unknown
    keys raise; the reference's keys the port lacks must hold the
    reference's defaults."""
    kwargs: Dict[str, Any] = {}
    for key, value in doc.items():
        if key in _SECTIONS or key in _REFERENCE_SECTIONS:
            if not isinstance(value, dict):
                raise ValueError(
                    f"config section {key!r} must be a mapping, got "
                    f"{value!r} (an empty 'key:' line parses as null)")
        if key in _SECTIONS:
            name, cls = _SECTIONS[key]
            fields = {f.name for f in dataclasses.fields(cls)}
            reference = _REFERENCE_FIELDS.get(key, {})
            unknown = set(value) - fields - set(reference)
            if unknown:
                raise ValueError(
                    f"unknown {key} option(s) {sorted(unknown)}; "
                    f"valid: {sorted(fields | set(reference))}")
            _at_defaults(f"{key}.", {k: v for k, v in value.items()
                                     if k in reference}, reference)
            kwargs[name] = cls(**{k: v for k, v in value.items()
                                  if k in fields})
        elif key in _REFERENCE_SECTIONS:
            reference = _REFERENCE_SECTIONS[key]
            unknown = set(value) - set(reference)
            if unknown:
                raise ValueError(
                    f"unknown {key} option(s) {sorted(unknown)}; "
                    f"valid: {sorted(reference)}")
            _at_defaults(f"{key}.", value, reference)
        elif key in _SCALARS:
            kwargs[key] = value
        elif key in _REFERENCE_SCALARS:
            _at_defaults("", {key: value}, _REFERENCE_SCALARS)
        else:
            raise ValueError(f"unknown config key {key!r}")
    return kwargs


def config_to_dict(cfg: _cfg.NxDConfig) -> Dict[str, Any]:
    """The reference's dict for ``cfg``: sections that differ from their
    defaults (with the reference's own fields of a section at their
    defaults), then the scalars that differ from theirs.
    ``dict_to_config_kwargs(config_to_dict(cfg))`` rebuilds ``cfg``."""
    doc: Dict[str, Any] = {}
    for section, (_, cls) in _SECTIONS.items():
        value = getattr(cfg, section)
        if value != cls():
            doc[section] = {**dataclasses.asdict(value),
                            **_REFERENCE_FIELDS.get(section, {})}
    p = cfg.parallel
    scalars = {"tensor_parallel_size": p.tensor_parallel_size,
               "pipeline_parallel_size": p.pipeline_parallel_size,
               "expert_parallel_size": p.expert_parallel_size,
               "moe_ep_wire_dtype": p.moe_ep_wire_dtype,
               "moe_overlap_dispatch": p.moe_overlap_dispatch,
               "sequence_parallel": cfg.sequence_parallel}
    doc.update({k: v for k, v in scalars.items() if v != _SCALARS[k]})
    return doc


def load_yaml_config(path: str, init_mesh: bool = False) -> _cfg.NxDConfig:
    """Parse a YAML file into an :class:`..config.NxDConfig`; with
    ``init_mesh`` also lay the ranks out, as the reference's does."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    return _cfg.neuronx_distributed_config(init_mesh=init_mesh,
                                           **dict_to_config_kwargs(doc))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate a YAML training config and print the "
                    "resolved config")
    ap.add_argument("yaml_path")
    args = ap.parse_args(argv)
    cfg = load_yaml_config(args.yaml_path)
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))


if __name__ == "__main__":
    main()
