"""Rank-aware logging (counterpart of ``neuronx_distributed_tpu/utils/
logger.py``: ``get_logger`` and ``log_event``).

The level comes from ``NXD_LOG_LEVEL`` (default INFO), re-read at every
``get_logger`` call. On a process whose ``torch.distributed`` rank is not
0, a ``rank0_only`` logger drops records below WARNING; before a process
group exists every process counts as rank 0. ``log_event`` writes the
reference's ``NXD_EVENT {json}`` line; the reference also counts it in its
metrics registry, which comes with ``obs/``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Tuple

_LOGGERS: Dict[Tuple[str, bool], logging.Logger] = {}
_WARNED_BAD_LEVELS = set()


class _Rank0Filter(logging.Filter):
    """Drop sub-WARNING records on processes whose rank is not 0."""

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.WARNING:
            return True
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True


_RANK0_FILTER = _Rank0Filter()


def get_log_level() -> int:
    raw = os.environ.get("NXD_LOG_LEVEL", "INFO")
    level = getattr(logging, raw.upper(), None)
    if isinstance(level, int) and not isinstance(level, bool):
        return level
    if raw not in _WARNED_BAD_LEVELS:
        _WARNED_BAD_LEVELS.add(raw)
        logging.getLogger("neuronx_distributed_tpu_torch").warning(
            "NXD_LOG_LEVEL=%r is not a valid logging level; "
            "falling back to INFO", raw)
    return logging.INFO


def get_logger(name: str = "neuronx_distributed_tpu_torch",
               rank0_only: bool = True) -> logging.Logger:
    """A logger with one stream handler, at ``NXD_LOG_LEVEL``."""
    key = (name, rank0_only)
    logger = _LOGGERS.get(key)
    if logger is not None:
        level = get_log_level()
        if logger.level != level:
            logger.setLevel(level)
        return logger
    logger = logging.getLogger(name)
    logger.setLevel(get_log_level())
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
    if rank0_only and _RANK0_FILTER not in logger.filters:
        logger.addFilter(_RANK0_FILTER)
    _LOGGERS[key] = logger
    return logger


def log_event(logger: logging.Logger, event: str, **fields: Any) -> None:
    """One machine-parseable line, ``NXD_EVENT {json}``, at WARNING so that
    every rank's resilience events stay visible."""
    payload = {"event": event, **fields}
    logger.warning("NXD_EVENT %s",
                   json.dumps(payload, sort_keys=True, default=str))
