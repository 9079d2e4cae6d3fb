"""bf16 tensors on the host as numpy arrays.

numpy has no bfloat16 type (the JAX package gets one from ``ml_dtypes``,
which the port does not use). A bf16 tensor that leaves the card for the
host (a migrating session's KV blocks) is held as its raw 16-bit words in a
:class:`BF16Words` array: ``uint16`` storage, read as bf16 wherever it
matters — when it goes back to torch, when it is fingerprinted (as its
exact fp32 widening, as the JAX package's numpy fold sees an ``ml_dtypes``
bf16 array) and when it is written to the wire under the dtype name
``"bfloat16"`` (what JAX's ``str(arr.dtype)`` writes for such an array).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

#: the dtype name a bf16 array carries on the wire
BF16_NAME = "bfloat16"


class BF16Words(np.ndarray):
    """bf16 values as their raw ``uint16`` words. Slicing, indexing and
    copies keep the type; ``np.asarray`` drops it (the words remain)."""


def is_bf16(a: Any) -> bool:
    """Whether ``a`` holds bf16 values: a :class:`BF16Words` array of 16-bit
    words, or a numpy array of an extension type named ``bfloat16`` (an
    ``ml_dtypes`` array handed in by a caller)."""
    return ((isinstance(a, BF16Words) and a.dtype == np.uint16)
            or getattr(getattr(a, "dtype", None), "name", None) == BF16_NAME)


def bf16_words(a: Any) -> np.ndarray:
    """The raw ``uint16`` words of a bf16 array (a plain ndarray)."""
    return np.asarray(a).view(np.uint16)


def dtype_name(a: Any) -> str:
    """The dtype name of a host array as the wire carries it."""
    return BF16_NAME if is_bf16(a) else str(np.asarray(a).dtype)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU copy of ``t`` as numpy; bf16 as :class:`BF16Words`."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(BF16Words)
    return t.numpy()


def to_torch(a: Any) -> torch.Tensor:
    """A CPU tensor holding ``a``'s values (bf16 for a bf16 array)."""
    if is_bf16(a):
        words = np.ascontiguousarray(bf16_words(a)).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_buffer(buf: bytes, name: str, shape: Sequence[int]) -> np.ndarray:
    """A writable array of dtype ``name`` read from raw bytes (bf16 as
    :class:`BF16Words`)."""
    if name == BF16_NAME:
        return (np.frombuffer(buf, np.uint16).reshape(shape).copy()
                .view(BF16Words))
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def widen_to_fp32_words(a: Any) -> np.ndarray:
    """The fp32 bit patterns of a bf16 array's values (``uint32``, flat):
    the word shifted into the high half, which is the exact widening."""
    return np.ascontiguousarray(bf16_words(a)).reshape(-1).astype(
        np.uint32) << np.uint32(16)
