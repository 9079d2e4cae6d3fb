"""neuronx_distributed_tpu_torch — the PyTorch/CUDA port of
``neuronx_distributed_tpu``.

The layout mirrors the JAX package so each counterpart is easy to find
(``models/llama.py``, ``inference/engine.py``, ``ops/paged_attention.py``
...). Every TPU kernel on a ported path is a hand-written Hopper kernel
under ``csrc/``, built at first use (:mod:`.ops._build`) and held against a
plain PyTorch version that lives beside it.

Entry points take ``device=None``, meaning CUDA, and raise when no card is
present; the CPU is used only when the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
