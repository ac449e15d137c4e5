"""PyTorch/CUDA port of ncnet_tpu for one NVIDIA H100.

The JAX package ``ncnet_tpu`` is the reference; this package imports
nothing of it (nor of JAX) and keeps the same module names: ``ops/``,
``kernels/`` (hand-written Hopper kernels, sources in ``csrc/``),
``models/``, ``serve/`` and ``data/``. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
