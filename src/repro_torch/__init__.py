"""PyTorch/CUDA port of the QRMark detection system (``repro``).

Mirrors ``repro``'s layout (``core/``, ``core/rs/``, ``kernels/``,
``data/``, ``launch/``).  Imports ``torch``, ``numpy`` and the standard
library only — never ``jax`` and nothing of ``repro``.  The hot path's
kernels are written by hand in CUDA C++ for Hopper (``kernels/csrc``);
each has a plain PyTorch version beside it, which a CPU tensor takes.
"""
