"""PyTorch + CUDA port of the VLA quantum state-vector simulator.

Mirrors the JAX package ``repro`` module by module (``core/``, ``engine/``,
``kernels/``) for the single-device state-vector path; the three Pallas
kernels become hand-written CUDA kernels for Hopper (``kernels/csrc/``),
each with a plain PyTorch version beside it.  Entry points take an explicit
``device`` and default to ``"cuda"``.
"""
