"""PyTorch/CUDA port of the ``repro`` serving system.

Mirrors the JAX package module for module (``repro/serving/engine.py`` ↔
``repro_torch/serving/engine.py``).  It imports ``torch`` and ``numpy``
only — never ``jax`` and nothing of ``repro``.  Hand-written Hopper kernels
live in ``repro_torch.kernels``; each runs on CUDA tensors, and its plain
PyTorch version runs on CPU tensors.
"""
