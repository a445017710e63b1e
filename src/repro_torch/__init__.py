"""PyTorch + CUDA port of the N2Net system (reference: the ``repro`` package).

Layout mirrors ``repro``: ``core/`` (bit primitives, BNN oracle, compiler,
interpreter), ``dataplane/`` (lowering, traffic, executor), ``kernels/``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the binary-GEMM ops), ``layers/``, ``models/`` and
``serving/`` (the dense LM and its engine), ``obs/`` (metrics, spans, the
LM profiler) and ``configs/``.  The package imports
``torch`` and ``numpy`` only — never ``jax`` and never ``repro``.  Entry
points default to ``device="cuda"`` and raise without a GPU.
"""
