"""PyTorch/CUDA port of the ``repro`` package (GPU sharing with triples mode).

The JAX package ``repro`` is the reference; this package mirrors its module
tree (``configs``, ``kernels``, ``models``, ``core``, ``launch``) and holds
each slice to it in ``tests/test_torch_*.py``. It imports ``torch`` and
numpy only, never ``jax`` or anything under ``repro``.

Entry points (``models.model.Model``, ``launch.serve.BatchServer``,
``kernels.ops.flash_attention``) run on ``cuda`` unless the caller passes a
CPU device or CPU tensors; a CUDA tensor always goes through the
hand-written Hopper kernel, never a silent CPU fallback.
"""
