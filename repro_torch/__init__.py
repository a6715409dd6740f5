"""PyTorch and CUDA port of the N-to-M checkpointing system.

Same module layout as the JAX package (``src/repro``), which stays the
reference each part is held against.  This package imports ``torch`` and
``numpy``, never ``jax`` and nothing of the reference package.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels live under ``repro_torch.kernels``.
"""
