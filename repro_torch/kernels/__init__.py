"""Hand-written Hopper (sm_90a) kernels, one folder each, as in the JAX
package: ``kernel.cu`` (CUDA C++ with a plain C interface), ``ref.py`` (the
plain PyTorch version) and ``ops.py`` (the wrapper: plain version for CPU
tensors, kernel for CUDA tensors, and a launch count).

  * ``ckpt_pack``       — the chunk-level star-forest gather that packs a
    rank's owned chunks before its device-to-host copy;
  * ``flash_attention`` — the causal GQA attention forward of prefill.

``build`` compiles the sources with ``nvcc`` on first use.  The JAX
package's third kernel, ``rglru_scan``, is not ported yet.
"""
