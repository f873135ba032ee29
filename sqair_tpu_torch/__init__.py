"""PyTorch / CUDA port of sqair_tpu (SQAIR, sequential attend-infer-repeat).

The JAX package ``sqair_tpu`` is the reference; this package imports
neither it nor JAX.  Its CUDA kernels live in ``csrc/`` and are built at
first use (``ops/build.py``).
"""
