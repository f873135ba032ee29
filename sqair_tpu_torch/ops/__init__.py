"""Tensor ops of the port; ``fused`` holds the three CUDA kernels."""
