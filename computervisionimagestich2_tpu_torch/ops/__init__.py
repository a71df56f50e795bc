"""Tensor ops of the port: plain PyTorch, and the wrappers of the CUDA kernels."""
