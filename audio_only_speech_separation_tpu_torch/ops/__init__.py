"""Layers and plain tensor ops; hand-written CUDA kernels live in ``kernels``."""
