"""Hand-written CUDA kernels (sources in ``csrc/``), each beside its plain
PyTorch version and a launch counter."""
