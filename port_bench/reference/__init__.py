"""Plain float32 PyTorch references of the benchmark's configurations.

Nothing here imports the port, JAX or the JAX package: each reference
works out its forward from a ``state_dict`` (look2hear's key names) and
the input alone.  Every product takes its operands through ``q``, the
identity for the reference itself and a rounding to a lower precision for
the control (``common.fp8``).
"""
