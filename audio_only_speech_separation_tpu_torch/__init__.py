"""PyTorch/CUDA port of ``audio_only_speech_separation_tpu``.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path and name.  This package imports torch and numpy
only.  Kernels are built at first use (``ops/kernels/_build.py``).
"""
