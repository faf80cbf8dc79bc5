"""PyTorch/CUDA port of ``audio_only_speech_separation_tpu``.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path and name.  This package imports torch and numpy
only.  Kernels are built at first use (``ops/kernels/_build.py``).

Subpackages, loaded at first access (``import
audio_only_speech_separation_tpu_torch as aoss; aoss.models``), as the JAX
package's are: ``ops``, ``models``, ``losses``, ``metrics``, ``data``,
``parallel``, ``train``, ``utils``, ``layers``.
"""

import importlib as _importlib

__version__ = "0.1.0"

_SUBPACKAGES = ("ops", "models", "losses", "metrics", "data", "parallel", "train", "utils", "layers")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBPACKAGES))
