"""Model registry (counterpart of ``audio_only_speech_separation_tpu/models``).

The port has ConvTasNet, TasNet (DPRNN and DPTNet cores) and Sepformer so far."""

from ..utils.registry import Registry
from .base import BaseModel, from_pretrain, save_serialized, serialize

_registry = Registry("model")


def register_model(cls=None, *, name=None):
    return _registry.register(cls, name=name)


def get(name):
    """String -> model class; passthrough for classes."""
    return _registry.get(name)


def available_models():
    return _registry.keys()


from .convtasnet import ConvTasNet  # noqa: E402  (self-registers)
from .tasnet import TasNet  # noqa: E402  (self-registers)
from .sepformer import Sepformer  # noqa: E402  (self-registers)

__all__ = [
    "BaseModel",
    "ConvTasNet",
    "TasNet",
    "Sepformer",
    "register_model",
    "get",
    "available_models",
    "from_pretrain",
    "serialize",
    "save_serialized",
]
