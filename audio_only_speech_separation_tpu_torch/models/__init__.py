"""Model registry (counterpart of ``audio_only_speech_separation_tpu/models``).

The port has every model the JAX package registers: ConvTasNet, TasNet
(every separator module, with group communication), Sepformer, BSRNN,
TDANet, AFRCNN, DPRNNTasNet and Sandglasset."""

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
from .bsrnn import BSRNN  # noqa: E402  (self-registers)
from .tdanet import TDANet  # noqa: E402  (self-registers)
from .afrcnn import AFRCNN  # noqa: E402  (self-registers)
from .dprnn_old import DPRNNTasNet  # noqa: E402  (self-registers)
from .sandglasset import Sandglasset  # noqa: E402  (self-registers)

__all__ = [
    "BaseModel",
    "ConvTasNet",
    "TasNet",
    "Sepformer",
    "BSRNN",
    "TDANet",
    "AFRCNN",
    "DPRNNTasNet",
    "Sandglasset",
    "register_model",
    "get",
    "available_models",
    "from_pretrain",
    "serialize",
    "save_serialized",
]
