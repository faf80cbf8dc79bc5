"""Registry, weight import from the JAX package, inference helpers
(counterpart of ``audio_only_speech_separation_tpu/utils``; reference
look2hear/utils/__init__.py:7-37)."""

from .console import print_only
from .parser_utils import parse_args_as_dict, prepare_parser_from_dict, str2bool, str2bool_arg, str_int_float
from .registry import Registry
from .tensor_utils import pad_x_to_y, shape_reconstructed, tensors_to_device

__all__ = [
    "prepare_parser_from_dict",
    "parse_args_as_dict",
    "str_int_float",
    "str2bool",
    "str2bool_arg",
    "Registry",
    "pad_x_to_y",
    "shape_reconstructed",
    "tensors_to_device",
    "print_only",
]
