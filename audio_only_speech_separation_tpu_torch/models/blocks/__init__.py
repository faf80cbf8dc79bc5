"""Separator cores of the TasNet family (counterpart of
``audio_only_speech_separation_tpu/models/blocks``): the dual-path RNN and
transformer cores.  TCN, SudoRM-RF, the GC_* modules, TAC and GC_RNN are
still to port (ROADMAP Queue 1)."""

from .dprnn import DepthwiseGate, DPRNNCore
from .dptnet import DPTNetCore, TransformerEncoderLayerDPT

__all__ = ["DepthwiseGate", "DPRNNCore", "DPTNetCore", "TransformerEncoderLayerDPT"]
