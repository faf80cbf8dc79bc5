"""Separator cores and blocks of the TasNet family (counterpart of
``audio_only_speech_separation_tpu/models/blocks``): the dual-path RNN and
transformer cores (with TAC group communication), TCN and GC_TCN,
SudoRM-RF's U-ConvBlocks, TAC and GC_RNN."""

from .dprnn import DepthwiseGate, DPRNNCore
from .dptnet import DPTNetCore, TransformerEncoderLayerDPT
from .gc_rnn import GC_RNN
from .sudo import GC_UConvBlock, UConvBlock
from .tac import TAC
from .tcn import GC_TCN, TCN, DepthConv1d

__all__ = ["DepthwiseGate", "DPRNNCore", "DPTNetCore", "TransformerEncoderLayerDPT", "GC_RNN",
           "GC_UConvBlock", "UConvBlock", "TAC", "GC_TCN", "TCN", "DepthConv1d"]
