"""The layer library (counterpart of
``audio_only_speech_separation_tpu/layers``; reference look2hear/layers/):
the filterbank factory, conv, RNN and transformer blocks, the STFT
kernels, mel and speed-perturbation filters, the audio-visual and
conformer pieces, norms and activations.  Nothing in the model zoo imports
it; it is exported API, with the same names as the JAX package's.  Compute
primitives are ``ops``' own, so each has one implementation: the blocks'
LSTMs and attention reach K4, K5 and K6 on the card.
"""

from ..models.blocks.tac import TAC
from ..ops.activations import PReLU, get_activation
from ..ops.attention import MultiheadAttention, PositionalEncoding
from ..ops.norms import BatchNorm1d as bN
from ..ops.norms import CumulativeLayerNorm as cLN
from ..ops.norms import FrameLayerNorm as LN
from ..ops.norms import GlobalLayerNorm as gLN
from ..ops.norms import get_norm
from ..ops.stft import hann_window, istft, stft, stft_matmul
from .av import (
    Bottomup,
    BottomupConcatTopdown,
    Concat,
    ConformerConvModule,
    DPRNNLinear,
    MultiHeadedSelfAttentionModule,
    RelativeMultiHeadAttention,
    Video1DConv,
)
from .blocks import (
    DPRNN,
    Conv1DBlock,
    ConvNorm,
    ConvNormAct,
    DPRNNBlock,
    FRCNNBlock,
    LSTMBlockTF,
    SingleRNN,
    TransformerBlockTF,
)
from .enc_dec import Decoder, Encoder, Filterbank, FreeFB, make_enc_dec
from .stft_lib import (
    STFT,
    forward_stft,
    init_kernel,
    init_window,
    inverse_stft,
    iSTFT,
    mel_filter,
    speed_perturb_filter,
    splice_feature,
)

# the norms registry's alias (reference layers/normalizations.py:148)
get = get_norm

__all__ = [
    "Filterbank",
    "Encoder",
    "Decoder",
    "FreeFB",
    "make_enc_dec",
    "Conv1DBlock",
    "ConvNorm",
    "ConvNormAct",
    "FRCNNBlock",
    "SingleRNN",
    "LSTMBlockTF",
    "TransformerBlockTF",
    "DPRNN",
    "DPRNNBlock",
    "TAC",
    "gLN",
    "cLN",
    "LN",
    "bN",
    "get_norm",
    "get",
    "get_activation",
    "PReLU",
    "MultiheadAttention",
    "PositionalEncoding",
    "stft",
    "istft",
    "stft_matmul",
    "hann_window",
    "forward_stft",
    "inverse_stft",
    "STFT",
    "iSTFT",
    "init_window",
    "init_kernel",
    "mel_filter",
    "speed_perturb_filter",
    "splice_feature",
    "Video1DConv",
    "Concat",
    "Bottomup",
    "BottomupConcatTopdown",
    "RelativeMultiHeadAttention",
    "MultiHeadedSelfAttentionModule",
    "ConformerConvModule",
    "DPRNNLinear",
]
