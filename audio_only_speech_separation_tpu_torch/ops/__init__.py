"""Layers and plain tensor ops (counterpart of
``audio_only_speech_separation_tpu/ops``); hand-written CUDA kernels live in
``kernels``, built and loaded at their first launch, so importing this
package builds nothing.

- ``conv``      learned filterbank encoder/decoder as framed products
- ``chunk``     50%-overlap segmentation + overlap-add merge
- ``rnn``       (bi)LSTMs: the kernels K5/K6 or the plain scan
- ``norms``     gLN / cLN / LN / bN family (reference:
                look2hear/models/utils/normalizations.py:29-146)
- ``stft``      torch.stft/istft-compatible STFT
- ``attention`` MultiheadAttention (K4) + sinusoidal positions
- ``kernels``   the CUDA kernels' wrappers and plain versions
"""

from .activations import PReLU, get_activation
from .chunk import merge_feature, pad_segment, split_feature
from .conv import ConvDecoder, ConvEncoder, frame_signal, overlap_add
from .norms import (
    BatchNorm1d,
    ChannelLayerNorm,
    CumulativeLayerNorm,
    FrameLayerNorm,
    GlobalLayerNorm,
    get_norm,
)
from .rnn import LSTM, BiLSTM, ProjRNN
from .stft import istft, stft

__all__ = [
    "split_feature",
    "merge_feature",
    "pad_segment",
    "frame_signal",
    "overlap_add",
    "ConvEncoder",
    "ConvDecoder",
    "GlobalLayerNorm",
    "ChannelLayerNorm",
    "CumulativeLayerNorm",
    "FrameLayerNorm",
    "BatchNorm1d",
    "get_norm",
    "LSTM",
    "BiLSTM",
    "ProjRNN",
    "stft",
    "istft",
    "get_activation",
    "PReLU",
]
