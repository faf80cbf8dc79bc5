"""Loss registry (counterpart of ``audio_only_speech_separation_tpu/losses``;
reference look2hear/losses/__init__.py:8-36).  MixIT is not ported yet."""

from .matrix import (
    MultiSrcNegSDR,
    PairwiseNegSDR,
    SingleSrcNegSDR,
    multisrc_neg_sdsdr,
    multisrc_neg_sisdr,
    multisrc_neg_snr,
    pairwise_neg_sdsdr,
    pairwise_neg_sisdr,
    pairwise_neg_snr,
    singlesrc_neg_sdsdr,
    singlesrc_neg_sisdr,
    singlesrc_neg_snr,
)
from .pit import PITLossWrapper

__all__ = [
    "PairwiseNegSDR",
    "SingleSrcNegSDR",
    "MultiSrcNegSDR",
    "PITLossWrapper",
    "pairwise_neg_sisdr",
    "pairwise_neg_sdsdr",
    "pairwise_neg_snr",
    "singlesrc_neg_sisdr",
    "singlesrc_neg_sdsdr",
    "singlesrc_neg_snr",
    "multisrc_neg_sisdr",
    "multisrc_neg_sdsdr",
    "multisrc_neg_snr",
]


def get(identifier):
    """String -> loss object, the reference's getattr reflection; callables
    pass through."""
    if callable(identifier):
        return identifier
    if isinstance(identifier, str) and identifier in __all__:
        return globals()[identifier]
    raise ValueError(f"Could not interpret loss identifier: {identifier}")
