"""Metrics (counterpart of ``audio_only_speech_separation_tpu/metrics``;
reference look2hear/metrics/__init__.py:7-10)."""

from .pesq import pesq, pesq_batch
from .sdr import sdr_matrix, sdr_pit
from .wrapper import MetricsTracker, SPlitMetricsTracker

__all__ = [
    "MetricsTracker",
    "SPlitMetricsTracker",
    "pesq",
    "pesq_batch",
    "sdr_matrix",
    "sdr_pit",
]
