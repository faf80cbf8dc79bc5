"""Wav IO with partial reads (counterpart of
``audio_only_speech_separation_tpu/data/audio_io.py``).

``read_wav`` reads just the samples [start, stop) of a file, so
random-crop training never loads a whole utterance: through the native
reader (``native.py``, ``pread`` of the window with the GIL released:
PCM16/24/32 and float32), else, for another format or where no C++
compiler is found, through the standard library's ``wave`` (PCM8, PCM16,
PCM32).  Samples come back as float32 in [-1, 1], mono (the first channel
of a multi-channel file), as ``soundfile.read(dtype="float32")`` gives
them.
"""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np

from . import native


def read_wav(path: str, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
    """Read samples [start, stop) as float32 mono."""
    if native.available():
        try:
            return native.read_window(path, start, -1 if stop is None else max(stop - start, 0))
        except IOError:
            pass  # a format the native reader does not parse: the wave module's turn
    return _read_wave_module(path, start, stop)


def _read_wave_module(path: str, start: int, stop: Optional[int]) -> np.ndarray:
    with wave.open(path, "rb") as w:
        n_frames = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        stop = n_frames if stop is None else min(stop, n_frames)
        count = max(stop - start, 0)
        w.setpos(start)
        raw = w.readframes(count)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise wave.Error(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels)[:, 0].copy()
    return data


def wav_frames(path: str) -> int:
    """Number of frames without reading the payload."""
    with wave.open(path, "rb") as w:
        return w.getnframes()


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1, 1] mono as PCM16."""
    pcm = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
