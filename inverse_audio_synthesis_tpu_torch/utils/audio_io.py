"""WAV read/write built on the stdlib ``wave`` module.

The reference uses soundfile (reference: evaluate_audio_representations.py:218-230)
which is unavailable here; 16-bit PCM covers everything the pipeline needs
(44.1 kHz mono/stereo clips).
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file → (float32 samples in [-1, 1] shaped [T, C], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        nchan, sampwidth, rate, nframes = (
            w.getnchannels(),
            w.getsampwidth(),
            w.getframerate(),
            w.getnframes(),
        )
        raw = w.readframes(nframes)
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    return data.reshape(-1, nchan), rate


def write_wav(path: Union[str, Path], samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples in [-1, 1] (shape [T] or [T, C]) as 16-bit PCM."""
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    pcm = np.clip(np.round(samples * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
