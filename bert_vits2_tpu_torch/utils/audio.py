"""Waveform IO helpers (reference: utils.py:227-233 load_wav_to_torch,
hiyoriUI.py:342-349 wav response encoding)."""

from __future__ import annotations

import io

import numpy as np


def float_to_int16(audio: np.ndarray) -> np.ndarray:
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return (audio * 32767.0).astype(np.int16)


def write_wav(path_or_buf, audio: np.ndarray, sampling_rate: int) -> None:
    """Write float32 [-1,1] audio as 16-bit PCM wav."""
    from scipy.io import wavfile

    wavfile.write(path_or_buf, sampling_rate, float_to_int16(audio))


def wav_bytes(audio: np.ndarray, sampling_rate: int) -> bytes:
    """Encode to an in-memory wav file (for HTTP responses)."""
    buf = io.BytesIO()
    write_wav(buf, audio, sampling_rate)
    return buf.getvalue()
