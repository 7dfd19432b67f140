"""Spectrogram / alignment rasterization for TensorBoard (reference:
utils.py:170-224 plot_spectrogram_to_numpy / plot_alignment_to_numpy).

Matplotlib-free: maps a matrix through a viridis-like colormap to an HWC uint8
image so training boxes without a display stack still log images. A copy of
`bert_vits2_tpu/utils/plot.py`.
"""

from __future__ import annotations

import numpy as np

# 8-stop viridis approximation, interpolated to 256 entries.
_STOPS = np.array(
    [
        (68, 1, 84),
        (70, 50, 127),
        (54, 92, 141),
        (39, 127, 142),
        (31, 161, 135),
        (74, 194, 109),
        (159, 218, 58),
        (253, 231, 37),
    ],
    dtype=np.float32,
)
_T = np.linspace(0.0, 1.0, len(_STOPS))
_LUT = np.stack(
    [np.interp(np.linspace(0, 1, 256), _T, _STOPS[:, c]) for c in range(3)], axis=1
).astype(np.uint8)


def _colorize(matrix: np.ndarray) -> np.ndarray:
    m = np.asarray(matrix, np.float32)
    lo, hi = float(m.min()), float(m.max())
    norm = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
    return _LUT[(norm * 255).astype(np.uint8)]


def spectrogram_to_image(spec: np.ndarray) -> np.ndarray:
    """[n_mels, frames] (or [frames, n_mels]) -> HWC uint8, low freqs at bottom."""
    spec = np.asarray(spec)
    if spec.shape[0] > spec.shape[1]:  # [frames, mels] layout -> [mels, frames]
        spec = spec.T
    return _colorize(spec)[::-1]


def alignment_to_image(attn: np.ndarray) -> np.ndarray:
    """[t_y, t_x] attention path -> HWC uint8 with text axis vertical."""
    return _colorize(np.asarray(attn).T)
