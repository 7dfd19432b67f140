"""STFT and mel spectrogram (reference: mel_processing.py:43-142).

Counterpart of `bert_vits2_tpu/ops/stft.py`, which spells the transform as a
DFT matmul for the TPU's matrix unit; here `torch.stft` computes the same
function, differentiably (the mel loss runs on generated audio):

- reflect pad by (n_fft - hop) / 2 on both sides, then center=False framing,
- periodic Hann window,
- magnitude = sqrt(re^2 + im^2 + 1e-6),
- Slaney-scale, Slaney-normalized mel filterbank (librosa's default),
- log compression log(clamp(x, 1e-5)).

Layout is the port's: waves [b, t], spectrograms [b, bins, frames].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """Triangular filterbank [n_mels, n_bins], equal to
    librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) (htk=False,
    norm='slaney'), which the reference uses (mel_processing.py:88)."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, n_bins)
    mel_pts = _mel_to_hz_slaney(np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_weights(sampling_rate, n_fft, n_mels, fmin, fmax, device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode: the
    # cached copy also serves the training losses, which autograd tracks
    with torch.inference_mode(False):
        return torch.from_numpy(
            mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)).to(device)


def spectrogram(y: torch.Tensor, n_fft: int, hop: int, win_length: int,
                eps: float = 1e-6) -> torch.Tensor:
    """Linear magnitude spectrogram: y [b, t] -> [b, n_fft / 2 + 1, frames],
    frames = t // hop when t is a multiple of the hop."""
    pad = (n_fft - hop) // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(win_length, device=y.device, dtype=y.dtype)
    spec = torch.stft(y, n_fft, hop_length=hop, win_length=win_length,
                      window=window, center=False, return_complex=True)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(x.clamp(min=clip_val))


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                fmin: float, fmax: float | None) -> torch.Tensor:
    """[b, n_bins, frames] linear spectrogram -> [b, n_mels, frames] log-mel."""
    mel_w = _mel_weights(sampling_rate, n_fft, n_mels, fmin, fmax, spec.device)
    return dynamic_range_compression(torch.matmul(mel_w.to(spec.dtype), spec))


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                    hop: int, win_length: int, fmin: float,
                    fmax: float | None) -> torch.Tensor:
    """Waveform [b, t] -> log-mel [b, n_mels, frames]."""
    return spec_to_mel(spectrogram(y, n_fft, hop, win_length), n_fft, n_mels,
                       sampling_rate, fmin, fmax)
