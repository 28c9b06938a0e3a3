"""STFT and mel filterbanks (counterpart of ``ezaudio_tpu/audio/stft.py``
and of ``_mel_filterbank_htk`` in ``ezaudio_tpu/audio/clap.py``).

The filterbanks are host constants (numpy).  The STFT is ``torch.stft``
with the JAX package's conventions (periodic hann window, centre reflect
padding, one-sided, unnormalized) and runs on the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    """Periodic hann window of length ``n``."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft(x: torch.Tensor, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """(B, T) -> complex (B, 1 + n_fft // 2, frames)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = hann_window(win_length)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    return torch.stft(x, n_fft, hop_length, n_fft, torch.from_numpy(win).to(x.device),
                      center=center, pad_mode="reflect", normalized=False, onesided=True,
                      return_complex=True)


def _hz_to_mel(f):
    """Slaney mel scale (librosa's default): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, min_log_mel = 1000.0, 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, min_log_mel = 1000.0, 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def _triangles(fft_freqs: np.ndarray, mel_pts: np.ndarray) -> np.ndarray:
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0, np.minimum(lower, upper))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (librosa.filters.mel),
    shape (n_mels, 1 + n_fft // 2)."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    weights = _triangles(fft_freqs, mel_pts)
    weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_filterbank_htk(sr: int, n_fft: int, n_mels: int, fmin: float,
                       fmax: float) -> np.ndarray:
    """torchaudio's default mel filterbank (HTK scale, no area norm), shape
    (n_mels, 1 + n_fft // 2): the filters of CLAP's "fusion" variant."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    mel_pts = 700.0 * (10.0 ** (np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
                                / 2595.0) - 1.0)
    return _triangles(fft_freqs, mel_pts).astype(np.float32)
