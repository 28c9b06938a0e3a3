"""TANGO-style loudness-matched two-clip mixing, numpy on the host
(counterpart of ``ezaudio_tpu/data/tango_mix.py``).

Reference ``src/dataset/utils/tango_mix.py``:
framewise gain (RMSE or A-weighted), relative mix weight
``t = 1 / (1 + 10^((g1-g2)/20) (1-r)/r)`` and energy-normalized sum.
"""

from __future__ import annotations

import numpy as np


def a_weight(fs: int, n_fft: int, min_db: float = -80.0) -> np.ndarray:
    freq = np.linspace(0, fs // 2, n_fft // 2 + 1)
    freq_sq = freq**2
    freq_sq[0] = 1.0
    weight = 2.0 + 20.0 * (
        2 * np.log10(12194.0) + 2 * np.log10(freq_sq)
        - np.log10(freq_sq + 12194.0**2)
        - np.log10(freq_sq + 20.6**2)
        - 0.5 * np.log10(freq_sq + 107.7**2)
        - 0.5 * np.log10(freq_sq + 737.9**2)
    )
    return np.maximum(weight, min_db)


def compute_gain(sound: np.ndarray, fs: int = 24000, n_fft: int = 1920,
                 min_db: float = -80.0, mode: str = "RMSE") -> np.ndarray:
    stride = n_fft // 2
    n = (len(sound) - n_fft) // stride + 1
    idx = np.arange(n)[:, None] * stride + np.arange(n_fft)[None]
    windows = sound[idx]
    if mode == "RMSE":
        gain = np.mean(windows**2, axis=1)
    elif mode == "A_weighting":
        spec = np.fft.rfft(np.hanning(n_fft) * windows, axis=1)
        power = np.abs(spec) ** 2
        gain = np.sum(power * np.power(10.0, a_weight(fs, n_fft) / 10), axis=1)
    else:
        raise ValueError(mode)
    gain = np.maximum(gain, np.power(10.0, min_db / 10))
    return 10.0 * np.log10(gain)


def tango_audio_mix(sound1: np.ndarray, sound2: np.ndarray, r: float = 0.5,
                    fs: int = 24000, n_fft: int = 1920) -> np.ndarray:
    g1 = compute_gain(sound1.reshape(-1), fs, n_fft).max()
    g2 = compute_gain(sound2.reshape(-1), fs, n_fft).max()
    t = 1.0 / (1 + np.power(10.0, (g1 - g2) / 20.0) * (1 - r) / r)
    return ((sound1 * t + sound2 * (1 - t)) / np.sqrt(t**2 + (1 - t) ** 2)).astype(np.float32)
