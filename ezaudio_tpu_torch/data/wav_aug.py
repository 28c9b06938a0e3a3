"""Waveform augmentations on the host, numpy and scipy (counterpart of
``ezaudio_tpu/data/wav_aug.py``; the same generator gives the same draws
and the same samples).

Reference ``src/dataset/utils/wav_aug.py``: a
pipeline built from config keys ``phase180``, ``amplitude``, ``mu_law``,
``low_pass``, ``high_pass`` — each applied with probability ``p``.  The
biquad low/high-pass filters match torchaudio's RBJ-cookbook biquads
(Q = 0.707); mu-law encode/decode matches torchaudio.functional.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy.signal import lfilter


def mu_law_encode(x: np.ndarray, n_channels: int = 256) -> np.ndarray:
    mu = n_channels - 1.0
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / math.log1p(mu)
    return ((y + 1) / 2 * mu + 0.5).astype(np.int64)


def mu_law_decode(y: np.ndarray, n_channels: int = 256) -> np.ndarray:
    mu = n_channels - 1.0
    x = (y.astype(np.float64) / mu) * 2 - 1.0
    return (np.sign(x) * (np.expm1(np.abs(x) * math.log1p(mu))) / mu).astype(np.float32)


def _biquad_coeffs(fs: float, fc: float, lowpass: bool, Q: float = 0.70710678):
    w0 = 2 * math.pi * fc / fs
    alpha = math.sin(w0) / (2 * Q)
    cos = math.cos(w0)
    if lowpass:
        b = np.array([(1 - cos) / 2, 1 - cos, (1 - cos) / 2])
    else:
        b = np.array([(1 + cos) / 2, -(1 + cos), (1 + cos) / 2])
    a = np.array([1 + alpha, -2 * cos, 1 - alpha])
    return b / a[0], a / a[0]


def lowpass_biquad(x: np.ndarray, fs: float, fc: float) -> np.ndarray:
    b, a = _biquad_coeffs(fs, fc, lowpass=True)
    return lfilter(b, a, x).astype(np.float32)


def highpass_biquad(x: np.ndarray, fs: float, fc: float) -> np.ndarray:
    b, a = _biquad_coeffs(fs, fc, lowpass=False)
    return lfilter(b, a, x).astype(np.float32)


class WavAugmentation:
    def __init__(self, aug_config: dict, sr: int = 24000,
                 rng: Optional[np.random.Generator] = None):
        self.cfg = aug_config
        self.sr = sr
        self.rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        rng = self.rng
        if "phase180" in cfg and rng.random() < cfg["phase180"]["p"]:
            x = -x
        if "amplitude" in cfg and rng.random() < cfg["amplitude"]["p"]:
            c = cfg["amplitude"]
            max_val = np.abs(x).max()
            hi = min(1.0 / max_val, c["high"]) if max_val != 0 else c["high"]
            x = x * rng.uniform(c["low"], hi)
        if "mu_law" in cfg and rng.random() < cfg["mu_law"]["p"]:
            n = cfg["mu_law"]["n_channels"]
            x = mu_law_decode(mu_law_encode(x, n), n)
        if "low_pass" in cfg and rng.random() < cfg["low_pass"]["p"]:
            c = cfg["low_pass"]
            fs = c.get("fs", self.sr)  # dataset rate unless the config pins one
            fc = rng.uniform(*c["fc_threshold"]) * fs / 2
            x = lowpass_biquad(x, fs, fc)
        if "high_pass" in cfg and rng.random() < cfg["high_pass"]["p"]:
            c = cfg["high_pass"]
            fs = c.get("fs", self.sr)
            fc = rng.uniform(*c["fc_threshold"]) * fs / 2
            x = highpass_biquad(x, fs, fc)
        return x
