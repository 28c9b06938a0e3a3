"""ITU-R BS.1770 integrated loudness (the audiotools Meter equivalent): the
port's own copy of ``ezaudio_tpu/audio/loudness.py``, numpy and scipy only.

Parity target: ``audiotools/core/loudness.py`` (Meter): K-weighting
pre-filter (high-shelf + high-pass biquads designed per sample rate),
400 ms blocks with 75% overlap, absolute gate at -70 LKFS and relative
gate at -10 LU, channel weights [1, 1, 1, 1.41, 1.41].

Implemented host-side in numpy/scipy (loudness runs in the data pipeline
and evaluation, not on the accelerator).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter


def _k_weighting_coeffs(rate: float):
    """High-shelf + high-pass biquad cascade, redesigned per sample rate
    (BS.1770-4 / pyloudnorm-style parametric redesign)."""
    # stage 1: spherical-head high shelf
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    K = math.tan(math.pi * f0 / rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.499666774155
    a0 = 1.0 + K / Q + K * K
    shelf_b = [(Vh + Vb * K / Q + K * K) / a0,
               2.0 * (K * K - Vh) / a0,
               (Vh - Vb * K / Q + K * K) / a0]
    shelf_a = [1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]

    # stage 2: high pass
    f0, Q = 38.13547087613982, 0.5003270373253953
    K = math.tan(math.pi * f0 / rate)
    d = 1.0 + K / Q + K * K
    hp_b = [1.0, -2.0, 1.0]
    hp_a = [1.0, 2.0 * (K * K - 1.0) / d, (1.0 - K / Q + K * K) / d]
    return (np.array(shelf_b), np.array(shelf_a)), (np.array(hp_b), np.array(hp_a))


CH_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.41, 1.41])


def integrated_loudness(audio: np.ndarray, rate: int,
                        block_size: float = 0.4) -> float:
    """Gated integrated loudness in LKFS.  ``audio``: (T,) or (T, C)."""
    x = np.asarray(audio, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    (sb, sa), (hb, ha) = _k_weighting_coeffs(rate)
    y = lfilter(hb, ha, lfilter(sb, sa, x, axis=0), axis=0)

    T, C = y.shape
    step = int(rate * block_size * 0.25)  # 75% overlap
    block = int(rate * block_size)
    if T < block:
        y = np.pad(y, ((0, block - T), (0, 0)))
        T = block
    n_blocks = 1 + (T - block) // step
    idx = np.arange(n_blocks)[:, None] * step + np.arange(block)[None]
    z = np.mean(y[idx] ** 2, axis=1)  # (n_blocks, C)
    weights = CH_WEIGHTS[:C]
    lk = -0.691 + 10 * np.log10(np.maximum((z * weights).sum(axis=1), 1e-12))

    gated = lk > -70.0  # absolute gate
    if not gated.any():
        return -np.inf
    z_abs = z[gated]
    mean_z = (z_abs * weights).sum(axis=1).mean()
    rel_threshold = -0.691 + 10 * np.log10(max(mean_z, 1e-12)) - 10.0
    gated2 = gated & (lk > rel_threshold)
    if not gated2.any():
        return -np.inf
    z_rel = z[gated2]
    mean_z = (z_rel * weights).sum(axis=1).mean()
    return float(-0.691 + 10 * np.log10(max(mean_z, 1e-12)))
