"""Multi-level 1D discrete wavelet transform (counterpart of
``ezaudio_tpu/codecs/wavelets.py``; the reference's ``WaveletPretransform``,
stable_vae/models/pretransforms.py:92, imports a ``wavelets`` module its
tree does not have).

  * Daubechies filters by spectral factorization of the half-band
    polynomial (no PyWavelets), on the host in float64;
  * each level a grouped strided conv with periodic extension, so an
    orthogonal wavelet reconstructs to float precision ("periodization");
  * channel-last: (B, T, C) <-> (B, T / 2^L, C * 2^L), subband 2c the
    approximation of channel c and 2c + 1 its detail.

Analysis correlates with the filters (``y_lo[n] = sum_k h_lo[k]
x[(2n + k) mod T]``); synthesis convolves with them (the orthogonal
inverse).
"""

from __future__ import annotations

from math import comb
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def daubechies_filters(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Daubechies ``dbN`` filters (lo, hi), 2N taps, by spectral
    factorization: the remainder polynomial R(y) of the half-band product
    filter has its roots split min-phase (|z| < 1); together with the
    (1+z)^N binomial factor this is the standard Daubechies filter.
    db1 == Haar."""
    if order == 1:
        lo = np.array([1.0, 1.0]) / np.sqrt(2.0)
    else:
        N = order
        r = np.array([comb(N - 1 + i, i) for i in range(N)], np.float64)
        # R(y) with y = (2 - z - 1/z)/4, as a Laurent polynomial in z
        y_poly = np.array([-0.25, 0.5, -0.25])
        acc = np.zeros(2 * N - 1)
        acc[N - 1] = r[0]
        cur = np.array([1.0])
        for i in range(1, N):
            cur = np.convolve(cur, y_poly)
            off = (2 * N - 1 - cur.size) // 2
            acc[off : off + cur.size] += r[i] * cur
        roots = np.roots(acc)
        q = np.array([1.0])
        for rt in roots[np.abs(roots) < 1.0]:
            q = np.convolve(q, np.array([1.0, -rt]))
        q = np.real(q)
        b = np.array([1.0])
        for _ in range(N):
            b = np.convolve(b, np.array([1.0, 1.0]))
        lo = np.convolve(b, q)
        lo = lo / lo.sum() * np.sqrt(2.0)
    hi = lo[::-1].copy()
    hi[1::2] *= -1.0  # quadrature mirror
    return lo.astype(np.float64), hi.astype(np.float64)


_NAMED = {"haar": 1, **{f"db{i}": i for i in range(1, 9)}}


def wavelet_filters(name: str) -> Tuple[np.ndarray, np.ndarray]:
    if name not in _NAMED:
        raise ValueError(f"unsupported wavelet '{name}' "
                         f"(supported: {sorted(_NAMED)})")
    return daubechies_filters(_NAMED[name])


def _filters(lo: np.ndarray, hi: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.stack([lo, hi])).to(like.device, like.dtype)  # (2, k)


def _analysis_step(x: torch.Tensor, lo: np.ndarray, hi: np.ndarray) -> torch.Tensor:
    """(B, T, C) -> (B, T/2, 2C), channel 2c the approximation of channel c
    and 2c + 1 its detail."""
    C, k = x.shape[-1], lo.shape[0]
    xp = torch.cat([x, x[:, : k - 1]], dim=1).transpose(1, 2)  # circular
    w = _filters(lo, hi, x).repeat(C, 1)[:, None, :]            # (2C, 1, k)
    return F.conv1d(xp, w, stride=2, groups=C).transpose(1, 2)


def _synthesis_step(y: torch.Tensor, lo: np.ndarray, hi: np.ndarray) -> torch.Tensor:
    """(B, T/2, 2C) -> (B, T, C): x[m] = sum_n lo[m - 2n] y_lo[n] +
    hi[m - 2n] y_hi[n], circularly."""
    B, Th, C2 = y.shape
    C, k, T = C2 // 2, lo.shape[0], 2 * Th
    u = y.new_zeros(B, C2, T)
    u[..., ::2] = y.transpose(1, 2)
    # a convolution is a correlation with the reversed filters
    w = _filters(lo[::-1].copy(), hi[::-1].copy(), y)[None].repeat(C, 1, 1)  # (C, 2, k)
    out = F.conv1d(u, w, padding=k - 1, groups=C)                             # T + k - 1
    body = out[..., :T].clone()
    body[..., : k - 1] += out[..., T:]  # the acausal tail, folded circularly
    return body.transpose(1, 2)


class WaveletEncode1d:
    """``levels``-deep DWT: (B, T, channels) -> (B, T/2^L, channels * 2^L)."""

    def __init__(self, channels: int, levels: int, wavelet: str = "db4"):
        self.channels = channels
        self.levels = levels
        self.lo, self.hi = wavelet_filters(wavelet)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        k = len(self.lo)
        for lvl in range(self.levels):
            if x.shape[1] % 2:
                raise ValueError(f"time axis {x.shape[1]} must be divisible by 2 per level")
            if x.shape[1] < k:
                raise ValueError(
                    f"time axis {x.shape[1]} at level {lvl} is shorter than the {k}-tap "
                    f"wavelet; use fewer levels or a shorter wavelet")
            x = _analysis_step(x, self.lo, self.hi)
        return x


class WaveletDecode1d:
    def __init__(self, channels: int, levels: int, wavelet: str = "db4"):
        self.channels = channels
        self.levels = levels
        self.lo, self.hi = wavelet_filters(wavelet)

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        k = len(self.lo)
        for lvl in range(self.levels):
            if 2 * z.shape[1] < k:
                raise ValueError(
                    f"time axis {z.shape[1]} at level {lvl} is too short for the {k}-tap "
                    f"wavelet; use fewer levels or a shorter wavelet")
            z = _synthesis_step(z, self.lo, self.hi)
        return z
