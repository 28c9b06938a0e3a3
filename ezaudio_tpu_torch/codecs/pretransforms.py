"""Pretransforms: invertible signal transforms before the codec (counterpart
of ``ezaudio_tpu/codecs/pretransforms.py``; reference
``src/modules/stable_vae/models/pretransforms.py`` :5-258).  EzAudio's VAE
config uses none of them; they are part of the codec factory:

  * ``AutoencoderPretransform``: a codec facade nested (with a scale);
  * ``PQMFPretransform``: an M-band pseudo-QMF bank (cosine-modulated Kaiser
    prototype, its cutoff searched for near-perfect reconstruction; the
    filters designed on the host in numpy);
  * ``WaveletPretransform``: the DWT of ``codecs/wavelets.py``;
  * ``PretrainedDACPretransform``: a DAC behind the facade, frozen;
  * the other reference variants raise, as in the JAX package.

Layouts: audio (B, T, C); PQMF maps (B, T, 1) <-> (B, T/M, M).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


class Pretransform:
    enable_grad = False
    io_channels = 1
    downsampling_ratio = 1

    def encode(self, x):
        raise NotImplementedError

    def decode(self, z):
        raise NotImplementedError


class AutoencoderPretransform(Pretransform):
    """A codec facade as a pretransform (pretransforms.py:34-90)."""

    def __init__(self, facade, scale: float = 1.0):
        self.facade = facade
        self.scale = scale
        self.downsampling_ratio = facade.downsampling_ratio

    def encode(self, x):
        return self.facade.encode(x) / self.scale

    def decode(self, z):
        return self.facade.decode(z * self.scale)


# ---------------------------------------------------------------------------
# PQMF
# ---------------------------------------------------------------------------

def _kaiser_prototype(taps: int, cutoff: float, beta: float) -> np.ndarray:
    n = np.arange(taps + 1) - taps / 2
    h = np.sinc(2 * cutoff * n) * 2 * cutoff
    return h * np.kaiser(taps + 1, beta)


def _modulate(proto: np.ndarray, n_bands: int, sign: float) -> np.ndarray:
    taps = len(proto) - 1
    n = np.arange(taps + 1)
    return np.stack([
        2 * proto * np.cos(
            (2 * k + 1) * np.pi / (2 * n_bands) * (n - taps / 2)
            + sign * (-1) ** k * np.pi / 4)
        for k in range(n_bands)
    ])


def _recon_error(cutoff: float, n_bands: int, taps: int, beta: float) -> float:
    """Impulse-through-the-bank reconstruction error (time-domain NPR check)."""
    proto = _kaiser_prototype(taps, cutoff, beta)
    h = _modulate(proto, n_bands, +1.0)
    f = _modulate(proto, n_bands, -1.0)
    T = 16 * (taps + 1)
    x = np.zeros(T)
    x[T // 2] = 1.0
    rec = np.zeros(T)
    for k in range(n_bands):
        sub = np.convolve(x, h[k])[::1]
        # decimate/expand
        dec = np.zeros_like(sub)
        dec[:: n_bands] = sub[:: n_bands] * n_bands
        rec_k = np.convolve(dec, f[k])
        rec[: T] += rec_k[taps : taps + T]
    return float(np.sqrt(np.mean((rec - x) ** 2)))


def pqmf_filters(n_bands: int, taps: int = 62, beta: float = 9.0
                 ) -> np.ndarray:
    """Cosine-modulated analysis filter bank (n_bands, taps+1) with the
    Kaiser prototype's cutoff numerically optimized for near-perfect
    reconstruction (standard NPR-PQMF design: golden-section search on the
    impulse reconstruction error)."""
    lo, hi = 0.25 / n_bands, 1.0 / n_bands
    phi = (np.sqrt(5) - 1) / 2
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = (_recon_error(c, n_bands, taps, beta),
              _recon_error(d, n_bands, taps, beta))
    for _ in range(40):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = _recon_error(c, n_bands, taps, beta)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = _recon_error(d, n_bands, taps, beta)
    cutoff = (a + b) / 2
    proto = _kaiser_prototype(taps, cutoff, beta)
    return _modulate(proto, n_bands, +1.0).astype(np.float32)


class PQMFPretransform(Pretransform):
    """M-band PQMF analysis and synthesis."""

    def __init__(self, attenuation: float = 100, num_bands: int = 16, taps: int = 124):
        # the attenuation sets the Kaiser beta (the standard formula)
        beta = 0.1102 * (attenuation - 8.7) if attenuation > 50 else 9.0
        self.num_bands = num_bands
        self.taps = taps
        self.filters = torch.from_numpy(pqmf_filters(num_bands, taps, beta))  # (M, taps + 1)
        self.downsampling_ratio = num_bands

    def encode(self, x):
        """(B, T, 1) -> (B, T/M, M) subband signals."""
        k = self.filters.shape[1]
        w = self.filters.to(x.device, x.dtype)[:, None, :]
        return F.conv1d(x.transpose(1, 2), w, stride=self.num_bands,
                        padding=k // 2).transpose(1, 2)

    def decode(self, z):
        """(B, L, M) -> (B, L*M, 1): each band upsampled by M (zeros between)
        and filtered by its time-reversed analysis filter times M; the tail
        padded M - 1 further so the length is exactly L*M."""
        M, (B, L, _) = self.num_bands, z.shape
        k = self.filters.shape[1]
        pad = k - 1 - k // 2
        u = z.new_zeros(B, M, (L - 1) * M + 1)
        u[..., ::M] = z.transpose(1, 2)
        w = (self.filters.flip(-1) * M).to(z.device, z.dtype)[None]  # (1, M, k)
        return F.conv1d(F.pad(u, (pad, pad + M - 1)), w).transpose(1, 2)


class WaveletPretransform(Pretransform):
    """Multi-level DWT pretransform (``codecs/wavelets.py``)."""

    def __init__(self, channels: int = 1, levels: int = 4, wavelet: str = "db4"):
        from ezaudio_tpu_torch.codecs.wavelets import WaveletDecode1d, WaveletEncode1d

        self.io_channels = channels
        self.downsampling_ratio = 2 ** levels
        self.encoded_channels = channels * self.downsampling_ratio
        self._enc = WaveletEncode1d(channels, levels, wavelet)
        self._dec = WaveletDecode1d(channels, levels, wavelet)

    def encode(self, x):
        return self._enc(x)

    def decode(self, z):
        return self._dec(z)


class PretrainedDACPretransform(Pretransform):
    """A DAC as a frozen pretransform, quantizing at decode or at encode."""

    def __init__(self, dac_model, quantize_on_decode: bool = True):
        from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade

        self.facade = AutoencoderFacade(dac_model, quantization_first=not quantize_on_decode,
                                        model_type="dac")
        self.downsampling_ratio = dac_model.hop_length

    def encode(self, x):
        return self.facade.encode(x)

    def decode(self, z):
        return self.facade.decode(z)


def create_pretransform_from_config(cfg: dict, sample_rate: int) -> Optional[Pretransform]:
    """The reference factory's ``create_pretransform_from_config``."""
    if cfg is None:
        return None
    kind = cfg["type"]
    c = cfg.get("config", {})
    if kind == "pqmf":
        return PQMFPretransform(**c)
    if kind == "wavelet":
        return WaveletPretransform(**c)
    raise NotImplementedError(
        f"pretransform '{kind}' needs explicit model wiring "
        "(AutoencoderPretransform / PretrainedDACPretransform)")
