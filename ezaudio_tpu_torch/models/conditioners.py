"""Condition extractors for ControlNet conditioning
(counterpart of ``ezaudio_tpu/models/conditioners.py``).

Each extractor maps a waveform batch (B, T) to channel-last features
(B, frames, C), in plain torch on the waveform's device:

  * ``energy_condition``: framewise mean-square energy, reflect padding,
    dB floor, per-clip max normalization (the conditioner of the energy
    ControlNet, ``configs/energy-l.json``);
  * ``multiband_energy_condition``: windowed-sinc band split, then the
    energy of each band;
  * ``chroma_condition``: normalized power spectrogram -> chroma
    filterbank -> inf-norm -> optional argmax one-hot;
  * ``condition_type='vc'``: ContentVec/HuBERT content features
    (``models/hubert.py::VoiceConversionExtractor``, on its own device).

The ``Conditioner`` facade picks one by name and tiles the condition over
the frequency axis of 4-D latents.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Energy
# ---------------------------------------------------------------------------

def frame_energy(audio: torch.Tensor, hop_size: int, window_size: int,
                 padding: str = "reflect") -> torch.Tensor:
    """Framewise mean of squares: (B, T) -> (B, T // hop).

    As the JAX package: hop-chunk partial sums and a short moving sum when
    ``window % hop == 0`` (the EzAudio configs), a cumsum difference
    otherwise.  The right pad takes the odd remainder, so the last frame's
    window stays inside the padded signal."""
    n_frames = audio.shape[-1] // hop_size
    pad = (window_size - hop_size) // 2
    pad_r = (window_size - hop_size) - pad
    mode = {"reflect": "reflect", "constant": "constant"}[padding]
    # F.pad's reflect mode wants a channel axis
    x = F.pad(audio[:, None, :], (pad, pad_r), mode=mode)[:, 0]
    sq = torch.square(x)
    B, Tp = sq.shape
    if window_size % hop_size == 0:
        r = window_size // hop_size
        n_chunks = Tp // hop_size
        chunk_sums = sq[:, : n_chunks * hop_size].reshape(B, n_chunks, hop_size).sum(-1)
        sums = sum(chunk_sums[:, i: i + n_frames] for i in range(r))
    else:
        cs = torch.cat([sq.new_zeros(B, 1), torch.cumsum(sq, dim=-1)], dim=-1)
        starts = torch.arange(n_frames, device=audio.device) * hop_size
        sums = cs[:, starts + window_size] - cs[:, starts]
    return sums[:, :n_frames] / window_size


def _to_db(energy: torch.Tensor, min_db: float, norm: bool, quantize_levels, dims):
    gain_db = 10.0 * torch.log10(torch.clamp(energy, min=10.0 ** (min_db / 10.0)))
    if norm:
        max_db = torch.amax(gain_db, dim=dims, keepdim=True)
        gain_db = (gain_db - min_db) / (max_db - min_db + 1e-8)
    if quantize_levels is not None:
        gain_db = torch.round(gain_db * (quantize_levels - 1)) / (quantize_levels - 1)
    return gain_db


def energy_condition(audio: torch.Tensor, hop_size: int = 512, window_size: int = 1024,
                     padding: str = "reflect", min_db: float = -60.0, norm: bool = True,
                     quantize_levels: Optional[int] = None) -> torch.Tensor:
    """(B, T) -> (B, frames, 1) normalized dB energy."""
    energy = frame_energy(audio, hop_size, window_size, padding)
    return _to_db(energy, min_db, norm, quantize_levels, -1)[..., None]


# ---------------------------------------------------------------------------
# Multiband energy (julius-style sinc band split)
# ---------------------------------------------------------------------------

def _lowpass_kernel(cutoff: float, zeros: float = 8.0) -> np.ndarray:
    """Windowed-sinc FIR lowpass at normalized cutoff (0.5 = Nyquist),
    normalized to unity DC gain (julius.LowPassFilters)."""
    half_size = int(zeros / cutoff / 2)
    t = np.arange(-half_size, half_size + 1, dtype=np.float64)
    win = np.hanning(2 * half_size + 1)
    k = 2 * cutoff * win * np.sinc(2 * cutoff * t)
    k = k / k.sum()
    return k.astype(np.float32)


def split_bands(audio: torch.Tensor, n_bands: int, sample_rate: int,
                zeros: float = 8.0) -> torch.Tensor:
    """(B, T) -> (n_bands, B, T) adjacent frequency bands that sum to the
    input (julius.split_bands: equally spaced cutoffs)."""
    lows = []
    for i in range(n_bands - 1):
        k = torch.from_numpy(_lowpass_kernel((i + 1) / n_bands / 2, zeros)).to(audio)
        lows.append(F.conv1d(audio[:, None, :], k[None, None, :],
                             padding=len(k) // 2)[:, 0])
    bands, prev = [], torch.zeros_like(audio)
    for y in lows:
        bands.append(y - prev)
        prev = y
    bands.append(audio - prev)
    return torch.stack(bands, dim=0)


def multiband_energy_condition(
        audio: torch.Tensor, hop_size: int = 512, window_size: int = 1024,
        padding: str = "reflect", min_db: float = -60.0, norm: bool = True,
        quantize_levels: Optional[int] = None, n_bands: int = 8, control_bands: int = 4,
        sample_rate: int = 24000) -> torch.Tensor:
    """(B, T) -> (B, frames, control_bands); one normalization per clip,
    over all its bands."""
    bands = split_bands(audio, n_bands, sample_rate)[:control_bands]
    nb, B, T = bands.shape
    energy = frame_energy(bands.reshape(nb * B, T), hop_size, window_size, padding)
    gain_db = _to_db(energy.reshape(nb, B, -1), min_db, norm, quantize_levels, (0, 2))
    return gain_db.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# Chroma
# ---------------------------------------------------------------------------

def chroma_filterbank(sr: int, n_fft: int, n_chroma: int = 12, tuning: float = 0.0,
                      ctroct: float = 5.0, octwidth: float = 2.0) -> np.ndarray:
    """Chroma filterbank (n_chroma, 1 + n_fft // 2): the A440 construction
    of Ellis' fft2chromamx as librosa ships it (L2 column norm, octave-5
    gaussian weighting, rolled so chroma 0 is C)."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    A440 = 440.0 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(frequencies / (A440 / 16))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt(np.sum(wts**2, axis=0, keepdims=True)), 1e-12)
    wts *= np.tile(np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
                   (n_chroma, 1))
    wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)], dtype=np.float32)


def _hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def spectrogram_power(audio: torch.Tensor, n_fft: int, win_length: int,
                      hop_length: int) -> torch.Tensor:
    """torchaudio.Spectrogram(power=2, center=False, normalized=True):
    (B, T) -> (B, freq, frames)."""
    win = _hann(win_length)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    win = torch.from_numpy(win).to(audio)
    frames = audio.unfold(-1, n_fft, hop_length) * win  # (B, frames, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    power = torch.square(torch.abs(spec)) / torch.sum(torch.square(win))
    return power.transpose(1, 2)


def chroma_condition(audio: torch.Tensor, sample_rate: int, n_chroma: int = 12,
                     radix2_exp: int = 12, nfft: Optional[int] = None,
                     winlen: Optional[int] = None, winhop: Optional[int] = None,
                     argmax: bool = True) -> torch.Tensor:
    """(B, T) -> (B, frames, n_chroma), inf-normalized over the chroma axis
    (or its argmax one-hot)."""
    winlen = winlen or 2**radix2_exp
    nfft = nfft or winlen
    winhop = winhop or winlen // 4
    T = audio.shape[-1]
    if T < nfft:
        pad = nfft - T
        audio = F.pad(audio, (pad // 2, pad - pad // 2))
    p = int(nfft // 2 - winhop // 2)
    audio = F.pad(audio[:, None, :], (p, p), mode="reflect")[:, 0]
    spec = spectrogram_power(audio, nfft, winlen, winhop)
    fb = torch.from_numpy(chroma_filterbank(sample_rate, nfft, n_chroma)).to(audio)
    raw = torch.einsum("cf,bft->bct", fb, spec)
    denom = torch.clamp(torch.amax(torch.abs(raw), dim=-2, keepdim=True), min=1e-6)
    norm = (raw / denom).transpose(1, 2)
    if argmax:
        return F.one_hot(torch.argmax(norm, dim=-1), n_chroma).to(norm.dtype)
    return norm


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

_EXTRACTORS = {"energy": energy_condition, "mb_energy": multiband_energy_condition,
               "chroma": chroma_condition}


class Conditioner:
    """``Conditioner(condition_type, **kwargs)(waveform, latent_shape)``:
    waveform (B, T) (a tensor, or an array taken to the CPU) -> condition
    (B, frames, C), channel-last."""

    def __init__(self, condition_type: str, **kwargs):
        self.condition_type = condition_type
        if condition_type == "vc":
            # ContentVec/HuBERT content features (reference
            # src/models/conditions/voice.py:19-36): weights= (a
            # transformers-format state dict), sr=, hubert_config=, dtype=,
            # device=; or a callable injected as extractor=
            extractor = kwargs.pop("extractor", None)
            self.fn = extractor if extractor is not None else self._vc_extractor(**kwargs)
        elif condition_type in _EXTRACTORS:
            self.fn = partial(_EXTRACTORS[condition_type], **kwargs)
        else:
            raise NotImplementedError(condition_type)

    @staticmethod
    def _vc_extractor(sr: int = 24000, hubert_config=None, weights=None,
                      dtype: torch.dtype = torch.float32, device=None):
        from ezaudio_tpu_torch.models.hubert import VoiceConversionExtractor

        if weights is None:
            warnings.warn(
                "Conditioner('vc') built WITHOUT weights: the HuBERT/ContentVec tower "
                "is randomly initialized and its features are meaningless for real "
                "conditioning. Pass weights= (a transformers-format state dict) or "
                "extractor=.", stacklevel=3)
        return VoiceConversionExtractor(sr=sr, cfg=hubert_config, weights=weights,
                                        dtype=dtype, device=device)

    def __call__(self, waveform, latent_shape=None):
        cond = self.fn(torch.as_tensor(waveform))
        if latent_shape is not None and len(latent_shape) == 4:
            # 2-D latents (B, T, F, C): tile over the frequency axis by
            # X = F_lat * T_cond / T_lat, so the condition covers the latent area
            T_lat, F_lat = latent_shape[1], latent_shape[2]
            if cond.shape[1] % T_lat:
                raise ValueError(f"condition frames {cond.shape[1]} do not tile "
                                 f"latent frames {T_lat}")
            X = F_lat * cond.shape[1] // T_lat
            cond = cond[:, :, None, :].repeat(1, 1, X, 1)
        return cond
