"""Waveform effects (the port's copy of ``ezaudio_tpu/audio/effects.py``,
numpy and scipy only) — equivalents of the reference's
``audiotools/core/effects.py`` EffectMixin subset that carries behavior:
mix at SNR, IR convolution, low/high-pass, volume, clipping, mu-law
quantization, preemphasis; plus windowed overlap-add from ``dsp.py``.

Host-side numpy (data pipeline / evaluation); each function maps an
(B, C, T) or (T,) float32 array to the same shape.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.signal import fftconvolve

from ezaudio_tpu_torch.audio.loudness import integrated_loudness
from ezaudio_tpu_torch.data.wav_aug import (  # noqa: F401 (re-exported)
    highpass_biquad,
    lowpass_biquad,
    mu_law_decode,
    mu_law_encode,
)


def _loudness(x, sr):
    return integrated_loudness(np.asarray(x).reshape(-1), sr)


def mix(signal: np.ndarray, other: np.ndarray, sr: int, snr: float = 10.0
        ) -> np.ndarray:
    """Mix ``other`` into ``signal`` at the given SNR in dB
    (effects.py:27-76): scale other so loudness(signal) - loudness(other)
    == snr, then add."""
    ls = _loudness(signal, sr)
    lo = _loudness(other, sr)
    if not np.isfinite(ls) or not np.isfinite(lo):
        return signal + other
    gain_db = ls - snr - lo
    return signal + other * 10 ** (gain_db / 20)


def apply_ir(signal: np.ndarray, ir: np.ndarray) -> np.ndarray:
    """Convolve with an impulse response along time, peak-aligned and
    length-preserving (effects.py convolve).  ``signal`` may be (..., T);
    a 1-D ``ir`` broadcasts over the leading axes."""
    peak = int(np.argmax(np.abs(ir)))
    if ir.ndim < signal.ndim:
        ir = np.reshape(ir, (1,) * (signal.ndim - ir.ndim) + ir.shape)
    out = fftconvolve(signal, ir, mode="full", axes=-1)
    return out[..., peak : peak + signal.shape[-1]].astype(np.float32)


def volume_change(signal: np.ndarray, db: float) -> np.ndarray:
    return signal * 10 ** (db / 20)


def clip_distortion(signal: np.ndarray, clip_percentile: float) -> np.ndarray:
    """Clip at a percentile of the absolute amplitude (effects.py clip_distortion)."""
    thresh = np.percentile(np.abs(signal), clip_percentile * 100)
    return np.clip(signal, -thresh, thresh).astype(np.float32)


def quantization(signal: np.ndarray, quantization_channels: int) -> np.ndarray:
    """Uniform amplitude quantization (effects.py quantization)."""
    x = np.clip(signal, -1, 1)
    q = np.round(x * (quantization_channels / 2)) / (quantization_channels / 2)
    return q.astype(np.float32)


def mulaw_quantization(signal: np.ndarray, quantization_channels: int) -> np.ndarray:
    return mu_law_decode(mu_law_encode(signal, quantization_channels),
                         quantization_channels)


def mnru(signal: np.ndarray, q_db: float, seed: int = 0) -> np.ndarray:
    """Modulated Noise Reference Unit (ITU-T P.810): multiplicative noise
    at a given Q (signal-to-modulated-noise ratio in dB),
    ``y = x * (1 + 10^(-Q/20) * n)`` with n ~ N(0, 1).  The standard
    reference degradation family for anchoring intrusive quality metrics
    (P.862 conformance batteries are built on MNRU conditions)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(np.shape(signal))
    return (signal * (1.0 + 10.0 ** (-q_db / 20.0) * n)).astype(np.float32)


def band_limit(signal: np.ndarray, sr: int, cutoff_hz: float,
               kind: str = "low") -> np.ndarray:
    """Brickwall FFT band-limit (``kind='low'`` keeps f <= cutoff,
    ``'high'`` keeps f >= cutoff) — the band-limiting leg of metric
    conformance batteries."""
    spec = np.fft.rfft(signal, axis=-1)
    f = np.fft.rfftfreq(np.shape(signal)[-1], 1.0 / sr)
    mask = (f <= cutoff_hz) if kind == "low" else (f >= cutoff_hz)
    return np.fft.irfft(spec * mask, np.shape(signal)[-1],
                        axis=-1).astype(np.float32)


def preemphasis(signal: np.ndarray, coef: float = 0.85) -> np.ndarray:
    """y[t] = x[t] - coef * x[t-1] (dsp.py preemphasis)."""
    out = np.array(signal, np.float32)
    out[..., 1:] -= coef * signal[..., :-1]
    return out


def equalizer(signal: np.ndarray, sr: int, band_gains_db: np.ndarray,
              n_fft: int = 2048) -> np.ndarray:
    """Mel-band graph EQ (effects.py equalizer): gains (n_bands,) in dB
    applied via an FFT filter built from the mel filterbank."""
    from ezaudio_tpu_torch.audio.stft import mel_filterbank

    fb = mel_filterbank(sr, n_fft, len(band_gains_db))  # (bands, F)
    weights = fb / np.maximum(fb.sum(axis=0, keepdims=True), 1e-8)
    H = (weights * (10 ** (np.asarray(band_gains_db)[:, None] / 20))).sum(axis=0)
    T = signal.shape[-1]
    spec = np.fft.rfft(signal, n=max(T, n_fft), axis=-1)
    freqs = np.fft.rfftfreq(max(T, n_fft), 1 / sr)
    bin_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    Hi = np.interp(freqs, bin_freqs, H)
    out = np.fft.irfft(spec * Hi, n=max(T, n_fft), axis=-1)[..., :T]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# windowing / overlap-add (audiotools/core/dsp.py:31-151)
# ---------------------------------------------------------------------------

def collect_windows(signal: np.ndarray, window_duration: float,
                    hop_duration: float, sr: int) -> np.ndarray:
    """(..., T) -> (n_windows, ..., win) strided frames."""
    win = int(window_duration * sr)
    hop = int(hop_duration * sr)
    T = signal.shape[-1]
    n = max(1, 1 + (T - win) // hop)
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None]
    idx = np.minimum(idx, T - 1)
    return np.moveaxis(signal[..., idx], -2, 0)


def overlap_and_add(windows: np.ndarray, hop_duration: float, sr: int,
                    length: Optional[int] = None) -> np.ndarray:
    """Inverse of collect_windows with a hann^2-normalized overlap-add."""
    n, *rest, win = windows.shape
    hop = int(hop_duration * sr)
    T = win + (n - 1) * hop
    w = np.hanning(win).astype(np.float32)
    out = np.zeros((*rest, T), np.float32)
    norm = np.zeros(T, np.float32)
    for i in range(n):
        out[..., i * hop : i * hop + win] += windows[i] * w
        norm[i * hop : i * hop + win] += w**2
    out = out / np.maximum(norm, 1e-8)
    return out[..., :length] if length else out


# ---------------------------------------------------------------------------
# Phase vocoder: time_stretch / pitch_shift (reference
# audiotools/core/effects.py:247,279 — sox-bound there; pure-DSP here)
# ---------------------------------------------------------------------------

def _stft_1d(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    win = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    pad = n_fft // 2
    xp = np.pad(x.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (xp.size - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[idx] * win[None, :]
    return np.fft.rfft(frames, axis=1).T  # (F, M)


def _istft_1d(spec: np.ndarray, n_fft: int, hop: int,
              length: Optional[int] = None) -> np.ndarray:
    win = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=1) * win[None, :]
    M = frames.shape[0]
    T = n_fft + hop * (M - 1)
    out = np.zeros(T)
    norm = np.zeros(T)
    for m in range(M):  # overlap-add (host-side, M ~ hundreds)
        s = m * hop
        out[s : s + n_fft] += frames[m]
        norm[s : s + n_fft] += win * win
    out = out / np.maximum(norm, 1e-10)
    pad = n_fft // 2
    out = out[pad:]
    if length is not None:
        out = out[:length] if out.size >= length else np.pad(
            out, (0, length - out.size))
    return out


def _phase_vocoder(spec: np.ndarray, rate: float, hop: int) -> np.ndarray:
    """Librosa-style phase vocoder: resample the STFT along time by
    ``rate`` with magnitude interpolation + accumulated true-frequency
    phase (vectorized with a cumsum over steps)."""
    F, M = spec.shape
    n_fft = 2 * (F - 1)
    steps = np.arange(0, M, rate)
    m0 = np.minimum(steps.astype(int), M - 1)
    m1 = np.minimum(m0 + 1, M - 1)
    frac = (steps - m0)[None, :]

    mag = (1 - frac) * np.abs(spec[:, m0]) + frac * np.abs(spec[:, m1])

    phi_adv = (np.linspace(0, np.pi * hop, F))[:, None]  # expected/hop
    dphi = np.angle(spec[:, m1]) - np.angle(spec[:, m0]) - phi_adv
    dphi = dphi - 2 * np.pi * np.round(dphi / (2 * np.pi))  # wrap
    step_phase = phi_adv + dphi  # true per-step advance at each position

    phase = np.empty((F, steps.size))
    phase[:, 0] = np.angle(spec[:, 0])
    if steps.size > 1:
        phase[:, 1:] = phase[:, :1] + np.cumsum(step_phase[:, :-1], axis=1)
    return mag * np.exp(1j * phase)


def time_stretch(signal: np.ndarray, rate: float,
                 n_fft: int = 2048) -> np.ndarray:
    """Stretch duration by 1/rate without changing pitch (rate > 1 =
    faster/shorter).  Accepts (T,), (C, T) or (B, C, T)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    x = np.asarray(signal, np.float32)
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    hop = n_fft // 4
    out_len = int(round(shape[-1] / rate))
    outs = []
    for row in flat:
        spec = _stft_1d(row, n_fft, hop)
        stretched = _phase_vocoder(spec, rate, hop)
        outs.append(_istft_1d(stretched, n_fft, hop, length=out_len))
    return np.stack(outs).reshape(*shape[:-1], out_len).astype(np.float32)


def pitch_shift(signal: np.ndarray, sr: int, n_semitones: float,
                n_fft: int = 2048) -> np.ndarray:
    """Shift pitch by ``n_semitones`` keeping duration: phase-vocoder
    stretch by 1/f then resample by f (f = 2^(semitones/12))."""
    from scipy.signal import resample_poly

    x = np.asarray(signal, np.float32)
    T = x.shape[-1]
    f = 2.0 ** (n_semitones / 12.0)
    if abs(f - 1.0) < 1e-9:
        return x.copy()
    stretched = time_stretch(x, rate=1.0 / f, n_fft=n_fft)
    # resample length T*f -> T (play faster by f => pitch up by f)
    from fractions import Fraction

    fr = Fraction(f).limit_denominator(1000)
    flat = stretched.reshape(-1, stretched.shape[-1])
    out = np.stack([resample_poly(r, fr.denominator, fr.numerator)
                    for r in flat])
    out = out[..., :T]
    if out.shape[-1] < T:
        out = np.pad(out, ((0, 0), (0, T - out.shape[-1])))
    return out.reshape(*x.shape[:-1], T).astype(np.float32)


# ---------------------------------------------------------------------------
# Codec simulation (reference effects.py:311 apply_codec — torchaudio/ffmpeg-
# bound there; here the presets are pure-DSP simulations of the same
# degradations, no external binaries)
# ---------------------------------------------------------------------------

CODEC_PRESETS = {
    # name: (target sample rate, bandwidth Hz, quantization)
    "8-bit": dict(sr=None, bandwidth=None, mulaw_bits=8),
    "GSM-FR": dict(sr=8000, bandwidth=3400, mulaw_bits=13),
    "MP3": dict(sr=None, bandwidth=15500, mulaw_bits=None),
    "Vorbis": dict(sr=None, bandwidth=16000, mulaw_bits=None),
    "Ogg": dict(sr=None, bandwidth=16000, mulaw_bits=None),
    "Amr-nb": dict(sr=8000, bandwidth=3400, mulaw_bits=10),
}


def apply_codec(signal: np.ndarray, sr: int, preset: str = "8-bit"
                ) -> np.ndarray:
    """Simulate a lossy codec chain: band-limit, resample down/up, mu-law
    re-quantize — the audible degradations of the reference's
    torchaudio-backed presets (effects.py:14-24), without ffmpeg.
    Returns audio at the ORIGINAL rate/length."""
    if preset not in CODEC_PRESETS:
        raise ValueError(
            f"unknown codec preset {preset!r}; choose from "
            f"{sorted(CODEC_PRESETS)}")
    cfg = CODEC_PRESETS[preset]
    x = np.asarray(signal, np.float32)
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    T = shape[-1]

    from ezaudio_tpu_torch.data.audio_io import resample

    out = []
    for row in flat:
        y = row
        if cfg["bandwidth"] is not None and cfg["bandwidth"] < sr / 2:
            y = lowpass_biquad(y[None, None, :], sr,
                               float(cfg["bandwidth"]))[0, 0]
        if cfg["sr"] is not None and cfg["sr"] != sr:
            y = resample(y, sr, cfg["sr"])
            y = resample(y, cfg["sr"], sr)
            y = y[:T] if y.size >= T else np.pad(y, (0, T - y.size))
        if cfg["mulaw_bits"] is not None:
            q = 2 ** cfg["mulaw_bits"]
            peak = max(np.abs(y).max(), 1e-9)
            y = mu_law_decode(mu_law_encode(y / peak, q), q) * peak
        out.append(y.astype(np.float32))
    return np.stack(out).reshape(shape)
