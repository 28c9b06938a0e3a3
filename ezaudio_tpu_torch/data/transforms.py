"""Declarative, seedable augmentation transforms (counterpart of
``ezaudio_tpu/data/transforms.py``).

Equivalent of the reference's ``audiotools/data/transforms.py`` protocol
(~30 transforms sharing instantiate/apply with Compose/Choose/Repeat
combinators, :21-1539): every transform

  * draws its random parameters from an explicit ``np.random.Generator``
    via ``instantiate`` (so augmentation is reproducible and batchable);
  * applies with probability ``prob``;
  * operates on ``AudioSignal``s.

Implemented transforms cover the ones the EzAudio data recipes use plus the
common codec-training set: VolumeChange, VolumeNorm, BackgroundNoise,
RoomImpulseResponse, LowPass, HighPass, ClippingDistortion, MuLawQuantize,
Quantize, Identity, and the Compose / Choose / Repeat combinators.

Every parameter draw is the JAX package's, from the same generator in the
same order, so a seed gives the same parameters and leaves the generator in
the same state.  The numpy transforms are the same code.  The spectral ones
(``_SpectralTransform`` subclasses, :func:`spectral_gate` and
``SpectralDenoising``) take their STFT, spectral edit and inverse STFT to
the signal's device (``AudioSignal.device``: CUDA unless another is named);
their noise is drawn on the host from the same seeded numpy generators.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ezaudio_tpu_torch.audio import effects
from ezaudio_tpu_torch.audio.signal import AudioSignal
from ezaudio_tpu_torch.utils import resolve_device


def _fit_length(x: np.ndarray, n: int) -> np.ndarray:
    """Trim / zero-pad the time axis to exactly ``n`` samples (duration
    round-trips through seconds can come back one sample short)."""
    x = x[..., :n]
    if x.shape[-1] < n:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])
    return x


def _uniform(rng, lo, hi):
    return float(rng.uniform(lo, hi))


def _cis(phase: torch.Tensor) -> torch.Tensor:
    """exp(1j * phase) as complex64."""
    return torch.polar(torch.ones_like(phase), phase)


def _noise_bins(g: np.random.Generator, shape, device) -> torch.Tensor:
    """Gaussian magnitude times exp(1j * Gaussian phase): two host draws
    from ``g``, in the JAX package's order."""
    mag = torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(device)
    ph = torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(device)
    return mag * _cis(ph)


class BaseTransform:
    def __init__(self, prob: float = 1.0, name: Optional[str] = None):
        self.prob = prob
        self.name = name or type(self).__name__

    def _instantiate(self, rng: np.random.Generator) -> dict:
        return {}

    def instantiate(self, rng: np.random.Generator) -> dict:
        return {"apply": bool(rng.random() < self.prob),
                **self._instantiate(rng)}

    def _transform(self, signal: AudioSignal, **kwargs) -> AudioSignal:
        return signal

    def transform(self, signal: AudioSignal, **kwargs) -> AudioSignal:
        if not kwargs.pop("apply", True):
            return signal
        return self._transform(signal, **kwargs)

    def __call__(self, signal: AudioSignal, rng: np.random.Generator
                 ) -> AudioSignal:
        return self.transform(signal, **self.instantiate(rng))


class Identity(BaseTransform):
    pass


class VolumeChange(BaseTransform):
    def __init__(self, db: Tuple[float, float] = (-12.0, 0.0), **kw):
        super().__init__(**kw)
        self.db = db

    def _instantiate(self, rng):
        return {"db": _uniform(rng, *self.db)}

    def _transform(self, signal, db):
        signal.audio_data = effects.volume_change(signal.audio_data, db)
        return signal


class VolumeNorm(BaseTransform):
    def __init__(self, db: Tuple[float, float] = (-24.0, -24.0), **kw):
        super().__init__(**kw)
        self.db = db

    def _instantiate(self, rng):
        return {"db": _uniform(rng, *self.db)}

    def _transform(self, signal, db):
        return signal.normalize(db)


class BackgroundNoise(BaseTransform):
    def __init__(self, snr: Tuple[float, float] = (10.0, 30.0),
                 sources: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        self.snr = snr
        self.sources = list(sources or [])

    def _instantiate(self, rng):
        out = {"snr": _uniform(rng, *self.snr),
               "seed": int(rng.integers(2**31 - 1))}
        if self.sources:
            out["source"] = self.sources[int(rng.integers(len(self.sources)))]
        return out

    def _transform(self, signal, snr, seed, source=None):
        state = np.random.default_rng(seed)
        if source is not None:
            noise = AudioSignal.excerpt(source, signal.signal_duration,
                                        state=state, sr=signal.sample_rate,
                                        device=signal.device)
            noise_data = noise.audio_data
        else:  # white noise fallback
            noise_data = state.standard_normal(
                signal.audio_data.shape).astype(np.float32) * 0.1
        signal.audio_data = effects.mix(
            signal.audio_data,
            _fit_length(noise_data, signal.signal_length),
            signal.sample_rate, snr)
        return signal


class RoomImpulseResponse(BaseTransform):
    def __init__(self, sources: Sequence[str] = (), **kw):
        super().__init__(**kw)
        self.sources = list(sources)

    def _instantiate(self, rng):
        return {"source": self.sources[int(rng.integers(len(self.sources)))]} \
            if self.sources else {}

    def _transform(self, signal, source=None):
        if source is None:
            return signal
        ir = AudioSignal.load(source, sr=signal.sample_rate)
        signal.audio_data = effects.apply_ir(signal.audio_data,
                                             ir.audio_data[0, 0])
        return signal


class LowPass(BaseTransform):
    def __init__(self, cutoff: Tuple[float, float] = (4000.0, 8000.0), **kw):
        super().__init__(**kw)
        self.cutoff = cutoff

    def _instantiate(self, rng):
        return {"cutoff": _uniform(rng, *self.cutoff)}

    def _transform(self, signal, cutoff):
        signal.audio_data = effects.lowpass_biquad(
            signal.audio_data, signal.sample_rate, cutoff)
        return signal


class HighPass(BaseTransform):
    def __init__(self, cutoff: Tuple[float, float] = (50.0, 250.0), **kw):
        super().__init__(**kw)
        self.cutoff = cutoff

    def _instantiate(self, rng):
        return {"cutoff": _uniform(rng, *self.cutoff)}

    def _transform(self, signal, cutoff):
        signal.audio_data = effects.highpass_biquad(
            signal.audio_data, signal.sample_rate, cutoff)
        return signal


class ClippingDistortion(BaseTransform):
    def __init__(self, perc: Tuple[float, float] = (0.0, 0.1), **kw):
        super().__init__(**kw)
        self.perc = perc

    def _instantiate(self, rng):
        return {"perc": _uniform(rng, *self.perc)}

    def _transform(self, signal, perc):
        signal.audio_data = effects.clip_distortion(signal.audio_data, 1 - perc)
        return signal


class MuLawQuantize(BaseTransform):
    def __init__(self, channels: int = 256, **kw):
        super().__init__(**kw)
        self.channels = channels

    def _transform(self, signal):
        signal.audio_data = effects.mulaw_quantization(
            signal.audio_data, self.channels)
        return signal


class Quantize(BaseTransform):
    def __init__(self, channels: Tuple[int, int] = (8, 32), **kw):
        super().__init__(**kw)
        self.channels = channels

    def _instantiate(self, rng):
        return {"channels": int(rng.integers(*self.channels))}

    def _transform(self, signal, channels):
        signal.audio_data = effects.quantization(signal.audio_data, channels)
        return signal


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------

class Compose(BaseTransform):
    def __init__(self, transforms: List[BaseTransform], **kw):
        super().__init__(**kw)
        self.transforms = transforms

    def _instantiate(self, rng):
        return {"states": [t.instantiate(rng) for t in self.transforms]}

    def _transform(self, signal, states):
        for t, s in zip(self.transforms, states):
            signal = t.transform(signal, **s)
        return signal


class Choose(BaseTransform):
    """Apply exactly one transform, chosen with the given weights."""

    def __init__(self, transforms: List[BaseTransform],
                 weights: Optional[Sequence[float]] = None, **kw):
        super().__init__(**kw)
        self.transforms = transforms
        w = np.asarray(weights if weights is not None else
                       [1.0] * len(transforms), np.float64)
        self.weights = w / w.sum()

    def _instantiate(self, rng):
        idx = int(rng.choice(len(self.transforms), p=self.weights))
        return {"idx": idx, "state": self.transforms[idx].instantiate(rng)}

    def _transform(self, signal, idx, state):
        return self.transforms[idx].transform(signal, **state)


class Repeat(BaseTransform):
    def __init__(self, transform: BaseTransform, n: int = 2, **kw):
        super().__init__(**kw)
        self.inner = transform
        self.n = n

    def _instantiate(self, rng):
        return {"states": [self.inner.instantiate(rng) for _ in range(self.n)]}

    def _transform(self, signal, states):
        for s in states:
            signal = self.inner.transform(signal, **s)
        return signal


# ---------------------------------------------------------------------------
# Spectral / phase transforms (audiotools transforms.py: FrequencyMask,
# TimeMask, CorruptPhase, ShiftPhase, InvertPhase, Smoothing, Silence)
# ---------------------------------------------------------------------------

class _SpectralTransform(BaseTransform):
    n_fft: int = 2048
    hop: int = 512

    def _apply_spec(self, signal: AudioSignal, fn) -> AudioSignal:
        """``fn`` edits the (B * C, F, frames) complex STFT on the signal's
        device."""
        from ezaudio_tpu_torch.audio.stft import istft, stft

        B, C, T = signal.audio_data.shape
        dev = resolve_device(signal.device)
        flat = torch.from_numpy(signal.audio_data.reshape(B * C, T)).to(dev)
        spec = fn(stft(flat, self.n_fft, self.hop))
        rec = istft(spec, self.n_fft, self.hop, length=T).cpu().numpy()
        signal.audio_data = rec.reshape(B, C, T).astype(np.float32)
        return signal


class FrequencyMask(_SpectralTransform):
    def __init__(self, f_center: Tuple[float, float] = (0.0, 1.0),
                 f_width: Tuple[float, float] = (0.05, 0.15), **kw):
        super().__init__(**kw)
        self.f_center, self.f_width = f_center, f_width

    def _instantiate(self, rng):
        return {"center": _uniform(rng, *self.f_center),
                "width": _uniform(rng, *self.f_width)}

    def _transform(self, signal, center, width):
        def fn(spec):
            F = spec.shape[1]
            lo = int(max(0, (center - width / 2) * F))
            hi = int(min(F, (center + width / 2) * F))
            spec[:, lo:hi, :] = 0
            return spec

        return self._apply_spec(signal, fn)


class TimeMask(_SpectralTransform):
    def __init__(self, t_center: Tuple[float, float] = (0.0, 1.0),
                 t_width: Tuple[float, float] = (0.05, 0.15), **kw):
        super().__init__(**kw)
        self.t_center, self.t_width = t_center, t_width

    def _instantiate(self, rng):
        return {"center": _uniform(rng, *self.t_center),
                "width": _uniform(rng, *self.t_width)}

    def _transform(self, signal, center, width):
        def fn(spec):
            Tf = spec.shape[2]
            lo = int(max(0, (center - width / 2) * Tf))
            hi = int(min(Tf, (center + width / 2) * Tf))
            spec[:, :, lo:hi] = 0
            return spec

        return self._apply_spec(signal, fn)


class InvertPhase(_SpectralTransform):
    def _transform(self, signal):
        signal.audio_data = -signal.audio_data
        return signal


class ShiftPhase(_SpectralTransform):
    def __init__(self, shift: Tuple[float, float] = (-np.pi, np.pi), **kw):
        super().__init__(**kw)
        self.shift = shift

    def _instantiate(self, rng):
        return {"shift": _uniform(rng, *self.shift)}

    def _transform(self, signal, shift):
        def fn(spec):
            return spec * complex(np.exp(1j * shift))

        return self._apply_spec(signal, fn)


class CorruptPhase(_SpectralTransform):
    def __init__(self, scale: Tuple[float, float] = (0.1, 1.0), **kw):
        super().__init__(**kw)
        self.scale = scale

    def _instantiate(self, rng):
        return {"scale": _uniform(rng, *self.scale),
                "seed": int(rng.integers(2**31 - 1))}

    def _transform(self, signal, scale, seed):
        def fn(spec):
            noise = np.random.default_rng(seed).uniform(
                -np.pi * scale, np.pi * scale, spec.shape).astype(np.float32)
            return spec * _cis(torch.from_numpy(noise).to(spec.device))

        return self._apply_spec(signal, fn)


class Smoothing(BaseTransform):
    """Convolve with a short window (audiotools Smoothing)."""

    def __init__(self, window_len: Tuple[int, int] = (8, 64), **kw):
        super().__init__(**kw)
        self.window_len = window_len

    def _instantiate(self, rng):
        return {"n": int(rng.integers(*self.window_len))}

    def _transform(self, signal, n):
        win = np.hanning(n).astype(np.float32)
        win /= win.sum()
        from scipy.signal import fftconvolve

        signal.audio_data = fftconvolve(
            signal.audio_data, win[None, None, :], mode="same").astype(np.float32)
        return signal


class Silence(BaseTransform):
    def _transform(self, signal):
        signal.audio_data = np.zeros_like(signal.audio_data)
        return signal


# ---------------------------------------------------------------------------
# The remaining audiotools transforms
# (reference audiotools/data/transforms.py:502-1539)
# ---------------------------------------------------------------------------

class RepeatUpTo(Choose):
    """Apply a transform a random number of times (1..max_repeat-1), chosen
    with the given weights (reference transforms.py:502)."""

    def __init__(self, transform: BaseTransform, max_repeat: int = 5,
                 weights: Optional[Sequence[float]] = None, **kw):
        import copy

        if max_repeat < 2:
            raise ValueError(
                f"RepeatUpTo needs max_repeat >= 2 (applies the transform "
                f"1..max_repeat-1 times); got {max_repeat}")
        inner = [Repeat(copy.copy(transform), n=n)
                 for n in range(1, max_repeat)]
        super().__init__(inner, weights=weights, **kw)
        self.max_repeat = max_repeat


class Equalizer(BaseTransform):
    """Random mel-spaced EQ cut: each band is attenuated by up to
    ``eq_amount`` dB (reference transforms.py:564)."""

    def __init__(self, eq_amount: float = 1.0, n_bands: int = 6, **kw):
        super().__init__(**kw)
        self.eq_amount = eq_amount
        self.n_bands = n_bands

    def _instantiate(self, rng):
        return {"eq": (-self.eq_amount
                       * rng.random(self.n_bands)).tolist()}

    def _transform(self, signal, eq):
        signal.audio_data = effects.equalizer(
            signal.audio_data, signal.sample_rate,
            np.asarray(eq, np.float32))
        return signal


class NoiseFloor(BaseTransform):
    """Add a Gaussian noise floor normalized to ``db`` LUFS
    (reference transforms.py:669)."""

    def __init__(self, db: Tuple[float, float] = (-50.0, -50.0), **kw):
        super().__init__(**kw)
        self.db = db

    def _instantiate(self, rng):
        return {"db": _uniform(rng, *self.db),
                "seed": int(rng.integers(2**31 - 1))}

    def _transform(self, signal, db, seed):
        nz = np.random.default_rng(seed).standard_normal(
            signal.audio_data.shape).astype(np.float32)
        nz_sig = AudioSignal(nz, signal.sample_rate).normalize(db)
        signal.audio_data = signal.audio_data + nz_sig.audio_data
        return signal


class CrossTalk(BaseTransform):
    """Mix in a second speaker/source at a given SNR, then restore the
    original loudness (reference transforms.py:795)."""

    def __init__(self, snr: Tuple[float, float] = (0.0, 10.0),
                 sources: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        self.snr = snr
        self.sources = list(sources or [])

    def _instantiate(self, rng):
        out = {"snr": _uniform(rng, *self.snr),
               "seed": int(rng.integers(2**31 - 1))}
        if self.sources:
            out["source"] = self.sources[int(rng.integers(len(self.sources)))]
        return out

    def _transform(self, signal, snr, seed, source=None):
        loudness = signal.loudness()
        if source is not None:
            other = AudioSignal.excerpt(
                source, signal.signal_duration,
                state=np.random.default_rng(seed), sr=signal.sample_rate,
                device=signal.device)
            other_data = np.broadcast_to(
                _fit_length(other.audio_data, signal.signal_length),
                signal.audio_data.shape)
        else:  # synthetic talker: band-limited noise
            other_data = np.random.default_rng(seed).standard_normal(
                signal.audio_data.shape).astype(np.float32)
            other_data = effects.lowpass_biquad(
                other_data, signal.sample_rate, 3500.0)
        signal.audio_data = effects.mix(
            signal.audio_data, _fit_length(other_data, signal.signal_length),
            signal.sample_rate, snr)
        if np.isfinite(loudness):
            signal.normalize(loudness)
        return signal


class GlobalVolumeNorm(BaseTransform):
    """VolumeNorm against the WHOLE source file's loudness (carried in
    ``signal.metadata['loudness']`` by the manifest loader) rather than the
    excerpt's own (reference transforms.py:1006)."""

    def __init__(self, db: Tuple[float, float] = (-24.0, -24.0), **kw):
        super().__init__(**kw)
        self.db = db

    def _instantiate(self, rng):
        return {"db": _uniform(rng, *self.db)}

    def _transform(self, signal, db):
        src = signal.metadata.get("loudness")
        if src is None or not np.isfinite(float(src)):
            return signal
        signal.audio_data = effects.volume_change(
            signal.audio_data, db - float(src))
        return signal


class RescaleAudio(BaseTransform):
    """Rescale into [-val, val] only when the audio exceeds those bounds —
    undoes clipping introduced by earlier transforms (reference
    transforms.py:1173)."""

    def __init__(self, val: float = 1.0, **kw):
        super().__init__(**kw)
        self.val = val

    def _transform(self, signal):
        return signal.ensure_max_of_audio(self.val)


class MaskLowMagnitudes(_SpectralTransform):
    """Zero STFT bins whose log-magnitude falls below ``db_cutoff``
    (reference transforms.py:1372; dsp.mask_low_magnitudes)."""

    def __init__(self, db_cutoff: Tuple[float, float] = (-10.0, 10.0), **kw):
        super().__init__(**kw)
        self.db_cutoff = db_cutoff

    def _instantiate(self, rng):
        return {"db_cutoff": _uniform(rng, *self.db_cutoff)}

    def _transform(self, signal, db_cutoff):
        def fn(spec):
            log_mag = 20.0 * torch.log10(spec.abs().clamp_min(1e-10))
            return torch.where(log_mag < db_cutoff, torch.zeros_like(spec), spec)

        return self._apply_spec(signal, fn)


class TimeNoise(TimeMask):
    """TimeMask, but the masked region's magnitude AND phase are replaced
    with Gaussian noise instead of zeros (reference transforms.py:1456)."""

    def __init__(self, t_center=(0.0, 1.0), t_width=(0.025, 0.025), **kw):
        super().__init__(t_center=t_center, t_width=t_width, **kw)

    def _instantiate(self, rng):
        out = super()._instantiate(rng)
        out["seed"] = int(rng.integers(2**31 - 1))
        return out

    def _transform(self, signal, center, width, seed):
        def fn(spec):
            Tf = spec.shape[2]
            lo = int(max(0, (center - width / 2) * Tf))
            hi = int(min(Tf, (center + width / 2) * Tf))
            shape = (spec.shape[0], spec.shape[1], hi - lo)
            spec[:, :, lo:hi] = _noise_bins(np.random.default_rng(seed), shape, spec.device)
            return spec

        return self._apply_spec(signal, fn)


class FrequencyNoise(FrequencyMask):
    """FrequencyMask filled with noise instead of zeros (reference
    transforms.py:1498)."""

    def __init__(self, f_center=(0.0, 1.0), f_width=(0.1, 0.1), **kw):
        super().__init__(f_center=f_center, f_width=f_width, **kw)

    def _instantiate(self, rng):
        out = super()._instantiate(rng)
        out["seed"] = int(rng.integers(2**31 - 1))
        return out

    def _transform(self, signal, center, width, seed):
        def fn(spec):
            F = spec.shape[1]
            lo = int(max(0, (center - width / 2) * F))
            hi = int(min(F, (center + width / 2) * F))
            shape = (spec.shape[0], hi - lo, spec.shape[2])
            spec[:, lo:hi, :] = _noise_bins(np.random.default_rng(seed), shape, spec.device)
            return spec

        return self._apply_spec(signal, fn)


def _tri_kernel(n_freq: int, n_time: int) -> np.ndarray:
    def tri(n):
        up = np.linspace(0, 1, n + 2)[1:-1]
        return np.concatenate([up, [1.0], up[::-1]])

    kern = np.outer(tri(n_freq), tri(n_time))
    return kern / kern.sum()


def spectral_gate(audio: np.ndarray, sr: int, noise: np.ndarray,
                  denoise_amount: float = 1.0, n_std: float = 3.0,
                  n_freq: int = 3, n_time: int = 5,
                  n_fft: int = 2048, hop: int = 512, device=None) -> np.ndarray:
    """Audacity-style spectral gating noise reduction (reference
    audiotools/ml/layers/spectral_gate.py), on ``device`` (CUDA unless
    another is named):

      1. per-frequency mean/std of the NOISE clip's dB spectrogram;
      2. threshold = mean + n_std * std;
      3. signal bins below threshold form a mask;
      4. mask smoothed by a (2*n_freq+1, 2*n_time+1) triangular kernel
         (zero-filled 'same' convolution, as ``scipy.signal.convolve2d``;
         the kernel is symmetric), scaled by ``denoise_amount``;
      5. signal STFT attenuated by (1 - mask), inverted.

    ``audio``/``noise`` are (B, C, T) float arrays.
    """
    from ezaudio_tpu_torch.audio.stft import istft, stft

    dev = resolve_device(device)
    kern = torch.from_numpy(_tri_kernel(n_freq, n_time).astype(np.float32)).to(dev)

    B, C, T = audio.shape
    flat = torch.from_numpy(np.asarray(audio, np.float32).reshape(B * C, T)).to(dev)
    nz_flat = torch.from_numpy(np.asarray(noise, np.float32).reshape(-1, noise.shape[-1])).to(dev)

    nz_db = 20.0 * torch.log10(stft(nz_flat, n_fft, hop).abs().clamp_min(1e-4))
    thresh = nz_db.mean(-1, keepdim=True) + n_std * nz_db.std(-1, keepdim=True, correction=0)
    # align noise rows with signal rows: flat row index is b*C + c, so
    # tiling a (C,)- or (1,)-row profile keeps per-channel statistics
    if thresh.shape[0] != B * C:
        reps = -(-(B * C) // thresh.shape[0])
        thresh = thresh.repeat(reps, 1, 1)[: B * C]

    spec = stft(flat, n_fft, hop)
    sig_db = 20.0 * torch.log10(spec.abs().clamp_min(1e-4))
    mask = (sig_db < thresh).float()
    mask = torch.nn.functional.conv2d(mask[:, None], kern[None, None],
                                      padding=(n_freq, n_time))[:, 0]
    mask = mask * float(denoise_amount)

    out = istft(spec * (1.0 - mask), n_fft, hop, length=T).cpu().numpy()
    return out.reshape(B, C, T).astype(np.float32)


class SpectralDenoising(Equalizer):
    """Spectral-gate denoising against a random EQ'd noise profile
    (reference transforms.py:1539 + ml/layers/spectral_gate.py)."""

    def __init__(self, eq_amount: float = 1.0,
                 denoise_amount: Tuple[float, float] = (0.8, 1.0),
                 nz_volume: float = -40.0, n_bands: int = 6,
                 n_freq: int = 3, n_time: int = 5, **kw):
        super().__init__(eq_amount=eq_amount, n_bands=n_bands, **kw)
        self.denoise_amount = denoise_amount
        self.nz_volume = nz_volume
        self.n_freq, self.n_time = n_freq, n_time

    def _instantiate(self, rng):
        out = super()._instantiate(rng)
        out["denoise_amount"] = _uniform(rng, *self.denoise_amount)
        out["seed"] = int(rng.integers(2**31 - 1))
        return out

    def _transform(self, signal, eq, denoise_amount, seed):
        nz = np.random.default_rng(seed).standard_normal(
            (1, 1, signal.sample_rate)).astype(np.float32)
        nz_sig = AudioSignal(nz, signal.sample_rate).normalize(self.nz_volume)
        nz_sig.audio_data = effects.equalizer(
            nz_sig.audio_data, nz_sig.sample_rate,
            np.asarray(eq, np.float32))
        signal.audio_data = spectral_gate(
            signal.audio_data, signal.sample_rate, nz_sig.audio_data,
            denoise_amount=denoise_amount,
            n_freq=self.n_freq, n_time=self.n_time, device=signal.device)
        return signal
