"""AudioSignal: a batched waveform container (counterpart of
``ezaudio_tpu/audio/signal.py``).

The load-bearing subset of the reference's descript-audiotools
``AudioSignal`` (audiotools/core/audio_signal.py:53-1681): load, excerpt
and salient excerpt, resample, zero pad, mono, truncate, peak and loudness
normalization, STFT and its magnitude and phase, mel spectrogram, MFCC,
loudness, write, playback embeds, Whisper extraction, arithmetic and
indexing.

``audio_data`` is numpy (B, C, T) float32 on the host, as the JAX
package's is, and every numpy step is the same code (an excerpt draws its
window from the caller's ``np.random.Generator`` as JAX's does).  The
spectral methods (``stft``, ``magnitude``, ``phase``, ``mel_spectrogram``,
``mfcc``) run the port's ``audio/stft.py`` on ``device``: CUDA unless the
signal was given another device (``utils.resolve_device``; with no GPU and
no device named they raise).  They return numpy, as JAX's do.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ezaudio_tpu_torch.audio.loudness import integrated_loudness
from ezaudio_tpu_torch.data.audio_io import load_audio
from ezaudio_tpu_torch.data.audio_io import resample as _resample
from ezaudio_tpu_torch.utils import resolve_device


class AudioSignal:
    def __init__(self, audio_data: np.ndarray, sample_rate: int,
                 metadata: Optional[dict] = None, device=None):
        x = np.asarray(audio_data, np.float32)
        if x.ndim == 1:
            x = x[None, None, :]
        elif x.ndim == 2:
            x = x[None, :, :]
        assert x.ndim == 3, "audio_data must be (T,), (C, T) or (B, C, T)"
        self.audio_data = x
        self.sample_rate = int(sample_rate)
        # side-channel facts about the source file (e.g. whole-file
        # "loudness" written by the manifest builder), as in the reference
        # audio_signal metadata dict
        self.metadata = dict(metadata or {})
        # where the spectral methods run (resolved at each use)
        self.device = device

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path: str, sr: Optional[int] = None, offset: float = 0.0,
             duration: Optional[float] = None, device=None) -> "AudioSignal":
        wav, rate = load_audio(path, sr=sr, mono=False)
        if wav.ndim == 1:
            wav = wav[None, :]
        if offset or duration is not None:
            s = int(offset * rate)
            e = s + int(duration * rate) if duration is not None else None
            wav = wav[:, s:e]
        return cls(wav, rate, device=device)

    @classmethod
    def _excerpt_of(cls, sig: "AudioSignal", duration: float, rng: np.random.Generator,
                    offset: Optional[int] = None) -> "AudioSignal":
        n = int(duration * sig.sample_rate)
        total = sig.signal_length
        start = (int(rng.integers(0, max(total - n, 0) + 1))
                 if offset is None else int(offset))
        out = sig.audio_data[..., start: start + n]
        if out.shape[-1] < n:
            out = np.pad(out, ((0, 0), (0, 0), (0, n - out.shape[-1])))
        return cls(out, sig.sample_rate, metadata={"offset": start}, device=sig.device)

    @classmethod
    def excerpt(cls, path: str, duration: float, state: Optional[np.random.Generator] = None,
                sr: Optional[int] = None, offset: Optional[int] = None,
                device=None) -> "AudioSignal":
        """Random fixed-duration excerpt (audio_signal.py excerpt).  Pass
        ``offset`` (samples at the target rate) to pin the window, as
        aligned paired-data loading does; the drawn offset is recorded in
        ``metadata["offset"]`` either way."""
        return cls._excerpt_of(cls.load(path, sr=sr, device=device), duration,
                               state or np.random.default_rng(), offset)

    @classmethod
    def salient_excerpt(cls, path: str, duration: float, loudness_cutoff: float = -40.0,
                        max_tries: int = 8, state: Optional[np.random.Generator] = None,
                        sr: Optional[int] = None, device=None) -> "AudioSignal":
        """Re-draw excerpts until one is louder than the cutoff
        (audio_signal.py salient_excerpt).  The file is decoded and
        resampled once; only the window is redrawn per try."""
        rng = state or np.random.default_rng()
        sig = cls.load(path, sr=sr, device=device)
        best = None
        for _ in range(max_tries):
            ex = cls._excerpt_of(sig, duration, rng)
            if ex.loudness() > loudness_cutoff:
                return ex
            best = ex
        return best

    # ------------------------------------------------------------------
    @property
    def batch_size(self):
        return self.audio_data.shape[0]

    @property
    def num_channels(self):
        return self.audio_data.shape[1]

    @property
    def signal_length(self):
        return self.audio_data.shape[-1]

    @property
    def signal_duration(self):
        return self.signal_length / self.sample_rate

    # ------------------------------------------------------------------
    def to(self, device) -> "AudioSignal":
        """Run the spectral methods on ``device`` from now on."""
        self.device = device
        return self

    def clone(self) -> "AudioSignal":
        return copy.deepcopy(self)

    def to_mono(self) -> "AudioSignal":
        self.audio_data = self.audio_data.mean(axis=1, keepdims=True)
        return self

    def resample(self, sample_rate: int) -> "AudioSignal":
        if sample_rate != self.sample_rate:
            self.audio_data = _resample(self.audio_data, self.sample_rate, sample_rate)
            self.sample_rate = sample_rate
        return self

    def zero_pad(self, before: int, after: int) -> "AudioSignal":
        self.audio_data = np.pad(self.audio_data, ((0, 0), (0, 0), (before, after)))
        return self

    def zero_pad_to(self, length: int) -> "AudioSignal":
        return self.zero_pad(0, max(0, length - self.signal_length))

    def truncate_samples(self, length: int) -> "AudioSignal":
        self.audio_data = self.audio_data[..., :length]
        return self

    def peak_normalize(self, eps: float = 1e-9) -> "AudioSignal":
        self.audio_data = self.audio_data / (np.abs(self.audio_data).max() + eps)
        return self

    def loudness(self):
        """Integrated LUFS: a float for batch 1, (B,) array otherwise (per
        item, as audiotools measures it)."""
        vals = np.array([integrated_loudness(item.T, self.sample_rate)
                         for item in self.audio_data])
        return float(vals[0]) if len(vals) == 1 else vals

    def normalize(self, db: float = -24.0) -> "AudioSignal":
        """Loudness-normalize each item to ``db`` LUFS (audiotools effects
        normalize)."""
        cur = np.atleast_1d(self.loudness())
        gain = np.where(np.isfinite(cur), 10.0 ** ((db - cur) / 20), 1.0)
        self.audio_data = self.audio_data * gain[:, None, None]
        return self

    def ensure_max_of_audio(self, maximum: float = 1.0) -> "AudioSignal":
        peak = np.abs(self.audio_data).max()
        if peak > maximum:
            self.audio_data = self.audio_data * (maximum / peak)
        return self

    # ------------------------------------------------------------------
    def _flat(self) -> torch.Tensor:
        """(B * C, T) on the signal's device."""
        B, C, T = self.audio_data.shape
        return torch.from_numpy(self.audio_data.reshape(B * C, T)).to(
            resolve_device(self.device))

    def _unflat(self, x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy().reshape(*self.audio_data.shape[:2], *x.shape[1:])

    def _stft(self, n_fft: int, hop_length: Optional[int]) -> torch.Tensor:
        from ezaudio_tpu_torch.audio.stft import stft as _stft

        return _stft(self._flat(), n_fft, hop_length or n_fft // 4)

    def _mel(self, n_mels: int, n_fft: int, hop_length: Optional[int]) -> torch.Tensor:
        from ezaudio_tpu_torch.audio.stft import mel_spectrogram as _mel

        return _mel(self._flat(), self.sample_rate, n_fft, hop_length or n_fft // 4, n_mels)

    def stft(self, n_fft: int = 2048, hop_length: Optional[int] = None) -> np.ndarray:
        """Complex (B, C, 1 + n_fft // 2, frames)."""
        return self._unflat(self._stft(n_fft, hop_length))

    def magnitude(self, n_fft: int = 2048, hop_length: Optional[int] = None) -> np.ndarray:
        return self._unflat(self._stft(n_fft, hop_length).abs())

    def phase(self, n_fft: int = 2048, hop_length: Optional[int] = None) -> np.ndarray:
        return self._unflat(self._stft(n_fft, hop_length).angle())

    def mel_spectrogram(self, n_mels: int = 80, n_fft: int = 2048,
                        hop_length: Optional[int] = None) -> np.ndarray:
        """(B, C, n_mels, frames) magnitude mel spectrogram."""
        return self._unflat(self._mel(n_mels, n_fft, hop_length))

    def mfcc(self, n_mfcc: int = 40, n_mels: int = 80, log_offset: float = 1e-6,
             n_fft: int = 2048, hop_length: Optional[int] = None) -> np.ndarray:
        """Mel-frequency cepstral coefficients: log-mel projected by an
        orthonormal DCT-II (reference audio_signal.py:1398-1426), on the
        device.  Returns (B, C, n_mfcc, frames)."""
        log_mel = torch.log(self._mel(n_mels, n_fft, hop_length) + log_offset)
        # orthonormal DCT-II matrix (n_mels, n_mfcc), torchaudio create_dct
        n = np.arange(n_mels, dtype=np.float64)
        k = np.arange(n_mfcc, dtype=np.float64)
        dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
        dct *= np.sqrt(2.0 / n_mels)
        dct[:, 0] *= 1.0 / np.sqrt(2.0)
        dct = torch.from_numpy(dct.astype(np.float32)).to(log_mel.device)
        return self._unflat(torch.einsum("bmt,mk->bkt", log_mel, dct))

    # ------------------------------------------------------------------
    def write(self, path: str) -> "AudioSignal":
        from ezaudio_tpu_torch.data.audio_io import save_audio

        save_audio(path, self.audio_data[0].T, self.sample_rate)
        return self

    # ------------------------------------------------------------------
    # Playback and notebook embeds (PlayMixin, playback.py:39-216)
    def embed(self, display: bool = True) -> str:
        from ezaudio_tpu_torch.audio.playback import embed_html

        return embed_html(self.audio_data[0], self.sample_rate, display=display)

    def widget(self, title: Optional[str] = None, **kwargs) -> str:
        from ezaudio_tpu_torch.audio.playback import widget_html

        kwargs.setdefault("device", self.device)
        return widget_html(self.audio_data[0], self.sample_rate, title=title, **kwargs)

    def play(self) -> "AudioSignal":
        from ezaudio_tpu_torch.audio.playback import play as _play

        _play(self.audio_data[0], self.sample_rate)
        return self

    # ------------------------------------------------------------------
    # Whisper extraction (WhisperMixin, whisper.py:7-97).  ``wrapper`` is a
    # ``WhisperTranscriber`` (models/whisper.py) or a transformers-backed
    # ``WhisperWrapper`` (audio/whisper.py); features need none.
    def get_whisper_features(self, wrapper=None):
        if wrapper is not None:
            return wrapper.features(self.audio_data[0], self.sample_rate)
        from ezaudio_tpu_torch.audio.whisper import whisper_features

        return whisper_features(self.audio_data[0], self.sample_rate)

    def get_whisper_transcript(self, wrapper):
        return wrapper.transcript(self.audio_data[0], self.sample_rate)

    def get_whisper_embeddings(self, wrapper):
        return wrapper.embeddings(self.audio_data[0], self.sample_rate)

    # ------------------------------------------------------------------
    def _coerce(self, other):
        return other.audio_data if isinstance(other, AudioSignal) else other

    def __add__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data + self._coerce(other)
        return out

    __radd__ = __add__

    def __sub__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data - self._coerce(other)
        return out

    def __neg__(self):
        out = self.clone()
        out.audio_data = -out.audio_data
        return out

    def __mul__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data * self._coerce(other)
        return out

    __rmul__ = __mul__

    def __truediv__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data / self._coerce(other)
        return out

    def __iadd__(self, other):
        self.audio_data = self.audio_data + self._coerce(other)
        return self

    def __imul__(self, other):
        self.audio_data = self.audio_data * self._coerce(other)
        return self

    def __len__(self):
        return self.batch_size

    def __eq__(self, other):
        if not isinstance(other, AudioSignal):
            return NotImplemented
        return (self.sample_rate == other.sample_rate
                and self.audio_data.shape == other.audio_data.shape
                and bool(np.array_equal(self.audio_data, other.audio_data)))

    __hash__ = None

    def apply_codec(self, preset: str = "8-bit") -> "AudioSignal":
        """Lossy-codec degradation simulation (effects.apply_codec)."""
        from ezaudio_tpu_torch.audio.effects import apply_codec as _ac

        self.audio_data = _ac(self.audio_data, self.sample_rate, preset)
        return self

    def __getitem__(self, idx) -> "AudioSignal":
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return AudioSignal(self.audio_data[idx], self.sample_rate, device=self.device)

    @classmethod
    def batch(cls, signals) -> "AudioSignal":
        """Collate same-rate signals, zero-padding to the longest
        (audiotools util.collate); the first signal's device."""
        sr = signals[0].sample_rate
        assert all(s.sample_rate == sr for s in signals)
        n = max(s.signal_length for s in signals)
        data = np.concatenate([s.clone().zero_pad_to(n).audio_data for s in signals], axis=0)
        return cls(data, sr, device=signals[0].device)

    def __repr__(self):
        return (f"AudioSignal(batch={self.batch_size}, ch={self.num_channels}, "
                f"dur={self.signal_duration:.2f}s @ {self.sample_rate} Hz)")
