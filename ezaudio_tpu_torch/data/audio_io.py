"""Wav IO and resampling on numpy + scipy (the port's copy of the jax-free
``ezaudio_tpu/data/audio_io.py`` parts that editing, CLAP, the HuBERT
conditioner and the training data need).

``load_wav`` reads RIFF/WAVE with ``scipy.io.wavfile`` and mirrors
``librosa.load(path, sr=sr)``: float32 in [-1, 1], mono downmix (or the
channels as (C, T) with ``mono=False``), polyphase resampling to ``sr``.
``save_wav`` writes f32 or 16-bit PCM RIFF.  :func:`load_audio` and
:func:`save_audio` have the JAX package's contract (``load_wav`` /
``save_audio`` of ``ezaudio_tpu/data/audio_io.py``): the reader returns
``(wav, sr)``, ``sr`` the file's own rate when none is asked for.  Every
other container (mp3, flac, ogg, ...) goes through the in-process
libavcodec bridge (``data/codec_loader.py``, ``native/ezaudio_codec.cpp``):
decoded to the same shapes as a wav, resampled by the same polyphase
filter, and written by extension.  Without the bridge (no libav or no
``g++``) they raise ``ImportError``, as the JAX package does.
"""

from __future__ import annotations

from math import gcd
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis, on the host."""
    if orig_sr == target_sr:
        return wav
    g = gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(wav.dtype)


def _is_wav(path: str) -> bool:
    """RIFF/WAVE by magic when readable, by extension otherwise."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
        return head[:4] == b"RIFF" and head[8:12] == b"WAVE"
    except OSError:
        return path.lower().endswith(".wav")


def _bridge(path: str, verb: str):
    """The codec bridge module, or ``ImportError`` when it is unavailable."""
    from ezaudio_tpu_torch.data import codec_loader

    if not codec_loader.available():
        raise ImportError(f"{verb} {path} requires the native codec bridge (libavformat/"
                          "libavcodec + g++), which is unavailable here "
                          f"({codec_loader.build_error}); only .wav is supported without it")
    return codec_loader


def _read_other(path: str, mono: bool):
    """A non-wav file through the bridge, shaped as :func:`_read_wav`'s
    output: (T,) mono, (C, T) multichannel."""
    data, file_sr = _bridge(path, "Decoding").decode(path, mono=mono)
    return (data if mono else (data.T if data.ndim == 2 else data[None, :])), file_sr


def _read_wav(path: str, mono: bool):
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1) if mono else wav.T
    return wav, file_sr


def load_wav(path: str, sr: Optional[int] = None, mono: bool = True) -> np.ndarray:
    """An audio file -> its float32 waveform at ``sr`` (the file's rate when
    None): (T,) mono, or with ``mono=False`` (C, T) for a multichannel
    file and (T,) for a mono one.  Non-wav containers go through the codec
    bridge (``ImportError`` without it)."""
    return load_audio(path, sr=sr, mono=mono)[0]


def load_audio(path: str, sr: Optional[int] = None, mono: bool = True
               ) -> Tuple[np.ndarray, int]:
    """An audio file -> ``(float32 waveform, rate)``: ``librosa.load``
    semantics as the JAX package's ``load_wav``: (T,) mono, or with
    ``mono=False`` (C, T) for a multichannel file; resampled to ``sr`` when
    given, and ``rate`` is then ``sr``.  Non-wav files decode through the
    codec bridge, or raise ``ImportError`` without it."""
    wav, file_sr = _read_wav(path, mono) if _is_wav(path) else _read_other(path, mono)
    if sr is not None and sr != file_sr:
        return resample(wav, file_sr, sr), sr
    return wav, file_sr


def save_wav(path: str, wav: np.ndarray, sr: int, subtype: str = "float") -> None:
    """Write a mono (T,) or multichannel (C, T) / (T, C) wav; ``subtype``
    'float' (f32) or 'pcm16'."""
    wav = np.asarray(wav)
    if wav.ndim == 2 and wav.shape[0] < wav.shape[1]:
        wav = wav.T  # (T, C)
    if subtype == "pcm16":
        data = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    elif subtype == "float":
        data = wav.astype(np.float32)
    else:
        raise ValueError(f"subtype must be 'float' or 'pcm16', got {subtype!r}")
    wavfile.write(path, sr, data)


def save_audio(path: str, wav: np.ndarray, sr: int, subtype: str = "float",
               bitrate: int = 0) -> None:
    """Write audio in the container the extension names: ``.wav`` natively
    (:func:`save_wav`), any other (mp3/flac/ogg/...) through the codec
    bridge at ``bitrate`` (0: the codec's default), or ``ImportError``
    without it."""
    if path.lower().endswith(".wav"):
        return save_wav(path, wav, sr, subtype=subtype)
    codec = _bridge(path, "Encoding")
    wav = np.asarray(wav)
    if wav.ndim == 2 and wav.shape[0] < wav.shape[1]:
        wav = wav.T  # (T, C), as save_wav
    codec.encode(path, wav, sr, bitrate=bitrate)


def peak_normalize(wav: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Peak normalization as the reference editing path applies it
    (api/ezaudio.py:147)."""
    return wav / (np.max(np.abs(wav)) + eps)
