"""Wav IO and resampling on numpy + scipy (the port's copy of the jax-free
``ezaudio_tpu/data/audio_io.py`` parts that editing, CLAP, the HuBERT
conditioner and the training data need).

``load_wav`` reads RIFF/WAVE with ``scipy.io.wavfile`` and mirrors
``librosa.load(path, sr=sr)``: float32 in [-1, 1], mono downmix (or the
channels as (C, T) with ``mono=False``), polyphase resampling to ``sr``.
``save_wav`` writes f32 or 16-bit PCM RIFF.  Other containers need the JAX
package's libavcodec bridge, which the port does not carry: they raise.
"""

from __future__ import annotations

from math import gcd
from typing import Optional

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis, on the host."""
    if orig_sr == target_sr:
        return wav
    g = gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(wav.dtype)


def load_wav(path: str, sr: Optional[int] = None, mono: bool = True) -> np.ndarray:
    """A wav file -> its float32 waveform at ``sr`` (the file's rate when
    None): (T,) mono, or with ``mono=False`` (C, T) for a multichannel
    file and (T,) for a mono one."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError(f"{path}: only RIFF/WAVE files are supported")
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
    return wav if sr is None else resample(wav, file_sr, sr)


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


def peak_normalize(wav: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Peak normalization as the reference editing path applies it
    (api/ezaudio.py:147)."""
    return wav / (np.max(np.abs(wav)) + eps)
