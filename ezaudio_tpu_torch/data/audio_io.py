"""Wav IO and resampling on numpy + scipy (the port's copy of the jax-free
``ezaudio_tpu/data/audio_io.py`` parts that editing, CLAP and the HuBERT
conditioner need).

``load_wav`` reads RIFF/WAVE with ``scipy.io.wavfile`` and mirrors
``librosa.load(path, sr=sr)``: float32 in [-1, 1], mono downmix, polyphase
resampling to ``sr``.  Other containers need the JAX package's libavcodec
bridge, which the port does not carry: they raise.
"""

from __future__ import annotations

from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis, on the host."""
    if orig_sr == target_sr:
        return wav
    g = gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(wav.dtype)


def load_wav(path: str, sr: int) -> np.ndarray:
    """A wav file -> its float32 mono waveform (T,) at ``sr``."""
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
        wav = wav.mean(axis=1)
    return resample(wav, file_sr, sr)


def peak_normalize(wav: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Peak normalization as the reference editing path applies it
    (api/ezaudio.py:147)."""
    return wav / (np.max(np.abs(wav)) + eps)
