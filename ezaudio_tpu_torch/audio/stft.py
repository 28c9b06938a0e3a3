"""STFT, its inverse and mel filterbanks (counterpart of
``ezaudio_tpu/audio/stft.py`` and of ``_mel_filterbank_htk`` in
``ezaudio_tpu/audio/clap.py``).

The filterbanks are host constants (numpy).  The STFT has the JAX
package's conventions (periodic hann window, centre reflect padding,
one-sided, unnormalized), runs on the tensor's device, and its gradient is
the same in every run.  :func:`istft` overlap-adds without atomics, so two
runs on the card are bit-equal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    """Periodic hann window of length ``n``."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``F.pad(x, (left, right), mode="reflect")`` on the last axis, as
    flipped slices concatenated: its gradient is a sum of slices, the same
    in every run, where the CUDA reflection pad's backward adds with
    atomics in a run-dependent order (a codec step restarted from a
    checkpoint parts from the straight run)."""
    parts = [x]
    if left:
        parts.insert(0, x[..., 1:left + 1].flip(-1))
    if right:
        parts.append(x[..., -right - 1:-1].flip(-1))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def stft(x: torch.Tensor, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """(B, T) -> complex (B, 1 + n_fft // 2, frames): ``torch.stft`` with
    these conventions, framed by ``unfold`` and transformed by ``rfft``, so
    that its gradient sums the same way in every run (torch.stft's
    overlapping ``as_strided`` frames and reflection pad do not on CUDA)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = hann_window(win_length)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    if center:
        x = reflect_pad(x, n_fft // 2, n_fft // 2)
    frames = x.unfold(-1, n_fft, hop_length) * torch.from_numpy(win).to(x.device)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., n_frames, n) frames -> (..., n + (n_frames - 1) * hop): each
    frame added at ``i * hop``.  The frames are cut into ``r = ceil(n / hop)``
    hop-long pieces (zero-padded), and piece j of every frame lands on
    output chunk i + j: r shifted whole-tensor adds, in the same order in
    every run (``index_add_``/``scatter_add_`` sum with atomics on CUDA)."""
    *lead, n_frames, n = frames.shape
    r = -(-n // hop)
    pieces = torch.nn.functional.pad(frames, (0, r * hop - n)).unflatten(-1, (r, hop))
    out = frames.new_zeros(*lead, n_frames + r - 1, hop)
    for j in range(r):
        out[..., j:j + n_frames, :] += pieces[..., j, :]
    return out.flatten(-2)[..., :n + (n_frames - 1) * hop]


def istft(spec: torch.Tensor, n_fft: int, hop_length: Optional[int] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`stft` (centre, periodic hann): complex
    (..., 1 + n_fft // 2, frames) -> (..., T), ``torch.istft(center=True)``
    semantics as ``ezaudio_tpu/audio/stft.py::istft``: the windowed frames
    overlap-added, divided by max(sum of the squared windows, 1e-11), the
    first ``n_fft // 2`` samples dropped, trimmed to ``length``."""
    hop_length = hop_length or n_fft // 4
    win = torch.from_numpy(hann_window(n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * win
    out = overlap_add(frames, hop_length)
    norm = overlap_add(win.square().expand(frames.shape[-2], n_fft), hop_length)
    out = (out / norm.clamp_min(1e-11))[..., n_fft // 2:]
    return out if length is None else out[..., :length]


def _hz_to_mel(f):
    """Slaney mel scale (librosa's default): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, min_log_mel = 1000.0, 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, min_log_mel = 1000.0, 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def _triangles(fft_freqs: np.ndarray, mel_pts: np.ndarray) -> np.ndarray:
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0, np.minimum(lower, upper))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (librosa.filters.mel),
    shape (n_mels, 1 + n_fft // 2)."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    weights = _triangles(fft_freqs, mel_pts)
    weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_filterbank_htk(sr: int, n_fft: int, n_mels: int, fmin: float,
                       fmax: float) -> np.ndarray:
    """torchaudio's default mel filterbank (HTK scale, no area norm), shape
    (n_mels, 1 + n_fft // 2): the filters of CLAP's "fusion" variant."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    mel_pts = 700.0 * (10.0 ** (np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
                                / 2595.0) - 1.0)
    return _triangles(fft_freqs, mel_pts).astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int, hop_length: int, n_mels: int,
                    fmin: float = 0.0, fmax: Optional[float] = None,
                    power: float = 1.0) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames): the slaney mel filterbank over the STFT
    magnitude to ``power`` (``ezaudio_tpu/audio/stft.py::mel_spectrogram``)."""
    spec = stft(x, n_fft, hop_length).abs() ** power
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(spec.device)
    return torch.einsum("mf,bft->bmt", fb, spec)
