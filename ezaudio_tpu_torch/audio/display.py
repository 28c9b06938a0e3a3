"""Spectrogram/waveform display helpers (counterpart of
``ezaudio_tpu/audio/display.py``; reference ``audiotools/core/display.py``:
specshow/waveplot/wavespec/save_image; figures can also be embedded into
the HTML reports as data URIs).  matplotlib is imported inside each
function, so the module imports where it is not installed; the mel
spectrograms run on ``device`` (``AudioSignal``: CUDA unless another is
named)."""

from __future__ import annotations

import base64
import io
from typing import Optional

import numpy as np


def _mel_db(wav: np.ndarray, sr: int, n_mels: int = 128,
            n_fft: int = 2048, hop: Optional[int] = None, device=None):
    from ezaudio_tpu_torch.audio.signal import AudioSignal

    sig = AudioSignal(wav, sr, device=device)
    m = sig.mel_spectrogram(n_mels=n_mels, n_fft=n_fft, hop_length=hop)
    return 20.0 * np.log10(np.maximum(m[0, 0], 1e-8))


def specshow(wav: np.ndarray, sr: int, ax=None, n_mels: int = 128,
             title: Optional[str] = None, device=None):
    """Log-mel spectrogram plot (display.py:35 equivalent)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 3))
    db = _mel_db(wav, sr, n_mels=n_mels, device=device)
    dur = np.asarray(wav).reshape(-1).size / sr
    ax.imshow(db, origin="lower", aspect="auto",
              extent=[0, dur, 0, n_mels], cmap="magma",
              vmin=db.max() - 80, vmax=db.max())
    ax.set_xlabel("time (s)")
    ax.set_ylabel("mel bin")
    if title:
        ax.set_title(title)
    return ax


def waveplot(wav: np.ndarray, sr: int, ax=None, title: Optional[str] = None):
    """Waveform plot (display.py:87 equivalent)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 2))
    x = np.asarray(wav).reshape(-1)
    t = np.arange(x.size) / sr
    ax.plot(t, x, linewidth=0.5)
    ax.set_xlabel("time (s)")
    ax.set_ylim(-1.05 * max(1e-6, np.abs(x).max()),
                1.05 * max(1e-6, np.abs(x).max()))
    if title:
        ax.set_title(title)
    return ax


def wavespec(wav: np.ndarray, sr: int, title: Optional[str] = None, device=None):
    """Stacked waveform + spectrogram (display.py:108 equivalent)."""
    import matplotlib.pyplot as plt

    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(8, 5),
                                   height_ratios=[1, 2])
    waveplot(wav, sr, ax=ax0, title=title)
    specshow(wav, sr, ax=ax1, device=device)
    fig.tight_layout()
    return fig


def save_image(wav: np.ndarray, sr: int, path: str, device=None) -> str:
    """Render the wavespec figure to an image file (display.py:167)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    fig = wavespec(wav, sr, device=device)
    fig.savefig(path, dpi=100)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def spec_data_uri(wav: np.ndarray, sr: int, device=None) -> str:
    """Log-mel spectrogram as a PNG data URI (for the HTML reports)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 2.2))
    specshow(wav, sr, ax=ax, device=device)
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=80)
    plt.close(fig)
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:image/png;base64,{b64}"
