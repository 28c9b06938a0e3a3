"""External-binary audio seams (counterpart of ``ezaudio_tpu/audio/external.py``).

The reference's audiotools carries mixins that shell out to external
resources: ffmpeg (ffmpeg.py:87-204: loudness, resampling and loading of
non-wav formats), Whisper transcription (whisper.py), and IPython/gradio
playback.  Here transcription goes through ``audio/whisper.py`` and
playback through ``audio/playback.py``.  :func:`ffmpeg_load` decodes with
the ffmpeg binary when one is installed, else reads a ``.wav`` natively,
else raises ``ImportError``; the JAX package's first choice, its
in-process libavcodec bridge, is not carried by the port yet (ROADMAP
queue 1 item 5).
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def ffmpeg_load(path: str, sr: Optional[int] = None) -> tuple:
    """Decode a file -> (float32 mono, sr): the ffmpeg binary if one
    exists, then the native wav reader for wavs."""
    if ffmpeg_available():
        cmd = ["ffmpeg", "-i", path, "-f", "f32le", "-ac", "1"]
        if sr:
            cmd += ["-ar", str(sr)]
        cmd += ["pipe:1"]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        wav = np.frombuffer(out, np.float32)
        return wav, sr or _probe_sr(path)
    if path.lower().endswith(".wav"):
        from ezaudio_tpu_torch.data.audio_io import load_audio

        return load_audio(path, sr=sr)
    raise ImportError(
        f"Decoding {path} requires an ffmpeg binary (or the native codec bridge, "
        "which the port does not carry yet); neither is available, so only .wav "
        "is supported.")


def _probe_sr(path: str) -> int:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=sample_rate", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True).stdout.strip()
    return int(out)


def transcribe(wav: np.ndarray, sr: int, model: str = "openai/whisper-base", device=None):
    """Whisper transcription (the audiotools whisper mixin) through
    transformers (``audio/whisper.py::WhisperWrapper``): ``model`` must be
    a local snapshot directory; runs on CUDA unless ``device`` names
    another."""
    from ezaudio_tpu_torch.audio.whisper import WhisperWrapper

    return WhisperWrapper(model=model, device=device).transcript(wav, sr)
