"""Playable HTML embeds and widgets for audio (native, no ffmpeg; the
port's copy of ``ezaudio_tpu/audio/playback.py``).

Equivalent surface to the reference's PlayMixin
(audiotools/core/playback.py:39-216): `embed` wraps the
audio in a playable HTML5 element, `widget` builds a spectrogram +
click-to-seek player (the melnet-style widget), `play` shells out to
ffplay when available.  Where the reference converts through ffmpy and
depends on IPython, everything here is self-contained HTML with base64
data URIs: wav needs no external encoder, so the embeds work in any
browser/notebook with zero binaries installed.  IPython display is used
opportunistically when present, never required.
"""

from __future__ import annotations

import base64
import io
import shutil
import string
import subprocess
from typing import Optional

import numpy as np

_HEADERS = """
<style>
.ez-player { width: PLAYER_WIDTH; margin: MARGIN; font-family: sans-serif; }
.ez-player .ez-title { font-size: 0.9em; text-align: right; color: #444; }
.ez-player .ez-spec { position: relative; }
.ez-player .ez-spec img { width: 100%; display: block; }
.ez-player .ez-cursor { position: absolute; top: 0; bottom: 0; left: 0;
  width: 2px; background: rgba(255, 64, 64, 0.85); pointer-events: none; }
.ez-player audio { width: 100%; margin-top: 4px; }
</style>
"""

_WIDGET = """
<div class="ez-player" id="PLAYER_ID">
  <div class="ez-title">TITLE</div>
  <div class="ez-spec" onclick="ezSeek_PLAYER_ID(event)">
    <img src="IMAGE_SRC"/>
    <div class="ez-cursor"></div>
  </div>
  AUDIO_TAG
</div>
<script>
(function() {
  var root = document.getElementById("PLAYER_ID");
  var audio = root.querySelector("audio");
  var cursor = root.querySelector(".ez-cursor");
  var spec = root.querySelector(".ez-spec");
  audio.addEventListener("timeupdate", function() {
    if (audio.duration)
      cursor.style.left = (100 * audio.currentTime / audio.duration) + "%";
  });
  window["ezSeek_PLAYER_ID"] = function(ev) {
    var rect = spec.getBoundingClientRect();
    if (audio.duration) {
      audio.currentTime = audio.duration * (ev.clientX - rect.left) / rect.width;
      audio.play();
    }
  };
})();
</script>
"""


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """(channels, samples) or (samples,) float -> 16-bit PCM wav bytes."""
    from scipy.io import wavfile

    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:  # (channels, samples) -> (samples, channels)
        wav = wav.T
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, int(sr), pcm)
    return buf.getvalue()


def embed_html(wav: np.ndarray, sr: int, display: bool = True) -> str:
    """Playable `<audio>` element with the wav inlined as a base64 data URI
    (playback.py:39 `embed`; `return_html=True` is the only mode — the
    string renders identically through IPython or a plain HTML file)."""
    b64 = base64.b64encode(_wav_bytes(wav, sr)).decode("ascii")
    tag = (f'<audio controls src="data:audio/wav;base64,{b64}">'
           f"</audio>")
    if display:
        _maybe_ipython_display(tag)
    return tag


def widget_html(wav: np.ndarray, sr: int, title: Optional[str] = None,
                plot_fn: str = "specshow", add_headers: bool = True,
                player_width: str = "100%", margin: str = "10px",
                display: bool = True, device=None) -> str:
    """Spectrogram player widget (playback.py:96 `widget`): the plot image
    with a playhead cursor, click-to-seek, and the audio element below.
    `plot_fn` selects the image ('specshow' | 'waveplot' | 'wavespec',
    matching the display module's figures); its mel spectrogram runs on
    ``device`` (CUDA unless another is named)."""
    from ezaudio_tpu_torch.audio import display as _disp

    mono = np.asarray(wav, np.float32)
    if mono.ndim == 2:
        mono = mono.mean(axis=0)

    if plot_fn == "specshow":
        img = _disp.spec_data_uri(mono, sr, device=device)
    else:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        out = (_disp.waveplot(mono, sr) if plot_fn == "waveplot"
               else getattr(_disp, plot_fn)(mono, sr, device=device))
        fig = out.figure if hasattr(out, "figure") and out.figure else out
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=80, bbox_inches="tight")
        plt.close(fig)
        img = ("data:image/png;base64,"
               + base64.b64encode(buf.getvalue()).decode("ascii"))

    # Deterministic id from content so repeated renders of the same clip
    # don't collide with each other in one document.
    seed = int(np.abs(mono[: 1024]).sum() * 1e6) % (10 ** 9)
    rng = np.random.default_rng(seed)
    pid = "".join(rng.choice(list(string.ascii_uppercase), size=10))

    html = "" if not add_headers else (
        _HEADERS.replace("PLAYER_WIDTH", player_width).replace("MARGIN", margin))
    body = (_WIDGET
            .replace("PLAYER_ID", pid)
            .replace("TITLE", title or "")
            .replace("IMAGE_SRC", img)
            .replace("AUDIO_TAG", embed_html(wav, sr, display=False)))
    html += body
    if display:
        _maybe_ipython_display(html)
    return html


def play(wav: np.ndarray, sr: int) -> None:
    """Play through ffplay if installed (playback.py:192); loud error
    otherwise — the project has no native audio output."""
    if shutil.which("ffplay") is None:
        raise RuntimeError(
            "play() requires ffplay (ffmpeg suite), which is not installed; "
            "use embed_html()/widget_html() to render "
            "a playable HTML element instead.")
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(_wav_bytes(wav, sr))
        f.flush()
        subprocess.call(["ffplay", "-nodisp", "-autoexit", "-hide_banner",
                         "-loglevel", "error", f.name])


def _maybe_ipython_display(html: str) -> None:
    try:  # pragma: no cover - exercised only inside notebooks
        from IPython.display import HTML, display as _d
        get_ipython  # noqa: B018 - defined only inside IPython  # type: ignore[name-defined]
        _d(HTML(html))
    except (ImportError, NameError):
        pass
