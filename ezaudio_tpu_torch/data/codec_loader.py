"""ctypes binding of the compressed-audio codec bridge
(``native/ezaudio_codec.cpp``, linking the system libavformat, libavcodec
and libavutil); the port's copy of ``ezaudio_tpu/data/codec_loader.py``.

The library is built on first use with ``g++`` into the port's build
directory (``data/native_build.py``).  :func:`available` is False when the
libav libraries or the compiler are missing, or the library does not
load; the callers then read wav only and raise ``ImportError`` on other
containers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ezaudio_tpu_torch.data import native_build

SOURCE = "ezaudio_codec.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lavformat", "-lavcodec", "-lavutil")
ERR_BUFFER_TOO_SMALL = -7

_lib = None
_lib_failed = False
build_error: Optional[str] = None  # why the bridge is unavailable, when it is


def lib_path() -> str:
    return native_build.lib_path(SOURCE, FLAGS)


def get_lib():
    """The loaded library, built if needed; None when it cannot be."""
    global _lib, _lib_failed, build_error
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(native_build.build(SOURCE, FLAGS, LIBS))
    except (OSError, RuntimeError, FileNotFoundError) as e:
        _lib_failed, build_error = True, f"{type(e).__name__}: {e}"
        return None
    lib.ez_codec_probe.restype = ctypes.c_int32
    lib.ez_codec_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
    lib.ez_codec_decode.restype = ctypes.c_int64
    lib.ez_codec_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.ez_codec_encode.restype = ctypes.c_int32
    lib.ez_codec_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise ImportError(f"the native codec bridge is unavailable ({build_error})")
    return lib


def probe(path: str) -> Tuple[int, int, float]:
    """``(sample_rate, channels, duration_s)``; the duration may be the
    container's estimate (-1.0 when unknown)."""
    lib = _require()
    sr, ch, dur = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_double(0.0)
    rc = lib.ez_codec_probe(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                            ctypes.byref(dur))
    if rc != 0:
        raise IOError(f"codec probe failed ({rc}): {path}")
    return int(sr.value), int(ch.value), float(dur.value)


def decode(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode any format libav reads -> ``(float32 audio, sr)``: (frames,)
    when ``mono``, else (frames, channels).  The buffer is sized from the
    container's duration with headroom and doubled while the library
    answers that it is too small (a VBR estimate can undershoot)."""
    lib = _require()
    sr_p, ch_p, dur = probe(path)
    est = int(max(dur, 0.0) * sr_p * (1 if mono else max(ch_p, 1)))
    cap = max(est + est // 8 + (1 << 18), 1 << 20)
    for _ in range(4):
        out = np.empty(cap, np.float32)
        sr, ch = ctypes.c_int32(0), ctypes.c_int32(0)
        n = lib.ez_codec_decode(path.encode(),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                out.size, int(mono), ctypes.byref(sr), ctypes.byref(ch))
        if n == ERR_BUFFER_TOO_SMALL:
            cap *= 2
            continue
        if n < 0:
            raise IOError(f"codec decode failed ({n}): {path}")
        audio = out[:n].copy()
        if not mono and ch.value > 1:
            audio = audio.reshape(-1, ch.value)
        return audio, int(sr.value)
    raise IOError(f"codec decode overflow after retries: {path}")


def encode(path: str, audio: np.ndarray, sr: int, codec: str = "", bitrate: int = 0) -> None:
    """Encode float32 audio, (frames,) or (frames, channels), into ``path``;
    the container follows the extension (.mp3/.flac/.ogg/.wav), ``codec``
    and ``bitrate`` (0: the codec's default) are optional."""
    lib = _require()
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    frames, channels = audio.shape
    pcm = np.ascontiguousarray(audio.reshape(-1))
    rc = lib.ez_codec_encode(path.encode(), pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             frames, int(sr), int(channels), codec.encode(), int(bitrate))
    if rc != 0:
        raise IOError(f"codec encode failed ({rc}): {path}")
