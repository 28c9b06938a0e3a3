"""ctypes binding of the threaded C++ wav batch loader
(``native/ezaudio_native.cpp``); the port's copy of
``ezaudio_tpu/data/native_loader.py``.

The library is built on first use with ``g++ -pthread`` into the port's
build directory (``data/native_build.py``).  One :func:`load_batch` call
decodes, crops, pads and peak-normalises a whole batch of wav files in a
thread pool, with each item's status (0, or the negative error of the
file); :func:`available` is False without a compiler.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from ezaudio_tpu_torch.data import native_build

SOURCE = "ezaudio_native.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_failed = False
build_error: Optional[str] = None


def lib_path() -> str:
    return native_build.lib_path(SOURCE, FLAGS)


def get_lib():
    """The loaded library, built if needed; None when it cannot be."""
    global _lib, _lib_failed, build_error
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(native_build.build(SOURCE, FLAGS, timeout=120.0))
    except (OSError, RuntimeError, FileNotFoundError) as e:
        _lib_failed, build_error = True, f"{type(e).__name__}: {e}"
        return None
    lib.ez_decode_wav.restype = ctypes.c_int64
    lib.ez_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.ez_load_batch.restype = ctypes.c_int32
    lib.ez_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise ImportError(f"the native loader is unavailable ({build_error})")
    return lib


def decode_wav(path: str, max_seconds: float = 600.0) -> Tuple[np.ndarray, int]:
    """A whole wav file -> ``(mono float32, sr)``."""
    lib = _require()
    max_frames = int(max_seconds * 384000)
    out = np.empty(max_frames, np.float32)
    sr = ctypes.c_int32(0)
    n = lib.ez_decode_wav(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          max_frames, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"native decode failed ({n}): {path}")
    return out[:n].copy(), int(sr.value)


def load_batch(paths: Sequence[str], seg_len: int, expected_sr: int, normalize: bool = True,
               seed: int = 0, n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """``(B, seg_len)`` float32 crops (a seeded random crop of each file,
    zero padded, peak normalised when ``normalize``) and the per-item
    status (0, or the error: -4 a sample rate other than ``expected_sr``)."""
    lib = _require()
    B = len(paths)
    out = np.zeros((B, seg_len), np.float32)
    status = np.zeros(B, np.int32)
    arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    lib.ez_load_batch(arr, B, seg_len, expected_sr, int(normalize), np.uint64(seed or 1),
                      n_threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, status
