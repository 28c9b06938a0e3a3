"""The port's non-wav audio and native batch loader against the JAX package.

``ezaudio_tpu_torch/data/codec_loader.py`` (the libavcodec bridge) and
``data/native_loader.py`` (the threaded C++ wav batch loader) bind the same
``native/*.cpp`` sources as the JAX package, built into the port's build
directory.  Here each is held to the JAX module bit for bit on the same
inputs: files written by one are read by the other, batches at one seed
are equal, the error statuses are equal.  Test files are made from seeded
noise with the bridge itself; no external asset is read.
"""

import ctypes
import hashlib
import os
import struct

import numpy as np
import pytest

from ezaudio_tpu.data import codec_loader as jcodec
from ezaudio_tpu.data import native_loader as jnative
from ezaudio_tpu_torch.data import audio_io, codec_loader, native_build, native_loader

needs_codec = pytest.mark.skipif(not codec_loader.available(),
                                 reason="libav or g++ missing: the codec bridge is unavailable")
needs_native = pytest.mark.skipif(not native_loader.available(), reason="g++ missing")


def _noise(seed, n, channels=1, amp=0.3):
    x = amp * np.random.default_rng(seed).standard_normal((n, channels))
    return np.clip(x, -0.95, 0.95).astype(np.float32)


def _s16(seed, n, channels=2):
    """Samples on the 16-bit grid, which flac keeps exactly."""
    q = np.random.default_rng(seed).integers(-12000, 12000, size=(n, channels))
    return (q / 32768.0).astype(np.float32)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def _native_tree():
    root = native_build.NATIVE_DIR
    return {n: (os.path.getsize(os.path.join(root, n)), _sha(os.path.join(root, n)))
            for n in sorted(os.listdir(root))}


def test_libraries_build_into_build_dir_and_leave_native_untouched(tmp_path, monkeypatch):
    """A fresh build directory: both libraries are compiled there (one
    private temporary each, renamed into place) and nothing under
    ``native/`` is written."""
    if native_build.gxx() is None:
        pytest.skip("g++ missing")
    before = _native_tree()
    monkeypatch.setenv("EZAUDIO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    path = native_build.build(native_loader.SOURCE, native_loader.FLAGS)
    assert os.path.dirname(path) == str(tmp_path / "b") and os.path.exists(path)
    assert path == native_build.lib_path(native_loader.SOURCE, native_loader.FLAGS)
    assert not [n for n in os.listdir(tmp_path / "b") if n.endswith(".tmp")]
    assert native_build.build(native_loader.SOURCE, native_loader.FLAGS) == path  # reused
    if codec_loader.available():
        cpath = native_build.build(codec_loader.SOURCE, codec_loader.FLAGS, codec_loader.LIBS)
        assert os.path.dirname(cpath) == str(tmp_path / "b")
    assert _native_tree() == before
    default = codec_loader.lib_path() if codec_loader.available() else native_loader.lib_path()
    monkeypatch.delenv("EZAUDIO_TORCH_BUILD_DIR")
    assert os.sep + os.path.join("build", "ezaudio_tpu_torch") + os.sep in \
        native_build.lib_path(native_loader.SOURCE, native_loader.FLAGS)
    assert default


def test_a_failed_build_reports_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setenv("EZAUDIO_TORCH_BUILD_DIR", str(tmp_path))
    if native_build.gxx() is None:
        pytest.skip("g++ missing")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build(native_loader.SOURCE, ("-O0", "-shared", "-fPIC", "-std=c++17"),
                           ("-lno_such_library_here",))
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the codec bridge
# ---------------------------------------------------------------------------

@needs_codec
@pytest.mark.parametrize("ext,channels,sr", [("flac", 2, 22050), ("mp3", 2, 44100),
                                             ("mp3", 1, 24000), ("ogg", 1, 16000)])
def test_encode_with_one_decode_with_the_other(tmp_path, ext, channels, sr):
    """The port and the JAX package write the same bytes (ogg: the same
    samples, as each stream gets a random serial number), and each decodes
    either file to the same samples, mono and multichannel."""
    x = _s16(1, sr, channels) if ext == "flac" else _noise(2, sr, channels)
    mine, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    codec_loader.encode(mine, x, sr)
    jcodec.encode(theirs, x, sr)
    if ext == "ogg":
        np.testing.assert_array_equal(codec_loader.decode(mine)[0], jcodec.decode(theirs)[0])
    else:
        assert _sha(mine) == _sha(theirs)
    assert codec_loader.probe(mine) == jcodec.probe(mine)
    for mono in (True, False):
        a, sa = codec_loader.decode(theirs, mono=mono)
        b, sb = jcodec.decode(mine, mono=mono)
        assert sa == sb == sr and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@needs_codec
def test_flac_is_lossless_on_the_16_bit_grid(tmp_path):
    x = _s16(3, 22050, 2)
    path = str(tmp_path / "t.flac")
    codec_loader.encode(path, x, 22050)
    y, sr = codec_loader.decode(path, mono=False)
    assert sr == 22050 and y.shape == x.shape
    np.testing.assert_array_equal(y, x)


@needs_codec
@pytest.mark.parametrize("ext,bitrate", [("mp3", 192000), ("ogg", 0)])
def test_lossy_round_trip_keeps_the_signal(tmp_path, ext, bitrate):
    """A tone through mp3 or vorbis: after the codec delay the decoded
    signal correlates with the input above 0.99 (as the JAX test holds)."""
    sr = 44100 if ext == "mp3" else 16000
    t = np.arange(2 * sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t) * np.minimum(t * 20, 1.0)).astype(np.float32)
    path = str(tmp_path / f"t.{ext}")
    codec_loader.encode(path, x, sr, bitrate=bitrate)
    y, sr2 = codec_loader.decode(path)
    assert sr2 == sr and abs(len(y) - len(x)) < sr // 4
    corr = np.correlate(y[: 3 * sr // 2], x[: sr // 2], mode="valid")
    lag = int(np.argmax(corr))
    m = min(len(y) - lag, len(x))
    a, b = y[lag: lag + m], x[:m]
    assert float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.99


@needs_codec
def test_decode_retries_when_the_buffer_is_too_small(tmp_path, monkeypatch):
    """A duration estimate far too small: the bridge answers -7 and the
    buffer doubles until the file fits, as JAX's decode does."""
    x = _noise(4, 3 * (1 << 20) // 2, 1)
    path = str(tmp_path / "long.flac")
    codec_loader.encode(path, x, 48000)
    real = codec_loader.probe
    monkeypatch.setattr(codec_loader, "probe", lambda p: real(p)[:2] + (0.0,))
    y, sr = codec_loader.decode(path)
    assert sr == 48000 and y.shape == (x.shape[0],)
    np.testing.assert_array_equal(y, jcodec.decode(path)[0])


@needs_codec
def test_errors_match_the_jax_bridge(tmp_path):
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"ID3\x03" + bytes(64))
    for mod in (codec_loader, jcodec):
        with pytest.raises(IOError, match="codec"):
            mod.decode(str(bad))
        with pytest.raises(IOError, match="codec"):
            mod.probe(str(tmp_path / "missing.flac"))
        with pytest.raises(IOError, match="codec encode failed"):
            mod.encode(str(tmp_path / "x.nosuchformat"), np.zeros(100, np.float32), 16000)


# ---------------------------------------------------------------------------
# the product surfaces
# ---------------------------------------------------------------------------

@needs_codec
@pytest.mark.parametrize("ext", ["mp3", "flac"])
def test_load_audio_and_save_audio_match_jax(tmp_path, ext):
    """``save_audio`` writes JAX's bytes (mono (T,), stereo (C, T) and
    ``bitrate``); ``load_audio``/``load_wav`` give JAX's ``load_wav``
    samples and rates: mono (T,), multichannel (C, T), resampled."""
    from ezaudio_tpu.data.audio_io import load_wav as jload
    from ezaudio_tpu.data.audio_io import save_audio as jsave

    x = _noise(5, 24000, 2)
    mine, theirs = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
    audio_io.save_audio(mine, x.T, 24000, bitrate=128000)
    jsave(theirs, x.T, 24000, bitrate=128000)
    assert _sha(mine) == _sha(theirs)
    for sr, mono in [(None, True), (None, False), (16000, True), (44100, False)]:
        got, got_sr = audio_io.load_audio(mine, sr=sr, mono=mono)
        want, want_sr = jload(mine, sr=sr, mono=mono)
        assert got_sr == want_sr and got.shape == want.shape
        assert got.shape == ((want.shape[-1],) if mono else (2, want.shape[-1]))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(audio_io.load_wav(mine, sr=sr, mono=mono), want)


@needs_codec
@pytest.mark.parametrize("ext", ["mp3", "flac"])
def test_audiosignal_load_and_write(tmp_path, ext):
    from ezaudio_tpu.audio.signal import AudioSignal as JSig
    from ezaudio_tpu_torch.audio.signal import AudioSignal

    sr = 22050
    x = (0.4 * np.sin(2 * np.pi * 330 * np.arange(sr) / sr)).astype(np.float32)
    mine, theirs = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
    AudioSignal(x, sr, device="cpu").write(mine)
    JSig(x, sr).write(theirs)
    assert _sha(mine) == _sha(theirs)
    got = AudioSignal.load(mine, device="cpu")
    want = JSig.load(mine)
    assert got.sample_rate == want.sample_rate == sr
    np.testing.assert_array_equal(got.audio_data, want.audio_data)
    assert abs(got.signal_duration - 1.0) < 0.1 and np.abs(got.audio_data).max() > 0.2
    part = AudioSignal.load(mine, offset=0.25, duration=0.5, device="cpu")
    np.testing.assert_array_equal(part.audio_data, JSig.load(mine, offset=0.25,
                                                             duration=0.5).audio_data)


@needs_codec
def test_ffmpeg_load_routes_non_wav_to_the_bridge(tmp_path, monkeypatch):
    """Bridge first for a non-wav file (even where an ffmpeg binary is
    on the path), the wav reader for a wav, JAX's samples either way."""
    from ezaudio_tpu.audio import external as jext
    from ezaudio_tpu_torch.audio import external

    x = _noise(6, 16000, 1)
    path = str(tmp_path / "a.mp3")
    codec_loader.encode(path, x, 16000)
    monkeypatch.setattr(external, "ffmpeg_available", lambda: True)  # must not be reached
    monkeypatch.setattr(external.subprocess, "run", lambda *a, **k: pytest.fail("forked"))
    got, sr = external.ffmpeg_load(path, sr=8000)
    want, want_sr = jext.ffmpeg_load(path, sr=8000)
    assert sr == want_sr == 8000
    np.testing.assert_array_equal(got, want)


@needs_codec
def test_without_the_bridge_non_wav_raises_import_error(tmp_path, monkeypatch):
    from ezaudio_tpu_torch.audio import external
    from ezaudio_tpu_torch.audio.signal import AudioSignal

    path = str(tmp_path / "a.flac")
    codec_loader.encode(path, _noise(7, 800, 1), 8000)
    monkeypatch.setattr(codec_loader, "available", lambda: False)
    monkeypatch.setattr(external, "ffmpeg_available", lambda: False)
    for call in (lambda: audio_io.load_audio(path), lambda: audio_io.load_wav(path),
                 lambda: AudioSignal.load(path, device="cpu"),
                 lambda: external.ffmpeg_load(path),
                 lambda: audio_io.save_audio(str(tmp_path / "b.ogg"), np.zeros(10), 8000)):
        with pytest.raises(ImportError, match="bridge"):
            call()


# ---------------------------------------------------------------------------
# the native wav batch loader
# ---------------------------------------------------------------------------

@pytest.fixture
def wavs(tmp_path):
    sr = 8000
    paths = []
    for i in range(6):
        p = str(tmp_path / f"{i}.wav")
        audio_io.save_wav(p, _noise(10 + i, 2 * sr + 100 * i, 1)[:, 0], sr,
                          subtype="pcm16" if i % 2 else "float")
        paths.append(p)
    return paths, sr


@needs_native
def test_decode_wav_matches_jax(wavs, tmp_path):
    from scipy.io import wavfile

    paths, sr = wavs
    st = str(tmp_path / "st.wav")
    wavfile.write(st, sr, _noise(20, sr, 2))
    for p in paths + [st]:
        got, got_sr = native_loader.decode_wav(p)
        want, want_sr = jnative.decode_wav(p)
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(got, want)


@needs_native
@pytest.mark.parametrize("seed,normalize,threads", [(3, True, 8), (11, False, 1), (0, True, 16)])
def test_load_batch_matches_jax(wavs, seed, normalize, threads):
    paths, sr = wavs
    got, gs = native_loader.load_batch(paths, sr, sr, normalize=normalize, seed=seed,
                                       n_threads=threads)
    want, ws = jnative.load_batch(paths, sr, sr, normalize=normalize, seed=seed,
                                  n_threads=threads)
    assert (gs == 0).all() and (ws == 0).all() and got.shape == (6, sr)
    np.testing.assert_array_equal(got, want)
    if normalize:
        np.testing.assert_allclose(np.abs(got).max(axis=1), 1.0, atol=1e-3)


@needs_native
def test_load_batch_pads_short_files_and_reports_a_rate_mismatch(tmp_path, wavs):
    paths, sr = wavs
    short = str(tmp_path / "short.wav")
    x = _noise(30, sr // 2, 1)[:, 0]
    audio_io.save_wav(short, x, sr)
    got, gs = native_loader.load_batch([short, paths[0]], sr, 16000, normalize=False)
    want, ws = jnative.load_batch([short, paths[0]], sr, 16000, normalize=False)
    np.testing.assert_array_equal(gs, ws)
    assert list(gs) == [-4, -4]
    got, gs = native_loader.load_batch([short], sr, sr, normalize=False)
    np.testing.assert_allclose(got[0, : sr // 2], x, atol=1e-6)
    assert gs[0] == 0 and (got[0, sr // 2:] == 0).all()


def _bad_header(path, fmt, channels, bits, data=b"\x00" * 64):
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, 8000,
                            8000 * max(channels, 1) * max(bits // 8, 1),
                            max(channels, 1) * max(bits // 8, 1), bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk + b"data"
            + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@needs_native
@pytest.mark.parametrize("case", ["zero_channels", "alaw", "not_riff", "missing"])
def test_malformed_files_give_jax_error_statuses(tmp_path, case):
    """The error cases of the JAX package's native loader tests: the same
    negative status from ``ez_decode_wav`` and ``load_batch``, and an
    ``IOError`` from ``decode_wav``, never a crash or silence."""
    p = str(tmp_path / f"{case}.wav")
    if case == "zero_channels":
        _bad_header(p, fmt=1, channels=0, bits=16)
    elif case == "alaw":
        _bad_header(p, fmt=6, channels=1, bits=8)
    elif case == "not_riff":
        with open(p, "wb") as f:
            f.write(b"ID3\x03" + bytes(64))
    codes = []
    for lib in (native_loader.get_lib(), jnative.get_lib()):
        out = np.zeros(100, np.float32)
        sr = ctypes.c_int32(0)
        codes.append(lib.ez_decode_wav(p.encode(),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                       100, ctypes.byref(sr)))
    assert codes[0] == codes[1] < 0
    with pytest.raises(IOError, match="native decode failed"):
        native_loader.decode_wav(p)
    (_, gs), (_, ws) = (native_loader.load_batch([p], 800, 8000),
                        jnative.load_batch([p], 800, 8000))
    assert gs[0] == ws[0] < 0


# ---------------------------------------------------------------------------
# EACaps(use_native=True)
# ---------------------------------------------------------------------------

def _manifest(root, names):
    with open(root / "meta.csv", "w") as f:
        f.write("audio_path,caption,split,audio_length,absolute_index,fine_tune_data\n")
        for i, n in enumerate(names):
            f.write(f"{n},clip {i},train,2.0,{i},True\n")
    return dict(data_dir=str(root) + "/", meta_dir=str(root / "meta.csv"), seg_length=1,
                sr=8000, seed=4)


@needs_native
@pytest.mark.parametrize("with_mp3", [False, True])
def test_eacaps_native_batches_equal_jax(tmp_path, with_mp3):
    """One ``load_batch`` call a batch, seeded from the dataset's
    generator: the port's batches equal the JAX dataset's over two epochs;
    an mp3 row (native status -3) falls back to the bridge per item."""
    from ezaudio_tpu.data.dataset import EACaps as JEACaps
    from ezaudio_tpu_torch.data.dataset import EACaps, ResumableIterator

    if with_mp3 and not codec_loader.available():
        pytest.skip("libav missing")
    names = []
    for i in range(8):
        name = f"{i}.mp3" if with_mp3 and i % 3 == 1 else f"{i}.wav"
        x = _noise(40 + i, 8000 + 400 * i, 1)
        if name.endswith(".mp3"):
            codec_loader.encode(str(tmp_path / name), x, 8000)
        else:
            audio_io.save_wav(str(tmp_path / name), x[:, 0], 8000)
        names.append(name)
    kw = _manifest(tmp_path, names)
    mine, theirs = EACaps(use_native=True, **kw), JEACaps(use_native=True, **kw)
    assert mine.use_native and theirs.use_native
    got, want = iter(ResumableIterator(mine, 4, seed=9)), None
    from ezaudio_tpu.data.dataset import ResumableIterator as JIter

    want = iter(JIter(theirs, 4, seed=9))
    for _ in range(4):
        g, w = next(got), next(want)
        assert g["text"] == list(w["text"])
        assert g["audio"].shape == (4, 8000)
        np.testing.assert_array_equal(g["audio"], w["audio"])
    plain = EACaps(use_native=False, **kw)
    assert not plain.use_native
