"""The port's ``istft``, wav IO and ``AudioSignal`` against the JAX package's.

Tolerances: numpy paths (IO, excerpts and their draws, resampling, padding,
loudness, normalization, arithmetic) must be exact; spectral ones (``istft``,
``stft``, ``magnitude``, ``mel_spectrogram``, ``mfcc``; ``phase`` where the
magnitude is above 1e-3 of its largest) within 1e-5 of the output's
largest magnitude: torch's and XLA's f32 FFTs sum in other orders.
"""

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.audio.signal import AudioSignal
from ezaudio_tpu_torch.audio.stft import istft, stft
from ezaudio_tpu_torch.data.audio_io import load_audio, save_audio, save_wav

SCALE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=SCALE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


def _clip(sr=16000, seconds=1.0, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    env = (np.sin(2 * np.pi * 1.5 * t) > 0).astype(np.float32)
    tones = [0.3 * np.sin(2 * np.pi * f * t) * env for f in (440.0, 660.0)[:channels]]
    return (np.stack(tones) + 0.05 * rng.standard_normal((channels, t.size))).astype(np.float32)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sig") / "clip.wav")
    save_wav(p, _clip(), 16000)
    return p


@pytest.mark.parametrize("n_fft,hop,length", [(2048, 512, None), (400, 160, 4321),
                                              (256, 100, 3001), (64, 64, 1000)])
def test_istft_matches_jax(n_fft, hop, length):
    """Hann overlap-add with the 1e-11 floor (a hop equal to n_fft leaves
    zero-window samples), centre samples dropped, trimmed to ``length``;
    a length that is not a multiple of the hop included.  Held where the
    squared windows sum to at least 1e-3: beyond the signal's end (no
    ``length``) the last window's tail divides the FFT's rounding by
    (pi / n_fft)^2 on both sides (JAX's own output there is that noise), and
    that tail is exactly what ``length`` trims."""
    import jax.numpy as jnp

    from ezaudio_tpu.audio.stft import hann_window
    from ezaudio_tpu.audio.stft import istft as jistft, stft as jstft

    x = np.random.default_rng(1).standard_normal((2, 4321)).astype(np.float32)
    spec = np.array(jstft(jnp.asarray(x), n_fft, hop))
    want = np.asarray(jistft(jnp.asarray(spec), n_fft, hop, length=length))
    got = istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    norm = np.zeros(n_fft + (spec.shape[-1] - 1) * hop)
    for i in range(spec.shape[-1]):
        norm[i * hop: i * hop + n_fft] += hann_window(n_fft) ** 2
    keep = norm[n_fft // 2:][: want.shape[-1]] >= 1e-3
    assert got.shape == want.shape and keep.mean() > 0.85
    close(got[:, keep], want[:, keep])
    zero = norm[n_fft // 2:][: want.shape[-1]] == 0  # the 1e-11 floor: 0 on both sides
    np.testing.assert_array_equal(got[:, zero], want[:, zero])
    # and it inverts the port's own stft where the windows overlap
    if hop < n_fft:
        back = istft(stft(torch.from_numpy(x), n_fft, hop), n_fft, hop, length=x.shape[-1])
        np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_load_audio_and_save_audio_contract(wav_path, tmp_path, monkeypatch):
    """Wav against the JAX reader; a non-wav file goes through the codec
    bridge (a garbage mp3 fails in libav, as in JAX) and, with the bridge
    unavailable, raises ``ImportError`` both ways."""
    from ezaudio_tpu.data.audio_io import load_wav as jload
    from ezaudio_tpu_torch.data import codec_loader

    for sr, mono in [(None, True), (None, False), (8000, True), (22050, False)]:
        got, got_sr = load_audio(wav_path, sr=sr, mono=mono)
        want, want_sr = jload(wav_path, sr=sr, mono=mono)
        assert got_sr == want_sr and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    mp3 = tmp_path / "y.mp3"
    mp3.write_bytes(b"ID3\x03" + bytes(64))
    if codec_loader.available():
        with pytest.raises(OSError):
            load_audio(str(mp3))
        with pytest.raises(OSError):
            jload(str(mp3))
    monkeypatch.setattr(codec_loader, "available", lambda: False)
    with pytest.raises(ImportError, match="bridge"):
        save_audio(str(tmp_path / "x.mp3"), np.zeros(100, np.float32), 16000)
    with pytest.raises(ImportError, match="bridge"):
        load_audio(str(mp3))
    out = str(tmp_path / "z.wav")
    save_audio(out, _clip(channels=1)[0], 16000, subtype="pcm16")
    assert load_audio(out)[1] == 16000


def test_write_load_round_trip(wav_path, tmp_path, monkeypatch):
    """wav bit for bit; flac through the codec bridge to 16-bit precision;
    without the bridge a non-wav write raises ``ImportError``."""
    from ezaudio_tpu_torch.data import codec_loader

    sig = AudioSignal.load(wav_path)
    out = str(tmp_path / "rt.wav")
    sig.write(out)
    back = AudioSignal.load(out)
    assert back == sig and back.sample_rate == 16000
    if codec_loader.available():
        flac = str(tmp_path / "rt.flac")
        sig.write(flac)
        back = AudioSignal.load(flac)
        assert back.audio_data.shape == sig.audio_data.shape and back.sample_rate == 16000
        np.testing.assert_allclose(back.audio_data, sig.audio_data, atol=1.0 / 32768 + 1e-6)
    monkeypatch.setattr(codec_loader, "available", lambda: False)
    with pytest.raises(ImportError):
        sig.write(str(tmp_path / "rt.mp3"))


def _pair(path, **kw):
    from ezaudio_tpu.audio.signal import AudioSignal as JSig

    return JSig.load(path, **kw), AudioSignal.load(path, device="cpu", **kw)


def _same(j, t):
    assert t.sample_rate == j.sample_rate
    assert t.audio_data.dtype == j.audio_data.dtype
    np.testing.assert_array_equal(t.audio_data, j.audio_data)


@pytest.mark.parametrize("name", ["load", "load_window", "excerpt", "excerpt_offset",
                                  "salient_excerpt", "resample", "zero_pad", "zero_pad_to",
                                  "to_mono", "truncate", "peak_normalize", "normalize",
                                  "ensure_max", "arithmetic", "getitem_batch", "apply_codec"])
def test_numpy_methods_equal_jax(wav_path, name):
    """Every numpy method gives JAX's samples exactly, and the excerpts draw
    the same windows from the same generator (its state equal after)."""
    from ezaudio_tpu.audio.signal import AudioSignal as JSig

    j, t = _pair(wav_path)
    if name == "load_window":
        j, t = _pair(wav_path, offset=0.1, duration=0.5, sr=8000)
    elif name in ("excerpt", "excerpt_offset", "salient_excerpt"):
        rj, rt = np.random.default_rng(7), np.random.default_rng(7)
        kw = dict(offset=123) if name == "excerpt_offset" else {}
        if name == "salient_excerpt":
            j = JSig.salient_excerpt(wav_path, 0.25, loudness_cutoff=-20.0, state=rj, sr=8000)
            t = AudioSignal.salient_excerpt(wav_path, 0.25, loudness_cutoff=-20.0, state=rt,
                                            sr=8000)
        else:
            j = JSig.excerpt(wav_path, 0.3, state=rj, sr=22050, **kw)
            t = AudioSignal.excerpt(wav_path, 0.3, state=rt, sr=22050, **kw)
        assert t.metadata == j.metadata
        assert rt.bit_generator.state == rj.bit_generator.state
    elif name == "resample":
        j.resample(44100), t.resample(44100)
    elif name == "zero_pad":
        j.zero_pad(10, 20), t.zero_pad(10, 20)
    elif name == "zero_pad_to":
        j.zero_pad_to(20000), t.zero_pad_to(20000)
    elif name == "to_mono":
        j.to_mono(), t.to_mono()
    elif name == "truncate":
        j.truncate_samples(999), t.truncate_samples(999)
    elif name == "peak_normalize":
        j.peak_normalize(), t.peak_normalize()
    elif name == "normalize":
        assert t.loudness() == j.loudness()
        j.normalize(-18.0), t.normalize(-18.0)
        two_j, two_t = JSig.batch([j, j * 0.5]), AudioSignal.batch([t, t * 0.5])
        np.testing.assert_array_equal(two_t.loudness(), two_j.loudness())
    elif name == "ensure_max":
        j, t = j * 3.0, t * 3.0
        j.ensure_max_of_audio(0.5), t.ensure_max_of_audio(0.5)
    elif name == "arithmetic":
        j = ((j + j) * 0.5 - j / 2.0 + (-j)) * 2
        t = ((t + t) * 0.5 - t / 2.0 + (-t)) * 2
        j += 1.0
        t += 1.0
        j *= 0.25
        t *= 0.25
    elif name == "getitem_batch":
        j = JSig.batch([j, j.clone().truncate_samples(500)])[1]
        t = AudioSignal.batch([t, t.clone().truncate_samples(500)])[1]
        assert len(t) == 1 and t.device == "cpu"
    elif name == "apply_codec":
        j.apply_codec("GSM-FR"), t.apply_codec("GSM-FR")
    _same(j, t)
    assert repr(t) == repr(j)


@pytest.mark.parametrize("method", ["stft", "magnitude", "phase", "mel_spectrogram", "mfcc"])
def test_spectral_methods_match_jax(wav_path, method):
    j, t = _pair(wav_path)
    kw = dict(n_fft=512, hop_length=128)
    if method in ("mel_spectrogram", "mfcc"):
        kw["n_mels"] = 40
    want = getattr(j, method)(**kw)
    got = getattr(t, method)(**kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if method == "phase":
        mag = j.magnitude(**kw)
        keep = mag > 1e-3 * mag.max()
        d = np.angle(np.exp(1j * (got - want)))[keep]
        assert np.abs(d).max() <= 1e-3, np.abs(d).max()
        return
    close(got, want)


def test_spectral_methods_need_a_device(wav_path):
    """No device named and no GPU: the spectral methods raise rather than
    run on the CPU; the numpy ones do not touch a device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    sig = AudioSignal.load(wav_path)
    assert sig.loudness() < 0
    with pytest.raises(RuntimeError, match="CUDA"):
        sig.stft()
    assert sig.to("cpu").stft(256).shape[-2] == 129
