"""The port's audio metrics and loudness
(``ezaudio_tpu_torch/audio/{metrics,loudness}.py``) on the CPU against the
JAX package's on the same waveforms.  Limits: rtol 1e-5 for the device
losses (f32 FFTs and sums in another order), their gradients within 1e-4
of the largest entry; the host statistics (numpy / scipy on both sides)
equal to 1e-9; loudness equal to 1e-6 dB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.audio import loudness as jl
from ezaudio_tpu.audio import metrics as jm
from ezaudio_tpu_torch.audio import loudness as tl
from ezaudio_tpu_torch.audio import metrics as tm


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(0)
    t = np.arange(4096) / 8000
    ref = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal((2, 4096)))
    est = ref + 0.1 * rng.standard_normal(ref.shape)
    return est.astype(np.float32), ref.astype(np.float32)


def _both(fn_t, fn_j, est, ref, **kw):
    return fn_t(torch.from_numpy(est), torch.from_numpy(ref), **kw), \
        np.asarray(fn_j(jnp.asarray(est), jnp.asarray(ref), **kw))


@pytest.mark.parametrize("name,kw", [
    ("l1_loss", {}),
    ("si_sdr", {}),
    ("si_sdr", dict(reduce=False, scaling=False, zero_mean=False)),
    ("multiscale_stft_loss", {}),
    ("multiscale_stft_loss", dict(window_lengths=(256, 128, 32), pow=1.0, mag_weight=0.5)),
    ("mel_spectrogram_loss", dict(sr=8000, n_mels=(40, 20), window_lengths=(256, 128))),
    ("mel_spectrogram_loss", dict(sr=8000, n_mels=(40, 20, 10),
                                  window_lengths=(256, 128, 64), fmin=(50.0,))),
    ("stft_phase_loss", dict(window_lengths=(256, 64))),
])
def test_device_losses_match_jax(wavs, name, kw):
    got, want = _both(getattr(tm, name), getattr(jm, name), *wavs, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_mel_loss_refuses_misaligned_scales(wavs):
    with pytest.raises(ValueError, match="must align"):
        tm.mel_spectrogram_loss(*map(torch.from_numpy, wavs), n_mels=(40, 20),
                                window_lengths=(256,))


def test_stft_loss_gradient_matches_jax(wavs):
    """The codec trainer's reconstruction term, differentiated."""
    est, ref = wavs
    windows = (256, 64, 32)
    want = np.asarray(jax.grad(lambda e: jm.multiscale_stft_loss(
        e, jnp.asarray(ref), window_lengths=windows))(jnp.asarray(est)))
    e = torch.from_numpy(est).requires_grad_()
    tm.multiscale_stft_loss(e, torch.from_numpy(ref), windows).backward()
    np.testing.assert_allclose(e.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_mel_statistics_embedding_matches_jax(wavs):
    got = tm.mel_statistics_embedding(torch.from_numpy(wavs[0]), 8000, n_mels=32, n_fft=256)
    want = np.asarray(jm.mel_statistics_embedding(wavs[0], 8000, n_mels=32, n_fft=256))
    assert got.shape == (2, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_host_statistics_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((20, 6)), rng.standard_normal((20, 6)) + 0.3
    assert tm.frechet_audio_distance(a, b) == pytest.approx(jm.frechet_audio_distance(a, b),
                                                            abs=1e-9)
    few = rng.standard_normal((3, 6))  # rank-deficient: the eps * I retry
    assert tm.frechet_audio_distance(few, b) == pytest.approx(
        jm.frechet_audio_distance(few, b), abs=1e-9)
    assert tm.frechet_audio_distance(torch.from_numpy(a), b) == pytest.approx(
        jm.frechet_audio_distance(a, b), abs=1e-9)
    la, lb = rng.standard_normal((8, 5)), rng.standard_normal((8, 5))
    for kind in ("softmax", "sigmoid"):
        assert tm.paired_kl_divergence(la, lb, kind) == pytest.approx(
            jm.paired_kl_divergence(la, lb, kind), abs=1e-12)
    with pytest.raises(ValueError, match="softmax|sigmoid"):
        tm.paired_kl_divergence(la, lb, "tanh")
    with pytest.raises(ValueError, match="matching shapes"):
        tm.paired_kl_divergence(la, lb[:4])
    p = rng.uniform(size=(30, 5))
    for splits in (1, 3, 10):
        assert tm.inception_score(p, splits) == pytest.approx(jm.inception_score(p, splits),
                                                              abs=1e-12)


@pytest.mark.parametrize("sr,seconds", [(8000, 2.0), (44100, 1.0), (24000, 0.2)])
def test_integrated_loudness_equals_jax(sr, seconds):
    rng = np.random.default_rng(2)
    t = np.arange(int(sr * seconds)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
           + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
    got, want = tl.integrated_loudness(wav, sr), jl.integrated_loudness(wav, sr)
    assert np.isfinite(got) and abs(got - want) <= 1e-6
    stereo = np.stack([wav, 0.5 * wav], axis=1)
    assert abs(tl.integrated_loudness(stereo, sr) - jl.integrated_loudness(stereo, sr)) <= 1e-6
    assert tl.integrated_loudness(np.zeros(sr, np.float32), sr) == -np.inf
