"""The port's effects, transforms and ``spectral_gate`` against the JAX
package's.

Every transform draws its parameters from the same generator in the same
order as JAX's: the outputs and the generator's state after must agree.
Tolerances: the numpy effects and transforms must be exact; the spectral
ones (STFT, edit and inverse STFT on the device) within 1e-5 of the output's
largest magnitude.  ``MaskLowMagnitudes`` and ``spectral_gate`` threshold
bins by their dB level, so a bin within rounding of the threshold may fall
on the other side: they are held within 1e-5 of scale everywhere but at
most 1e-3 of the samples, and within 1e-3 of scale everywhere.
"""

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.audio import effects
from ezaudio_tpu_torch.audio.signal import AudioSignal
from ezaudio_tpu_torch.data import transforms as T
from ezaudio_tpu_torch.data.audio_io import save_wav

SR = 8000
SCALE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(seconds=1.0, seed=0, channels=1, batch=2):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    x = 0.4 * np.sin(2 * np.pi * 330 * t) * (np.sin(2 * np.pi * 2 * t) > -0.3)
    return (x + 0.05 * rng.standard_normal((batch, channels, t.size))).astype(np.float32)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("src")
    noise = str(d / "noise.wav")
    save_wav(noise, 0.2 * np.random.default_rng(3).standard_normal(2 * SR).astype(np.float32), SR)
    ir = np.zeros(400, np.float32)
    ir[5], ir[60], ir[200] = 1.0, 0.4, 0.1
    ir_path = str(d / "ir.wav")
    save_wav(ir_path, ir, SR)
    return noise, ir_path


def close(got, want, tol=SCALE_TOL, flips=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want)
    if flips:
        assert err.max() <= 1e-3 * scale, err.max() / scale
        assert (err > tol * scale).mean() <= flips, (err > tol * scale).mean()
    else:
        assert err.max() <= tol * scale, err.max() / scale


# ---------------------------------------------------------------------------
# effects: the same numpy code, exact
# ---------------------------------------------------------------------------

EFFECTS = {
    "mix": lambda e, x: e.mix(x, x[..., ::-1].copy() * 0.3, SR, snr=6.0),
    "apply_ir": lambda e, x: e.apply_ir(x, np.array([0.1, 1.0, 0.5, 0.2], np.float32)),
    "volume_change": lambda e, x: e.volume_change(x, -6.0),
    "clip_distortion": lambda e, x: e.clip_distortion(x, 0.9),
    "quantization": lambda e, x: e.quantization(x, 16),
    "mulaw_quantization": lambda e, x: e.mulaw_quantization(x, 64),
    "mnru": lambda e, x: e.mnru(x, 20.0, seed=4),
    "band_limit": lambda e, x: e.band_limit(x, SR, 1500.0, kind="high"),
    "preemphasis": lambda e, x: e.preemphasis(x, 0.9),
    "equalizer": lambda e, x: e.equalizer(x, SR, np.array([-3, 2, -6, 0, 1], np.float32)),
    "windows": lambda e, x: e.overlap_and_add(e.collect_windows(x, 0.05, 0.025, SR),
                                              0.025, SR, length=x.shape[-1]),
    "time_stretch": lambda e, x: e.time_stretch(x, 1.25, n_fft=256),
    "pitch_shift": lambda e, x: e.pitch_shift(x, SR, 2.0, n_fft=256),
    "apply_codec": lambda e, x: e.apply_codec(x, SR, "Amr-nb"),
    "lowpass": lambda e, x: e.lowpass_biquad(x, SR, 1000.0),
    "highpass": lambda e, x: e.highpass_biquad(x, SR, 300.0),
}


@pytest.mark.parametrize("name", sorted(EFFECTS))
def test_effect_equals_jax(name):
    from ezaudio_tpu.audio import effects as jeffects

    x = _clip()
    np.testing.assert_array_equal(EFFECTS[name](effects, x), EFFECTS[name](jeffects, x))


# ---------------------------------------------------------------------------
# transforms: the same draws, the same outputs
# ---------------------------------------------------------------------------

def _transforms(m, noise, ir):
    """name -> transform of module ``m`` (either package's)."""
    return {
        "Identity": m.Identity(),
        "VolumeChange": m.VolumeChange(prob=0.7),
        "VolumeNorm": m.VolumeNorm(db=(-30.0, -20.0)),
        "BackgroundNoise": m.BackgroundNoise(sources=[noise]),
        "BackgroundNoise_white": m.BackgroundNoise(),
        "RoomImpulseResponse": m.RoomImpulseResponse(sources=[ir]),
        "LowPass": m.LowPass(cutoff=(1000.0, 3000.0)),
        "HighPass": m.HighPass(),
        "ClippingDistortion": m.ClippingDistortion(perc=(0.05, 0.2)),
        "MuLawQuantize": m.MuLawQuantize(channels=64),
        "Quantize": m.Quantize(),
        "FrequencyMask": m.FrequencyMask(),
        "TimeMask": m.TimeMask(),
        "InvertPhase": m.InvertPhase(),
        "ShiftPhase": m.ShiftPhase(),
        "CorruptPhase": m.CorruptPhase(),
        "Smoothing": m.Smoothing(),
        "Silence": m.Silence(prob=0.5),
        "Equalizer": m.Equalizer(),
        "NoiseFloor": m.NoiseFloor(),
        "CrossTalk": m.CrossTalk(sources=[noise]),
        "CrossTalk_synthetic": m.CrossTalk(),
        "GlobalVolumeNorm": m.GlobalVolumeNorm(),
        "RescaleAudio": m.RescaleAudio(val=0.2),
        "MaskLowMagnitudes": m.MaskLowMagnitudes(),
        "TimeNoise": m.TimeNoise(),
        "FrequencyNoise": m.FrequencyNoise(),
        "SpectralDenoising": m.SpectralDenoising(),
        "Compose": m.Compose([m.VolumeChange(), m.LowPass(cutoff=(1000.0, 3000.0)),
                              m.TimeMask(), m.Quantize()]),
        "Choose": m.Choose([m.VolumeChange(), m.ShiftPhase(), m.HighPass()],
                           weights=[1, 2, 3]),
        "Repeat": m.Repeat(m.CorruptPhase(prob=0.8), n=3),
        "RepeatUpTo": m.RepeatUpTo(m.VolumeChange(db=(-3.0, 0.0)), max_repeat=4),
    }


THRESHOLDED = ("MaskLowMagnitudes", "SpectralDenoising")
SPECTRAL = ("FrequencyMask", "TimeMask", "ShiftPhase", "CorruptPhase", "TimeNoise",
            "FrequencyNoise", "Compose", "Choose", "Repeat") + THRESHOLDED


@pytest.mark.parametrize("name", sorted(_transforms(T, "n", "i")))
def test_transform_equals_jax(sources, name):
    from ezaudio_tpu.audio.signal import AudioSignal as JSig
    from ezaudio_tpu.data import transforms as JT

    noise, ir = sources
    # CrossTalk takes one item at a time in both packages (ROADMAP F16)
    x = _clip(batch=1 if name.startswith("CrossTalk") else 2)
    meta = {"loudness": -21.5}
    for seed in (0, 1, 2):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = _transforms(JT, noise, ir)[name](JSig(x, SR, metadata=meta), rj)
        got = _transforms(T, noise, ir)[name](AudioSignal(x, SR, metadata=meta, device="cpu"),
                                             rt)
        assert rt.bit_generator.state == rj.bit_generator.state
        assert got.sample_rate == want.sample_rate
        if name in SPECTRAL:
            close(got.audio_data, want.audio_data, flips=1e-3 if name in THRESHOLDED else 0.0)
        else:
            np.testing.assert_array_equal(got.audio_data, want.audio_data)


def test_every_transform_class_is_covered():
    import inspect

    names = {n for n, c in inspect.getmembers(T, inspect.isclass)
             if issubclass(c, T.BaseTransform) and c.__module__ == T.__name__}
    assert names - {"BaseTransform", "_SpectralTransform"} <= set(_transforms(T, "n", "i"))
    assert len(names) == 32


def test_crosstalk_refuses_a_batch_as_jax_does(sources):
    """ROADMAP F16: ``CrossTalk`` tests its per-item loudness array for
    truth at batch > 1 and raises in the JAX package; the port copies it."""
    from ezaudio_tpu.audio.signal import AudioSignal as JSig
    from ezaudio_tpu.data import transforms as JT

    x = _clip(batch=2)
    for m, sig in ((JT, JSig(x, SR)), (T, AudioSignal(x, SR, device="cpu"))):
        with pytest.raises(ValueError, match="ambiguous"):
            m.CrossTalk()(sig, np.random.default_rng(0))


def test_combinators_consume_the_same_draws(sources):
    """``instantiate`` alone: the nested states equal JAX's, and the
    generator ends where JAX's does."""
    from ezaudio_tpu.data import transforms as JT

    noise, ir = sources
    for name in ("Compose", "Choose", "Repeat", "RepeatUpTo"):
        rj, rt = np.random.default_rng(11), np.random.default_rng(11)
        want = _transforms(JT, noise, ir)[name].instantiate(rj)
        got = _transforms(T, noise, ir)[name].instantiate(rt)
        assert got == want and rt.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize("noise_rows", [1, 2])
def test_spectral_gate_matches_jax(noise_rows):
    from ezaudio_tpu.data.transforms import spectral_gate as jgate

    x = _clip(channels=2)
    nz = 0.05 * np.random.default_rng(5).standard_normal((1, noise_rows, SR)).astype(np.float32)
    kw = dict(denoise_amount=0.9, n_fft=512, hop=128)
    want = jgate(x, SR, nz, **kw)
    got = T.spectral_gate(x, SR, nz, device="cpu", **kw)
    close(got, want, flips=1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.spectral_gate(x, SR, nz, **kw)
