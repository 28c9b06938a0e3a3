"""The trainer's tools on the CPU against the JAX package: ``wav_aug``
(mu-law, the RBJ biquads, ``WavAugmentation``), ``tango_mix``, ``EACaps``
with ``aug_config`` through ``ResumableIterator`` (and a resumed run), the
``Tracker`` / ``timer`` / ``Experiment`` / ``profile_trace`` and the model
bundles (a JAX-written bundle loaded by the port, the port's own round
trip).

Limits: the host code is the same numpy and scipy on the same generator,
so wav_aug, tango_mix and the augmented batches are equal bit for bit; a
bundle the JAX package wrote computes the JAX model's output within 1e-5
(one f32 forward), the port's own bundle reloads bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.data import tango_mix as jmix
from ezaudio_tpu.data import wav_aug as jaug
from ezaudio_tpu.data.dataset import EACaps as JaxEACaps
from ezaudio_tpu.data.dataset import ResumableIterator as JaxResumable
from ezaudio_tpu.training import model_io as jio
from ezaudio_tpu.training import tracker as jtracker
from ezaudio_tpu_torch.data import tango_mix, wav_aug
from ezaudio_tpu_torch.data.dataset import EACaps, ResumableIterator
from ezaudio_tpu_torch.training import model_io, tracker
from tests.test_torch_train_cli import _data_kw, _same, workspace  # noqa: F401 (fixture)
from tests.test_torch_training import MODEL, _jax_params

AUG = {"phase180": {"p": 0.5}, "amplitude": {"p": 0.7, "low": 0.3, "high": 1.5},
       "mu_law": {"p": 0.5, "n_channels": 64},
       "low_pass": {"p": 0.5, "fc_threshold": [0.2, 0.9]},
       "high_pass": {"p": 0.5, "fc_threshold": [0.01, 0.1], "fs": 16000}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestWavAug:
    def test_mu_law_and_biquads_equal_jax(self, rng):
        x = rng.uniform(-1.2, 1.2, 2000).astype(np.float32)
        for n in (64, 256):
            enc = wav_aug.mu_law_encode(x, n)
            np.testing.assert_array_equal(enc, jaug.mu_law_encode(x, n))
            np.testing.assert_array_equal(wav_aug.mu_law_decode(enc, n),
                                          jaug.mu_law_decode(enc, n))
        for fc in (300.0, 3000.0):
            np.testing.assert_array_equal(wav_aug.lowpass_biquad(x, 24000, fc),
                                          jaug.lowpass_biquad(x, 24000, fc))
            np.testing.assert_array_equal(wav_aug.highpass_biquad(x, 24000, fc),
                                          jaug.highpass_biquad(x, 24000, fc))

    def test_pipeline_equal_jax_on_one_generator(self, rng):
        x = (0.5 * rng.standard_normal(4000)).astype(np.float32)
        port = wav_aug.WavAugmentation(AUG, sr=24000, rng=np.random.default_rng(7))
        ref = jaug.WavAugmentation(AUG, sr=24000, rng=np.random.default_rng(7))
        outs = [port(x) for _ in range(12)]
        for got in outs:
            np.testing.assert_array_equal(got, ref(x))
        assert len({float(np.abs(o).max()) for o in outs}) > 6  # the draws vary


class TestTangoMix:
    def test_equal_jax(self, rng):
        np.testing.assert_array_equal(tango_mix.a_weight(24000, 1920), jmix.a_weight(24000, 1920))
        a, b = (rng.standard_normal(9600).astype(np.float32) * s for s in (0.5, 0.05))
        for mode in ("RMSE", "A_weighting"):
            np.testing.assert_array_equal(tango_mix.compute_gain(a, mode=mode),
                                          jmix.compute_gain(a, mode=mode))
        for r in (0.2, 0.5):
            np.testing.assert_array_equal(tango_mix.tango_audio_mix(a, b, r),
                                          jmix.tango_audio_mix(a, b, r))


def test_augmented_batches_and_resume_equal_jax(workspace):  # noqa: F811
    """``EACaps(aug_config=)`` batches bit-equal to the JAX package's, over
    an epoch boundary; a resumed iterator rebinds the augmenter to the
    epoch's generator and draws what the uninterrupted run drew."""
    kw = _data_kw(workspace, aug_config=AUG)
    pit = ResumableIterator(EACaps(**kw, seed=3), 2, seed=3)
    rit = JaxResumable(JaxEACaps(**kw, seed=3), 2, seed=3)
    got, want = iter(pit), iter(rit)
    for _ in range(5):
        _same(next(got), next(want))
    state = pit.state_dict()
    again = ResumableIterator(EACaps(**kw, seed=3), 2, seed=3)
    again.load_state_dict(state)
    resumed = iter(again)
    for _ in range(3):
        b = next(want)
        _same(next(resumed), b)
    plain = next(iter(ResumableIterator(EACaps(**_data_kw(workspace), seed=3), 2, seed=3)))
    first = next(iter(ResumableIterator(EACaps(**kw, seed=3), 2, seed=3)))
    assert not np.array_equal(plain["audio"], first["audio"])  # the augmentation acts


# ---------------------------------------------------------------------------
class TestTracker:
    def test_equal_jax(self, tmp_path):
        port, ref = (tracker.Tracker(str(tmp_path / "a.jsonl"), history=3),
                     jtracker.Tracker(str(tmp_path / "b.jsonl"), history=3))
        seq = [dict(loss=4.0, gn=1.0), dict(loss=2.0), dict(loss=3.0, gn=0.5), dict(loss=1.0)]
        for i, m in enumerate(seq):
            for t in (port, ref):
                t.update("train", m)
            assert port.is_best("train/loss") == ref.is_best("train/loss")
            assert port.log(i, lr=0.1) == ref.log(i, lr=0.1)
        assert port.state_dict() == ref.state_dict()
        assert ((tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text())
        fresh = tracker.Tracker()
        fresh.load_state_dict(port.state_dict())
        assert not fresh.is_best("train/loss")  # no window after a resume
        with pytest.raises(RuntimeError):
            with tracker.timer(port, "phase"):
                raise RuntimeError("timed block failed")
        assert len(port.metrics["time/phase"]) == 1

    def test_experiment_and_trace(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        exp = tracker.Experiment("runs", seed=3)
        name = os.path.basename(jtracker.Experiment("runs_jax", seed=3).exp_dir)
        assert os.path.basename(exp.exp_dir).rsplit("-", 1)[0] == name.rsplit("-", 1)[0]
        with exp() as d:
            assert os.path.samefile(os.getcwd(), tmp_path / d)
        with tracker.profile_trace(str(tmp_path / "trace")):
            torch.ones(64).cumsum(0)
        trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
        assert trace["traceEvents"]


# ---------------------------------------------------------------------------
class TestModelBundles:
    def test_jax_bundle_loads_and_computes_the_same(self, tmp_path, rng):
        jmodel, params = _jax_params(MODEL, 41)
        jio.save_model(str(tmp_path / "j"), "maskdit", {"model": MODEL},
                       jax.device_get(params), {"note": "jax"})
        dit, meta = model_io.load_model(str(tmp_path / "j"))
        assert meta == {"note": "jax"}
        x = rng.standard_normal((2, 20, 8)).astype(np.float32)
        ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
        t = np.array([10, 900])
        want, _ = jax.jit(lambda *a: jmodel.apply({"params": params}, *a))(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        with torch.no_grad():
            got, _ = dit(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        # the port's own bundle: the same two files, reloaded bit for bit
        model_io.save_model(str(tmp_path / "p"), "maskdit", {"model": MODEL}, dit, {"step": 3})
        assert sorted(os.listdir(tmp_path / "p")) == ["metadata.json", "params.npz"]
        again, meta = model_io.load_model(str(tmp_path / "p"))
        assert meta == {"step": 3}
        for (n, a), b in zip(dit.state_dict().items(), again.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)

    def test_audio_vae_bundle_and_refusals(self, tmp_path, rng):
        from ezaudio_tpu.codecs.oobleck import AudioVAE as JaxVAE

        kw = dict(channels=4, latent_dim=4, c_mults=[1, 2], strides=[2, 2])
        jvae = JaxVAE(**kw)
        params = jax.jit(lambda k: jvae.init({"params": k, "sample": k},
                                             jnp.zeros((1, 16, 1))))(jax.random.PRNGKey(0))
        params = jax.device_get(params["params"])
        jio.save_model(str(tmp_path / "v"), "audio_vae", kw, jax.device_get(params))
        vae, _ = model_io.load_model(str(tmp_path / "v"))
        z = rng.standard_normal((1, 6, 4)).astype(np.float32)
        want = jax.jit(lambda z: jvae.apply({"params": params}, z,
                                            method=lambda m, z: m.decode(z)))(jnp.asarray(z))
        with torch.no_grad():
            got = vae.decode(torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

        @model_io.register_model("custom")
        def _custom(width):
            return torch.nn.Linear(width, 2)

        model_io.save_model(str(tmp_path / "c"), "custom", {"width": 3}, _custom(3))
        assert model_io.load_model(str(tmp_path / "c"))[0].in_features == 3
        # a JAX bundle of a kind without a weight map is refused
        jio.save_model(str(tmp_path / "j"), "custom", {"width": 3},
                       {"kernel": np.zeros((3, 2), np.float32)})
        with pytest.raises(NotImplementedError, match="no weight map"):
            model_io.load_model(str(tmp_path / "j"))

        # live weight norm (kept: weight_g / weight_v) and a DAC bundle
        from ezaudio_tpu.codecs.dac import DAC as JaxDAC

        for kind, jmodel, kwargs, x in (
                ("audio_vae", JaxVAE(**kw, use_weight_norm=True), dict(kw, use_weight_norm=True),
                 rng.standard_normal((1, 32, 1))),
                ("dac", JaxDAC(encoder_dim=4, encoder_rates=(2, 4), latent_dim=8,
                               decoder_dim=16, decoder_rates=(4, 2), n_codebooks=2,
                               codebook_size=16, codebook_dim=4, use_weight_norm=True),
                 dict(encoder_dim=4, encoder_rates=[2, 4], latent_dim=8, decoder_dim=16,
                      decoder_rates=[4, 2], n_codebooks=2, codebook_size=16, codebook_dim=4,
                      use_weight_norm=True), rng.standard_normal((1, 64, 1)))):
            x = x.astype(np.float32)
            params = jax.device_get(jax.jit(lambda k, m=jmodel: m.init(
                {"params": k, "sample": k}, jnp.zeros((1, 64, 1))))(jax.random.PRNGKey(1)))
            jio.save_model(str(tmp_path / kind), kind, kwargs, params["params"])
            model, _ = model_io.load_model(str(tmp_path / kind))
            assert any(n.endswith("weight_g") for n in model.state_dict())
            fwd = ((lambda m, a: m.encoder(a)) if kind == "audio_vae"
                   else (lambda m, a: m(a)["audio"]))
            want = jax.jit(lambda p, a, m=jmodel, f=fwd: m.apply(p, a, method=f))(
                params, jnp.asarray(x))
            with torch.no_grad():
                got = (model.encoder(torch.from_numpy(x)) if kind == "audio_vae"
                       else model(torch.from_numpy(x))["audio"])
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
