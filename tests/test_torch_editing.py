"""The port's editing slice on the CPU: the VAE encoder (module and
kernel-routed) against JAX and the reference golden, the facade's chunked
stitching, the editing paste against the reference pipeline golden, and
``editing_audio`` / ``generate_long`` against JAX ``EzAudio`` on carried
weights with the JAX draws injected (ROADMAP F1)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.convert.from_jax import fold_weight_norm, vae_state_dict_from_jax
from tests.test_torch_controlnet import _seeded_init
from tests.test_torch_modules import _np_tree

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inject(monkeypatch, keys):
    """Route the port's draws (``utils.randn``) to ``jax.random.normal`` of
    ``keys``, in call order."""
    keys = list(keys)

    def randn(shape, generator, device, dtype=torch.float32):
        draw = np.array(jax.random.normal(keys.pop(0), tuple(shape)))
        return torch.from_numpy(draw).to(device=device, dtype=dtype)

    monkeypatch.setattr(utils, "randn", randn)
    return keys


def _latent_key(seed):
    """The key JAX ``_generate_latents`` draws its initial latents from."""
    return jax.random.split(jax.random.PRNGKey(seed))[0]


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vae_pair():
    """JAX AudioVAE (channels 8, latent 4, strides (2, 4)) and the port on
    the same carried, non-symmetric random weights."""
    from ezaudio_tpu.codecs.oobleck import AudioVAE as JaxVAE
    from ezaudio_tpu_torch.codecs.oobleck import AudioVAE

    jvae = JaxVAE(channels=8, latent_dim=4, c_mults=(1, 2), strides=(2, 4))
    init = jax.jit(lambda k: jvae.init({"params": k, "sample": k}, jnp.zeros((1, 24, 1))))
    params = _np_tree(init(jax.random.PRNGKey(0))["params"], np.random.default_rng(3))
    vae = AudioVAE(channels=8, latent_dim=4, c_mults=(1, 2), strides=(2, 4)).eval()
    vae.load_state_dict(vae_state_dict_from_jax(params))
    return jvae, params, vae


class TestEncoder:
    def test_encoder_matches_jax(self, vae_pair, rng, monkeypatch):
        """Module and kernel-routed encoder against the JAX encoder (atol
        1e-5); the sampled latent with the JAX draw injected (atol 1e-5)."""
        from ezaudio_tpu.codecs.oobleck import vae_sample as jax_vae_sample
        from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
        from ezaudio_tpu_torch.codecs.oobleck_fast import encode_fused

        jvae, params, vae = vae_pair
        audio = rng.uniform(-1, 1, (2, 128, 1)).astype(np.float32)
        want = np.asarray(jvae.apply({"params": params}, jnp.asarray(audio),
                                     method=lambda m, a: m.encoder(a)))
        with torch.no_grad():
            module = vae.encoder(torch.from_numpy(audio)).numpy()
            fused = encode_fused(vae.encoder, torch.from_numpy(audio)).numpy()
        assert want.shape == (2, 16, 8)
        np.testing.assert_allclose(module, want, atol=1e-5)
        np.testing.assert_allclose(fused, want, atol=1e-5)

        key = jax.random.PRNGKey(4)
        want_z = np.asarray(jax_vae_sample(key, jnp.asarray(want)))
        _inject(monkeypatch, [key])
        got_z = AutoencoderFacade(vae).encode(audio, generator=None).numpy()
        np.testing.assert_allclose(got_z, want_z, atol=1e-5)

    def test_encoder_matches_reference_golden(self):
        """Reference weight-normed encoder, folded: mean||scale atol 2e-4
        as tests/test_parity.py holds the JAX encoder."""
        from ezaudio_tpu_torch.codecs.oobleck import OobleckEncoder
        from ezaudio_tpu_torch.codecs.oobleck_fast import encode_fused

        d = dict(np.load(os.path.join(FIXTURES, "vae_tiny.npz")))
        enc = OobleckEncoder(1, 8, 8, (1, 2), (2, 4)).eval()
        enc.load_state_dict(fold_weight_norm(
            {k[len("enc."):]: v for k, v in d.items() if k.startswith("enc.")}))
        x = torch.from_numpy(d["x"]).transpose(1, 2)
        with torch.no_grad():
            ms = encode_fused(enc, x).numpy()
            module = enc(x).numpy()
        want = d["mean_scale"].transpose(0, 2, 1)
        np.testing.assert_allclose(ms, want, atol=2e-4)
        np.testing.assert_allclose(module, want, atol=2e-4)

    def test_chunked_stitching_matches_jax(self, vae_pair, rng):
        """encode_audio / decode_audio with chunks of 48 latent frames and
        an overlap of 16 (a ragged last chunk), posterior mean: atol 1e-5
        (encode) and 1e-4 (decode) against the JAX facade."""
        from ezaudio_tpu.codecs.facade import AutoencoderFacade as JaxFacade
        from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade

        jvae, params, vae = vae_pair
        jf, tf = JaxFacade(jvae, params), AutoencoderFacade(vae)
        audio = rng.uniform(-1, 1, (1, 100 * 8, 1)).astype(np.float32)
        kw = dict(chunked=True, overlap=16, chunk_size=48)
        want = np.asarray(jf.encode_audio(audio, sample=False, **kw))
        got = tf.encode_audio(audio, sample=False, **kw).numpy()
        assert got.shape == want.shape == (1, 100, 4)
        np.testing.assert_allclose(got, want, atol=1e-5)
        z = rng.standard_normal((1, 100, 4)).astype(np.float32)
        want = np.asarray(jf.decode_audio(z, **kw))
        got = tf.decode_audio(z, **kw).numpy()
        assert got.shape == want.shape == (1, 800, 1)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_audio_io_matches_jax(tmp_path):
    """A stereo int16 wav at 1600 Hz, loaded at 800 Hz and peak-normalized."""
    from scipy.io import wavfile

    from ezaudio_tpu.data.audio_io import load_wav as jax_load_wav
    from ezaudio_tpu.data.audio_io import peak_normalize as jax_peak
    from ezaudio_tpu_torch.data.audio_io import load_wav, peak_normalize

    data = (np.random.default_rng(5).uniform(-0.5, 0.5, (1600, 2)) * 32767).astype(np.int16)
    path = str(tmp_path / "clip.wav")
    wavfile.write(path, 1600, data)
    got = load_wav(path, 800)
    want, want_sr = jax_load_wav(path, sr=800)
    assert want_sr == 800 and got.shape == want.shape == (800,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(peak_normalize(got), jax_peak(want))
    # a garbage non-wav file: the codec bridge refuses it on both sides
    # (without the bridge, both raise ImportError)
    (tmp_path / "clip.mp3").write_bytes(b"ID3")
    with pytest.raises((OSError, ImportError)) as got_err:
        load_wav(str(tmp_path / "clip.mp3"), 800)
    with pytest.raises((OSError, ImportError)) as want_err:
        jax_load_wav(str(tmp_path / "clip.mp3"), sr=800)
    assert isinstance(got_err.value, OSError) == isinstance(want_err.value, OSError)


def test_edit_paste_matches_reference_golden():
    """_generate_latents with gt + gt_mask, the reference's hard paste and
    decode, 25 steps: the reference pipeline's ``wav_edit`` at atol 1e-4
    (as tests/test_parity.py:264-279 holds the JAX package)."""
    from ezaudio_tpu_torch.utils import scale_shift_re
    from tests.test_torch_pipeline import golden_ezaudio

    ez, d = golden_ezaudio()
    gt = torch.from_numpy(d["gt"]).transpose(1, 2)
    gt_mask = torch.from_numpy(d["gt_mask"]).transpose(1, 2).bool()
    latents = ez._generate_latents(
        [str(d["prompt"][0])], 32, float(d["guidance"]), 0.0, int(d["steps"]), 0.0, 0,
        initial_latents=d["noise"].transpose(0, 2, 1), gt=gt, gt_mask=gt_mask)
    pred = torch.where(gt_mask, scale_shift_re(latents, ez.scale, ez.shift), gt)
    wav = ez.autoencoder.decode(pred)[..., 0].numpy()
    np.testing.assert_allclose(wav, d["wav_edit"][:, 0, :], atol=1e-4)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_pair():
    """JAX tiny EzAudio and the port on the same carried weights."""
    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.convert.from_jax import (maskdit_state_dict_from_jax,
                                                    t5_state_dict_from_jax)
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
    from tests.tiny_config import (TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG,
                                   make_tiny_ezaudio)

    # every leaf drawn from a seed by shape alone (flax's own init runs the
    # model op by op: ~30 s on one core); none is zero (ROADMAP F6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(12)))
        jez = make_tiny_ezaudio()
    rng = np.random.default_rng(12)
    jez.dit_params = {"params": _np_tree(jez.dit_params["params"], rng)}
    jez.t5_params = _np_tree(jez.t5_params, rng)
    jez.autoencoder.params = _np_tree(jez.autoencoder.params, rng)

    ez = EzAudio(config=TINY_CONFIG, vae_config=TINY_VAE_CONFIG,
                 t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)), device="cpu")
    ez.dit.load_state_dict(maskdit_state_dict_from_jax(
        jez.dit_params["params"], TINY_CONFIG["model"]))
    ez.t5.load_state_dict(t5_state_dict_from_jax(jez.t5_params, TINY_T5.num_layers))
    ez.autoencoder.model.load_state_dict(vae_state_dict_from_jax(jez.autoencoder.params))
    return jez, ez


# a 2 s clip at the tiny config's 800 Hz; the edit window [0.25, 1.25) s is
# 800 samples = 50 latent frames, the shape generate_long's edits reuse
CLIP = (0.5 * np.sin(2 * np.pi * 110 * np.arange(1600) / 800)
        + 0.1 * np.random.default_rng(6).standard_normal(1600)).astype(np.float32)
EDIT = dict(boundary=0.25, mask_start=0.5, mask_length=0.5, ddim_steps=3, eta=0.0)


@pytest.mark.parametrize("crossfade", [0.0, 0.2])
def test_editing_matches_jax(tiny_pair, monkeypatch, crossfade):
    """Hard paste and a 0.2 s crossfade, 3 steps, eta 0, the JAX encode
    and initial-latent draws injected: atol 1e-4, corr > 0.9999; outside
    the window the clip is the peak-normalized input, bit for bit."""
    jez, ez = tiny_pair
    _, want = jez.editing_audio("a dog barking", gt_file=CLIP, random_seed=5,
                                crossfade=crossfade, **EDIT)
    left = _inject(monkeypatch, [jax.random.PRNGKey(5), _latent_key(5)])
    _, got = ez.editing_audio("a dog barking", gt_file=CLIP, random_seed=5,
                              crossfade=crossfade, **EDIT)
    assert not left
    assert got.shape == want.shape == CLIP.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.corrcoef(got, want)[0, 1] > 0.9999
    norm = CLIP / (np.abs(CLIP).max() + 1e-9)
    np.testing.assert_array_equal(got[:200], norm[:200])
    np.testing.assert_array_equal(got[1000:], norm[1000:])


@pytest.mark.parametrize("mask_start,mask_length", [(0.5, 0.02), (0.0, 0.01)])
def test_crossfade_under_two_latent_frames_takes_the_hard_paste(
        tiny_pair, mask_start, mask_length):
    """ROADMAP F4, the port's one intended divergence from the JAX package:
    a mask that rounds to fewer than 2 latent frames (here 1 and 0) takes
    the hard paste.  The JAX code writes its crossfade ramp outside such a
    mask, or raises where the mask starts at frame 0."""
    _, ez = tiny_pair
    kw = dict(EDIT, mask_start=mask_start, mask_length=mask_length, random_seed=2)
    _, hard = ez.editing_audio("rain", gt_file=CLIP, **kw)
    _, faded = ez.editing_audio("rain", gt_file=CLIP, crossfade=0.2, **kw)
    assert np.isfinite(hard).all()
    np.testing.assert_array_equal(faded, hard)


def test_generate_long_matches_jax(tiny_pair, monkeypatch):
    """2.5 s from 1 s windows with 0.25 s overlap (one generate, two
    outpainting edits, seeds 3, 4, 5), 3 steps, eta 0, the JAX draws
    injected: atol 1e-4, corr > 0.9999."""
    jez, ez = tiny_pair
    kw = dict(length=2.5, window=1.0, overlap=0.25, guidance_scale=3.5,
              guidance_rescale=0.0, ddim_steps=3, eta=0.0, random_seed=3)
    _, want = jez.generate_long("footsteps", **kw)
    left = _inject(monkeypatch, [_latent_key(3), jax.random.PRNGKey(4), _latent_key(4),
                                 jax.random.PRNGKey(5), _latent_key(5)])
    _, got = ez.generate_long("footsteps", **kw)
    assert not left
    assert got.shape == want.shape == (2000,)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.corrcoef(got, want)[0, 1] > 0.9999
