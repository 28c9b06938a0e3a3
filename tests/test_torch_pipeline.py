"""The port's whole text-to-audio slice on the CPU: against the JAX
``EzAudio`` on carried weights, against the committed reference-torch
pipeline golden, and the package rules (no JAX import, no silent CPU,
uncovered arguments raise)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.convert.from_jax import (fold_weight_norm,
                                                maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax,
                                                vae_state_dict_from_jax)
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig, t5_state_dict_from_hf
from tests.test_torch_controlnet import _seeded_init
from tests.test_torch_modules import _np_tree

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test (xdist runs six workers); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX tiny EzAudio and the port on the same carried weights."""
    from tests.tiny_config import (TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG,
                                   make_tiny_ezaudio)

    # every leaf drawn from a seed by shape alone (flax's own init runs the
    # model op by op: ~30 s on one core); none is zero (ROADMAP F6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(11)))
        jez = make_tiny_ezaudio()
    rng = np.random.default_rng(11)
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


class TestAgainstJax:
    def test_generate_matches_jax(self, tiny_pair):
        """Two prompts, CFG 3 + rescale 0.75, 3 DDIM steps, eta 0, same
        initial latents: waveform atol 1e-4 and corr > 0.9999."""
        jez, ez = tiny_pair
        prompts = ["a dog barking", "rain on a tin roof"]
        noise = np.random.default_rng(2).standard_normal((2, 50, 8)).astype(np.float32)
        kw = dict(length=1.0, guidance_scale=3.0, guidance_rescale=0.75,
                  ddim_steps=3, eta=0.0, random_seed=0, initial_latents=noise)
        _, want = jez.generate_audio(prompts, **kw)
        _, got = ez.generate_audio(prompts, **kw)
        assert got.shape == want.shape == (2, 800)
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999

    def test_text_embedding_matches_jax(self, tiny_pair):
        """HashTokenizer ids and T5 embeddings: atol 1e-5."""
        jez, ez = tiny_pair
        want, want_mask = jez.embed_text(["", "a dog barking"])
        got, got_mask = ez.embed_text(["", "a dog barking"])
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_empty_prompts_turn_guidance_off(self, tiny_pair):
        _, ez = tiny_pair
        noise = np.random.default_rng(3).standard_normal((1, 25, 8)).astype(np.float32)
        kw = dict(length=0.5, ddim_steps=2, eta=0.0, initial_latents=noise)
        _, a = ez.generate_audio([""], guidance_scale=5, **kw)
        _, b = ez.generate_audio([""], guidance_scale=None, **kw)
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("kw", [
        dict(sampler="dpm"),
        dict(layer_cache=(1, 2)),
        dict(guidance_interval=(100, 900)),
        dict(sampler="dpm", cfg_refresh=2),
        dict(sampler="dpm", layer_cache=(1, 2), guidance_interval=(100, 900)),
        dict(sampler="distilled"),
    ])
    def test_sampler_arguments_match_jax(self, tiny_pair, kw):
        """The fast-sampler arguments of generate_audio, 3 steps, eta 0,
        same initial latents: waveform atol 1e-4 and corr > 0.9999."""
        jez, ez = tiny_pair
        noise = np.random.default_rng(4).standard_normal((1, 50, 8)).astype(np.float32)
        kw = dict(kw, length=1.0, guidance_scale=3.0, guidance_rescale=0.5, ddim_steps=3,
                  eta=0.0, random_seed=0, initial_latents=noise)
        _, want = jez.generate_audio("a dog barking", **kw)
        _, got = ez.generate_audio("a dog barking", **kw)
        assert got.shape == want.shape == (800,)
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.corrcoef(got, want)[0, 1] > 0.9999

    def test_eta_noise_is_seeded(self, tiny_pair):
        _, ez = tiny_pair
        kw = dict(length=0.5, ddim_steps=2, eta=1.0)
        _, a = ez.generate_audio("wind", random_seed=4, **kw)
        _, b = ez.generate_audio("wind", random_seed=4, **kw)
        _, c = ez.generate_audio("wind", random_seed=5, **kw)
        assert a.shape == (400,) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


def golden_ezaudio():
    """The port's EzAudio on the reference-torch pipeline golden's state
    dicts (loaded by name) and its golden arrays."""
    from scripts.gen_goldens import TINY_DIT_CFG

    d = dict(np.load(os.path.join(FIXTURES, "pipeline_tiny.npz"), allow_pickle=False))
    config = dict(
        model_name="EzAudio-PipelineTiny", model=dict(TINY_DIT_CFG),
        autoencoder=dict(name="stable_vae", dim=8, sr=256, latent_sr=32, q_first=True,
                         scale=float(d["scale"]), shift=float(d["shift"])),
        text_encoder=dict(model="tiny-t5", max_length=int(d["max_length"]), cfg=0.1),
        diff=dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                  beta_start=0.00085, beta_end=0.012, prediction_type="v_prediction",
                  rescale_betas_zero_snr=True, timestep_spacing="trailing",
                  clip_sample=False))
    vae_config = dict(model=dict(
        decoder=dict(type="oobleck", config=dict(
            out_channels=1, channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=8,
            use_snake=True, final_tanh=False)),
        bottleneck=dict(type="vae"), latent_dim=8, io_channels=1))
    t5_cfg = T5EncoderConfig(vocab_size=256, d_model=24, d_kv=8, d_ff=32,
                             num_layers=2, num_heads=4)
    ez = EzAudio(config=config, vae_config=vae_config, t5_config=t5_cfg, device="cpu")

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in d.items()
                if k.startswith(prefix)}

    ez.dit.load_state_dict(part("dit."))
    ez.t5.load_state_dict(t5_state_dict_from_hf(part("t5.")))
    ez.autoencoder.model.decoder.load_state_dict(fold_weight_norm(part("dec.")))
    return ez, d


class TestAgainstReferenceGolden:
    def test_pipeline_golden(self):
        """Reference torch pipeline (HashTokenizer -> T5 -> 25-step DDIM +
        CFG + rescale -> decode), its state dicts loaded by name: atol 1e-4
        and corr > 0.9999, as tests/test_parity.py holds the JAX package."""
        ez, d = golden_ezaudio()
        _, wav = ez.generate_audio(
            [str(d["prompt"][0])], length=1.0, guidance_scale=float(d["guidance"]),
            guidance_rescale=float(d["rescale"]), ddim_steps=int(d["steps"]), eta=0.0,
            random_seed=0, initial_latents=d["noise"].transpose(0, 2, 1))
        want = d["wav"][:, 0, :]
        assert wav.shape == want.shape
        np.testing.assert_allclose(wav, want, atol=1e-4)
        assert np.corrcoef(wav.ravel(), want.ravel())[0, 1] > 0.9999


class TestPackageRules:
    def test_imports_neither_jax_nor_the_jax_package(self):
        code = (
            "import importlib, pkgutil, sys, ezaudio_tpu_torch\n"
            "for m in pkgutil.walk_packages(ezaudio_tpu_torch.__path__, 'ezaudio_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                                      'transformers', 'scripts')\n"
            "       or m == 'ezaudio_tpu' or m.startswith('ezaudio_tpu.')]\n"
            "assert not bad, bad\n"
            "harness = ('quality_validate', 'distill_validate', 'mid_common',\n"
            "           'quality_validate_mid', 'distill_serve_mid',\n"
            "           'quality_edit_controlnet_mid', 'verify_checkpoints',\n"
            "           'calibrate_pesq_mnru', 'calibrate_nsim_mnru')\n"
            "assert all('ezaudio_tpu_torch.validation.' + h in sys.modules for h in harness)\n"
            "print(len([m for m in sys.modules if m.startswith('ezaudio_tpu_torch')]))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.split()[-1]) >= 46

    def test_no_silent_cpu(self):
        from ezaudio_tpu_torch.utils import resolve_device
        from tests.tiny_config import TINY_CONFIG

        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            EzAudio(config=TINY_CONFIG)
        with pytest.raises(RuntimeError, match="CUDA"):
            EzAudio(model_name="s3_l")

    @pytest.mark.parametrize("kw", [dict(attn_impl="bf16"), dict(attn_impl="chunked_bf16"),
                                    dict(attn_impl="ring")])
    def test_uncovered_arguments_raise(self, tiny_pair, kw):
        """``'ring'`` outside a ``ring_context`` raises (JAX asserts;
        tests/test_torch_ring_attention.py runs it on a mesh).  The attention variants
        that keep their logits in bf16 (another function than kernel 1's)
        run, on the f32 model too: ``generate_audio`` against JAX with the
        same variant (3 DPM steps, same initial latents) within 2e-3 and
        corr > 0.9999 (XLA keeps excess precision inside its fused softmax,
        so JAX's jitted variant is no nearer to the port's than to f32
        logits: tests/test_torch_bf16.py holds the function op by op), not
        the f32-logit waveform, and ``editing_audio`` runs."""
        jez, ez = tiny_pair
        clip = np.random.default_rng(1).standard_normal(400).astype(np.float32)
        edit = dict(boundary=0.1, gt_file=clip, mask_start=0.1, mask_length=0.2, ddim_steps=1)
        if kw["attn_impl"] == "ring":
            with pytest.raises(RuntimeError, match="ring_context"):
                ez.generate_audio("x", length=0.5, ddim_steps=1, **kw)
            with pytest.raises(RuntimeError, match="ring_context"):
                ez.editing_audio("x", **edit, **kw)
            return
        noise = np.random.default_rng(4).standard_normal((1, 50, 8)).astype(np.float32)
        gen = dict(length=1.0, guidance_scale=3.0, ddim_steps=3, sampler="dpm",
                   random_seed=0, initial_latents=noise)
        _, want = jez.generate_audio("a dog barking", **gen, **kw)
        _, got = ez.generate_audio("a dog barking", **gen, **kw)
        _, f32 = ez.generate_audio("a dog barking", **gen)
        np.testing.assert_allclose(got, want, atol=2e-3)
        assert np.corrcoef(got, want)[0, 1] > 0.9999
        assert not np.array_equal(got, f32)
        _, edited = ez.editing_audio("x", **edit, **kw)
        assert edited.shape == clip.shape and np.isfinite(edited).all()

    @pytest.mark.parametrize("impl", ["auto", "einsum", "pallas", "flash", "chunked"])
    def test_attention_impls_run_on_kernel_1(self, tiny_pair, impl):
        """The JAX package's f32-softmax attention implementations all
        compute kernel 1's function: the port runs each on it, with the
        default's waveform."""
        _, ez = tiny_pair
        kw = dict(length=0.5, ddim_steps=2, random_seed=1)
        _, want = ez.generate_audio("x", **kw)
        _, got = ez.generate_audio("x", attn_impl=impl, **kw)
        np.testing.assert_array_equal(got, want)

    def test_unknown_attention_impl_raises(self, tiny_pair):
        _, ez = tiny_pair
        with pytest.raises(ValueError, match="attn_impl"):
            ez.generate_audio("x", length=0.5, ddim_steps=1, attn_impl="sparse")

    def test_bfloat16_model_raises(self):
        """``dtype=bfloat16`` builds (bf16 copies of the DiT's, T5's and the
        VAE's weights, f32 norms) and generates; a dtype neither kernel
        takes raises."""
        from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

        with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
            EzAudio(config=TINY_CONFIG, device="cpu", dtype=torch.float16)
        kw = dict(config=TINY_CONFIG, vae_config=TINY_VAE_CONFIG, device="cpu",
                  t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)))
        ez = EzAudio(dtype=torch.bfloat16, **kw)
        f32 = EzAudio(**kw)
        assert ez.dtype == torch.bfloat16
        assert ez.dit.model.time_ada.weight.dtype == torch.bfloat16
        assert ez.dit.model.final_block.norm.weight.dtype == torch.float32
        torch.testing.assert_close(ez.dit.model.time_ada.weight,
                                   f32.dit.model.time_ada.weight.bfloat16(), rtol=0, atol=0)
        _, wav = ez.generate_audio("x", length=0.5, ddim_steps=2, random_seed=1)
        _, want = f32.generate_audio("x", length=0.5, ddim_steps=2, random_seed=1)
        assert wav.dtype == np.float32 and np.isfinite(wav).all()
        assert np.corrcoef(wav, want)[0, 1] > 0.99 and not np.array_equal(wav, want)

    def test_mesh_raises(self):
        """``mesh`` is ported (tests/test_torch_parallel.py); anything but a
        ``make_mesh`` DeviceMesh raises."""
        from tests.tiny_config import TINY_CONFIG

        with pytest.raises(TypeError, match="mesh"):
            EzAudio(config=TINY_CONFIG, device="cpu", mesh=object())

    @pytest.mark.parametrize("kw", [dict(sampler="ddim", cfg_refresh=2),
                                    dict(sampler="distilled", layer_cache=(1, 2)),
                                    dict(sampler="distilled", guidance_interval=(100, 900))])
    def test_sampler_guards_raise_as_jax_does(self, tiny_pair, kw):
        """The port raises ValueError where the JAX package raises
        (ValueError, or an assert for 'distilled')."""
        jez, ez = tiny_pair
        with pytest.raises((AssertionError, ValueError)):
            jez.generate_audio("x", length=0.5, ddim_steps=1, **kw)
        with pytest.raises(ValueError):
            ez.generate_audio("x", length=0.5, ddim_steps=1, **kw)

    def test_s3_l_config_shapes(self):
        """The packaged s3_l config builds the published widths (on the
        meta device: no memory)."""
        from ezaudio_tpu_torch.config import get_model_config
        from ezaudio_tpu_torch.models.maskdit import maskdit_from_config

        cfg = get_model_config("s3_l")
        with torch.device("meta"):
            dit = maskdit_from_config(cfg.model.to_dict())
        n = sum(p.numel() for p in dit.parameters())
        assert len(dit.model.in_blocks) == 12 and len(dit.model.out_blocks) == 12
        assert dit.model.in_blocks[0].attn.head_dim == 64
        assert 0.5e9 < n < 0.7e9, n
