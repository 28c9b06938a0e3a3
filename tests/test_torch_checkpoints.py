"""Loading the published checkpoints from local files, on the CPU: the
port's loaders (``ezaudio_tpu_torch/convert/checkpoints.py``,
``EzAudio(ckpt_path=, vae_path=, t5_path=)``,
``EzAudioControlNet(controlnet_path=)``) against the JAX package's loaders
reading the same files, in the reference formats: the DiT and the
ControlNet as ``{"model": state_dict}``, the VAE as ``{"state_dict":
{"autoencoder." + name: ...}}`` with ``weight_g``/``weight_v``, T5 in HF
names as a ``.pt``, an HF directory and a ``.safetensors`` file.

Loaded tensors are equal bit for bit, except the VAE's weight-norm folded
convs (``g * v / ||v||``, summed in another order by numpy and torch):
those within rtol 1e-6, a few f32 ulps."""

import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
from ezaudio_tpu_torch.api.ezaudio import EzAudio, init_random_
from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
from ezaudio_tpu_torch.convert.checkpoints import (load_state_dict_strict, load_t5_state_dict,
                                                   load_torch_checkpoint, strip_prefix)
from ezaudio_tpu_torch.convert.from_jax import (controlnet_state_dict_from_jax,
                                                fold_weight_norm, maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax, vae_state_dict_from_jax)
from ezaudio_tpu_torch.text.t5 import T5Encoder, T5EncoderConfig, t5_state_dict_from_hf
from tests.test_controlnet import TINY_CN
from tests.test_dit import TINY_MODEL
from tests.tiny_config import TINY_CONFIG

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FOLD_RTOL = 1e-6

T5_KW = dict(vocab_size=128, d_model=24, d_kv=8, d_ff=32, num_layers=2, num_heads=3,
             relative_attention_num_buckets=8, relative_attention_max_distance=20)
# a 4-block Oobleck VAE (the JAX EzAudio's VAE loader reads 4 blocks), x16
# down to 8 latent channels at 50 Hz, as TINY_CONFIG's autoencoder block
VAE4_CONFIG = dict(model=dict(
    encoder=dict(type="oobleck", config=dict(in_channels=1, channels=4, c_mults=[1, 1, 2, 2],
                                             strides=[2, 2, 2, 2], latent_dim=16)),
    decoder=dict(type="oobleck", config=dict(out_channels=1, channels=4, c_mults=[1, 1, 2, 2],
                                             strides=[2, 2, 2, 2], latent_dim=8,
                                             final_tanh=False)),
    bottleneck=dict(type="vae"), latent_dim=8, downsampling_ratio=16, io_channels=1))
# the DiT of maskdit_tiny.npz (TINY_MODEL: context 24, 8 latent channels)
# and the ControlNet of controlnet_tiny.npz (TINY_CN)
CONFIG = dict(TINY_CONFIG, model=TINY_MODEL)
COND_CFG = dict(condition_type="energy", hop_size=8, window_size=64, padding="reflect",
                min_db=-60, norm=True)
CN_CONFIG = dict(CONFIG, controlnet=TINY_CN, conditioner=COND_CFG)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture_sd(name, prefix):
    d = np.load(os.path.join(FIXTURES, name))
    return {k[len(prefix):]: torch.from_numpy(d[k]) for k in d.files if k.startswith(prefix)}


def hf_t5_state_dict(cfg: T5EncoderConfig, rng):
    """A seeded FLAN-T5-style encoder state dict in HF names."""
    inner, d = cfg.num_heads * cfg.d_kv, cfg.d_model

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[-1]))
                                .astype(np.float32))

    def ln():
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))

    sd = {"shared.weight": torch.from_numpy(
        rng.standard_normal((cfg.vocab_size, d)).astype(np.float32))}
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"].clone()
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer"
        for n in "qkv":
            sd[f"{p}.0.SelfAttention.{n}.weight"] = w(inner, d)
        sd[f"{p}.0.SelfAttention.o.weight"] = w(d, inner)
        if i == 0:
            sd[f"{p}.0.SelfAttention.relative_attention_bias.weight"] = w(
                cfg.relative_attention_num_buckets, cfg.num_heads)
        sd[f"{p}.0.layer_norm.weight"] = ln()
        sd[f"{p}.1.DenseReluDense.wi_0.weight"] = w(cfg.d_ff, d)
        sd[f"{p}.1.DenseReluDense.wi_1.weight"] = w(cfg.d_ff, d)
        sd[f"{p}.1.DenseReluDense.wo.weight"] = w(d, cfg.d_ff)
        sd[f"{p}.1.layer_norm.weight"] = ln()
    sd["encoder.final_layer_norm.weight"] = ln()
    return sd


def save_checkpoints(d, dit_sd=None, vae_sd=None, t5_hf=None, cn_sd=None):
    """Write the given state dicts in the reference formats under ``d``;
    returns their paths by name."""
    paths = {}
    if dit_sd is not None:
        paths["ckpt_path"] = os.path.join(d, "dit.pt")
        torch.save({"model": dit_sd}, paths["ckpt_path"])
    if vae_sd is not None:
        paths["vae_path"] = os.path.join(d, "vae.pt")
        torch.save({"state_dict": {"autoencoder." + k: v for k, v in vae_sd.items()}},
                   paths["vae_path"])
    if t5_hf is not None:
        paths["t5_path"] = os.path.join(d, "t5.pt")
        torch.save(t5_hf, paths["t5_path"])
    if cn_sd is not None:
        paths["controlnet_path"] = os.path.join(d, "cn.pt")
        torch.save({"model": cn_sd}, paths["controlnet_path"])
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The fixtures' reference state dicts and seeded T5 and 4-block VAE
    state dicts, written in the reference formats."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    rng = np.random.default_rng(5)
    vae4 = vae_from_config(VAE4_CONFIG)
    init_random_(vae4, torch.Generator().manual_seed(3))
    t5_hf = hf_t5_state_dict(T5EncoderConfig(**T5_KW), rng)
    paths = save_checkpoints(d, _fixture_sd("maskdit_tiny.npz", "sd."),
                             cs.unfold_weight_norm(vae4.state_dict()), t5_hf,
                             _fixture_sd("controlnet_tiny.npz", "sd."))
    fixture_vae = {("autoencoder.encoder.layers." if k.startswith("enc.") else
                    "autoencoder.decoder.layers.") + k.split(".layers.", 1)[1]: v
                   for k, v in _fixture_sd("vae_tiny.npz", "").items()
                   if k.startswith(("enc.", "dec."))}
    paths["vae_tiny_path"] = os.path.join(d, "vae_tiny.pt")
    torch.save({"state_dict": fixture_vae}, paths["vae_tiny_path"])
    from safetensors.torch import save_file

    for sub, name, fmt in (("hf", "model.safetensors", "st"), ("hf_bin", "pytorch_model.bin", "pt"),
                           ("", "t5.safetensors", "st")):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        p = os.path.join(d, sub, name)
        if fmt == "st":
            save_file({k: v.contiguous() for k, v in t5_hf.items()}, p)
        else:
            torch.save(t5_hf, p)
    paths.update(t5_hf_dir=os.path.join(d, "hf"), t5_bin_dir=os.path.join(d, "hf_bin"),
                 t5_safetensors=os.path.join(d, "t5.safetensors"))
    return paths


def _assert_equal_sd(got, want, fold_rtol=None):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].detach().cpu(), want[k].detach().cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if fold_rtol is not None and k.endswith(".weight") and w.ndim == 3:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=fold_rtol, atol=1e-9,
                                       err_msg=k)
        else:
            assert torch.equal(g, w), k


@pytest.fixture(scope="module")
def loaded(files):
    """The JAX EzAudio and the port's, each built from the same three
    files (no flax init: every component has a path)."""
    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio
    from ezaudio_tpu.text.t5 import T5EncoderConfig as JaxT5Config

    paths = {k: files[k] for k in ("ckpt_path", "vae_path", "t5_path")}
    jez = JaxEzAudio(config=CONFIG, t5_config=JaxT5Config(**T5_KW), vae_config=VAE4_CONFIG,
                     **paths)
    ez = EzAudio(config=CONFIG, t5_config=T5EncoderConfig(**T5_KW), vae_config=VAE4_CONFIG,
                 device="cpu", **paths)
    return jez, ez


class TestLoaders:
    def test_ezaudio_loads_what_jax_loads(self, loaded):
        """DiT and T5 bit for bit, the VAE within the fold limit, every
        weight on the model's device."""
        import jax

        jez, ez = loaded
        _assert_equal_sd(ez.dit.state_dict(), maskdit_state_dict_from_jax(
            jax.device_get(jez.dit_params["params"]), TINY_MODEL))
        _assert_equal_sd(ez.t5.state_dict(), t5_state_dict_from_jax(
            jax.device_get(jez.t5_params), T5_KW["num_layers"]))
        _assert_equal_sd(ez.autoencoder.model.state_dict(), vae_state_dict_from_jax(
            jax.device_get(jez.autoencoder.params)), FOLD_RTOL)
        for m in (ez.dit, ez.t5, ez.autoencoder.model):
            assert all(p.device == ez.device for p in m.state_dict().values())

    def test_generate_audio_matches_jax_loaded_from_the_same_files(self, loaded):
        """Two prompts, CFG 3 + rescale 0.75, 3 DDIM steps, eta 0, the same
        initial latents: waveform atol 1e-4 and corr > 0.9999."""
        jez, ez = loaded
        noise = np.random.default_rng(2).standard_normal((2, 50, 8)).astype(np.float32)
        kw = dict(length=1.0, guidance_scale=3.0, guidance_rescale=0.75, ddim_steps=3,
                  eta=0.0, random_seed=0, initial_latents=noise)
        _, want = jez.generate_audio(["a dog barking", "rain on a tin roof"], **kw)
        _, got = ez.generate_audio(["a dog barking", "rain on a tin roof"], **kw)
        assert got.shape == want.shape == (2, 800)
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999

    def test_reference_vae_fixture_loads_as_jax(self, files):
        """vae_tiny.npz's 2-block reference state dict (weight_g/weight_v):
        the port's fold against the JAX converter's, within the fold limit."""
        from ezaudio_tpu.convert import torch_to_jax as tj

        cfg = dict(model=dict(
            encoder=dict(type="oobleck", config=dict(in_channels=1, channels=8, c_mults=[1, 2],
                                                     strides=[2, 4], latent_dim=8)),
            decoder=dict(type="oobleck", config=dict(out_channels=1, channels=8,
                                                     c_mults=[1, 2], strides=[2, 4],
                                                     latent_dim=4, final_tanh=False)),
            bottleneck=dict(type="vae"), latent_dim=4, io_channels=1))
        p = files["vae_tiny_path"]
        vae = vae_from_config(cfg)
        load_state_dict_strict(
            vae, fold_weight_norm(strip_prefix(load_torch_checkpoint(p, "state_dict"),
                                               "autoencoder.")), p)
        want = vae_state_dict_from_jax(tj.convert_vae_state_dict(
            tj.strip_prefix(tj.load_torch_checkpoint(p, key="state_dict"), "autoencoder."),
            num_blocks=2))
        _assert_equal_sd(vae.state_dict(), want, FOLD_RTOL)

    @pytest.mark.parametrize("fmt", ["t5_path", "t5_hf_dir", "t5_bin_dir", "t5_safetensors"])
    def test_t5_formats_load_as_jax(self, files, fmt):
        """A ``.pt``, an HF directory (``model.safetensors``; ``pytorch_model.bin``)
        and a ``.safetensors`` file: the port's T5 equals the JAX converter's
        reading the same file, bit for bit."""
        from ezaudio_tpu.api.ezaudio import _load_t5_state_dict
        from ezaudio_tpu.text.t5 import T5EncoderConfig as JaxT5Config
        from ezaudio_tpu.text.t5 import convert_t5_encoder_state_dict

        p = files[fmt]
        t5 = T5Encoder(T5EncoderConfig(**T5_KW))
        load_state_dict_strict(t5, t5_state_dict_from_hf(load_t5_state_dict(p)), p)
        want = t5_state_dict_from_jax(
            convert_t5_encoder_state_dict(_load_t5_state_dict(p), JaxT5Config(**T5_KW)),
            T5_KW["num_layers"])
        _assert_equal_sd(t5.state_dict(), want)

    def test_controlnet_path_loads_as_jax(self, files):
        """``EzAudioControlNet(controlnet_path=)``: controlnet_tiny.npz's
        reference state dict, equal bit for bit to the JAX converter's."""
        from ezaudio_tpu.convert import torch_to_jax as tj

        p = files["controlnet_path"]
        cn = EzAudioControlNet(config=CN_CONFIG, t5_config=T5EncoderConfig(**T5_KW),
                               vae_config=VAE4_CONFIG, controlnet_path=p, device="cpu")
        want = controlnet_state_dict_from_jax(tj.convert_controlnet_state_dict(
            tj.load_torch_checkpoint(p, key="model"), TINY_MODEL, TINY_CN), TINY_MODEL, TINY_CN)
        _assert_equal_sd(cn.controlnet.state_dict(), want)

    def test_strict_load_names_the_key(self, files, tmp_path):
        """A missing or an unexpected key raises and names it and the file;
        so does a wrong shape."""
        sd = load_torch_checkpoint(files["ckpt_path"], "model")
        kw = dict(config=CONFIG, t5_config=T5EncoderConfig(**T5_KW), vae_config=VAE4_CONFIG,
                  device="cpu")
        missing = dict(sd)
        del missing["model.final_block.linear.bias"]
        p = save_checkpoints(str(tmp_path), dit_sd=missing)["ckpt_path"]
        with pytest.raises(RuntimeError, match=r"model\.final_block\.linear\.bias") as e:
            EzAudio(ckpt_path=p, **kw)
        assert p in str(e.value)
        p = save_checkpoints(str(tmp_path), dit_sd=dict(sd, extra_head=torch.zeros(3)))[
            "ckpt_path"]
        with pytest.raises(RuntimeError, match="extra_head"):
            EzAudio(ckpt_path=p, **kw)
        bad = dict(sd, mask_embed=torch.zeros(9))
        p = save_checkpoints(str(tmp_path), dit_sd=bad)["ckpt_path"]
        with pytest.raises(RuntimeError, match="mask_embed"):
            EzAudio(ckpt_path=p, **kw)
        with pytest.raises(KeyError, match="state_dict"):
            EzAudio(vae_path=files["ckpt_path"], **kw)

    def test_safetensors_missing_raises_naming_the_file(self, files, monkeypatch):
        """Without the safetensors package (the card's machine has none) a
        ``.safetensors`` T5 path raises ImportError with the file's name; a
        ``.pt`` still loads."""
        monkeypatch.setitem(sys.modules, "safetensors", None)
        monkeypatch.setitem(sys.modules, "safetensors.torch", None)
        for p in (files["t5_safetensors"], files["t5_hf_dir"]):
            with pytest.raises(ImportError, match="safetensors"):
                load_t5_state_dict(p)
            with pytest.raises(ImportError, match=os.path.basename(p)):
                load_t5_state_dict(p)
        assert "shared.weight" in load_t5_state_dict(files["t5_path"])

    def test_a_component_without_a_path_keeps_its_seeded_init(self, files):
        """Only the DiT from a file: T5 and the VAE are the weights of the
        model without paths at the same seed."""
        kw = dict(config=CONFIG, t5_config=T5EncoderConfig(**T5_KW), vae_config=VAE4_CONFIG,
                  device="cpu", seed=4)
        ez = EzAudio(ckpt_path=files["ckpt_path"], **kw)
        ref = EzAudio(**kw)
        _assert_equal_sd(ez.t5.state_dict(), ref.t5.state_dict())
        _assert_equal_sd(ez.autoencoder.model.state_dict(), ref.autoencoder.model.state_dict())
        assert not torch.equal(ez.dit.model.time_ada.weight, ref.dit.model.time_ada.weight)
