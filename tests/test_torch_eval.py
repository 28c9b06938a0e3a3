"""``eval_udit`` (plain and MAE mode) and ``prepare_embeddings`` on the CPU
against the JAX package's, on the tiny EzAudio with the same carried
weights (drawn from a seed by shape, ``_seeded_init``) and the JAX draws
injected where the port draws (``utils.randn``: the VAE posterior sample
and the initial latents; ROADMAP F1), DDIM at eta 0.

Limits: the written waveforms within 1e-4 (the editing path's limit,
test_torch_editing.py: an f32 sampler and the decoder in another
summation order); the MAE spans equal (the same ``random.Random``); the
embeddings within 1e-5 (one f32 T5 forward), the masks equal; the files
the port writes read back by ``EACaps(text_path=, uncond_path=)``.
"""

import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.convert.from_jax import (maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax, vae_state_dict_from_jax)
from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav
from ezaudio_tpu_torch.data.dataset import EACaps
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from ezaudio_tpu_torch.training import evaluate, prepare_embeddings
from tests.test_torch_controlnet import _seeded_init
from tests.tiny_config import TINY_CONFIG, TINY_SR, TINY_T5, TINY_VAE_CONFIG

SEED = 2023


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio
    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(17)))
        jez = JaxEzAudio(config=TINY_CONFIG, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    ez = EzAudio(config=TINY_CONFIG, t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                 vae_config=TINY_VAE_CONFIG, device="cpu")
    ez.dit.load_state_dict(maskdit_state_dict_from_jax(jax.device_get(jez.dit_params["params"]),
                                                       TINY_CONFIG["model"]))
    ez.t5.load_state_dict(t5_state_dict_from_jax(jax.device_get(jez.t5_params),
                                                 TINY_T5.num_layers))
    ez.autoencoder.model.load_state_dict(vae_state_dict_from_jax(
        jax.device_get(jez.autoencoder.params)))
    return jez, ez


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(5)
    rows = []
    for i in range(3):
        t = np.arange(int(2.5 * TINY_SR)) / TINY_SR
        wav = (0.4 * np.sin(2 * np.pi * (60 + 20 * i) * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        save_wav(str(root / f"{i}.wav"), wav, TINY_SR)
        rows.append(dict(audio_path=f"{i}.wav", caption=f"sound number {i}", split="val",
                         audio_length=2.5, absolute_index=10 + i, fine_tune_data=True))
    rows.append(dict(rows[0], split="train", absolute_index=20))
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return root


def _inject(monkeypatch, keys):
    keys = list(keys)

    def randn(shape, generator, device, dtype=torch.float32):
        draw = np.array(jax.random.normal(keys.pop(0), tuple(shape)))
        return torch.from_numpy(draw).to(device=device, dtype=dtype)

    monkeypatch.setattr(utils, "randn", randn)
    return keys


@pytest.mark.parametrize("mae", [False, True], ids=["plain", "mae"])
def test_eval_udit_matches_jax(pair, val_set, tmp_path, monkeypatch, mae):
    from ezaudio_tpu.training.evaluate import eval_udit as jax_eval_udit

    jez, ez = pair
    kw = dict(val_df=str(val_set / "meta.csv"), subset="val", audio_dir=str(val_set), mae=mae,
              ddim_steps=2, eta=0.0, random_seed=SEED, val_num=1)
    want = jax_eval_udit(jez, save_path=str(tmp_path / "jax"), **kw)
    latent_key = jax.random.split(jax.random.PRNGKey(SEED))[0]
    keys = _inject(monkeypatch, ([jax.random.PRNGKey(SEED)] if mae else []) + [latent_key])
    got = evaluate.eval_udit(ez, save_path=str(tmp_path / "port"), **kw)
    assert not keys, "not every JAX draw was used"
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want] == [os.path.join("0", "0.wav")]
    for g, w in zip(got, want):
        a, b = load_wav(g), load_wav(w)
        assert a.shape == b.shape == (10 * TINY_SR,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4)
    if mae:
        np.testing.assert_array_equal(load_wav(str(tmp_path / "port" / "0" / "0_gt.wav")),
                                      load_wav(str(tmp_path / "jax" / "0" / "0_gt.wav")))
    from ezaudio_tpu.training.evaluate import codec_fidelity_report as jax_fidelity

    wavs = (0.3 * np.random.default_rng(SEED).standard_normal((2, 1920))).astype(np.float32)
    got = evaluate.codec_fidelity_report(ez.autoencoder, wavs, TINY_SR)
    want = jax_fidelity(jez.autoencoder, wavs, TINY_SR)
    assert sorted(got) == sorted(want) == ["mel_distance", "si_sdr_db"]
    for k in got:
        assert np.isfinite(got[k]) and got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k


def test_prepare_embeddings_matches_jax_and_feeds_eacaps(pair, val_set, tmp_path):
    from ezaudio_tpu.training.prepare_embeddings import prepare as jax_prepare

    jez, ez = pair
    assert jax_prepare(jez, str(val_set / "meta.csv"), str(tmp_path / "jax"), "val", 2) == 3
    assert prepare_embeddings.prepare(ez, str(val_set / "meta.csv"), str(tmp_path / "port"),
                                      "val", 2) == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == [
        "10.npz", "11.npz", "12.npz", "uncond.npz"]
    for n in names:
        a, b = np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n)
        np.testing.assert_allclose(a["embedding"], b["embedding"].astype(np.float32), atol=1e-5)
        np.testing.assert_array_equal(a["mask"], b["mask"])
    data = EACaps(data_dir=str(val_set), meta_dir=str(val_set / "meta.csv"), subset="val",
                  seg_length=1, sr=TINY_SR, text_path=str(tmp_path / "port"),
                  uncond_path=str(tmp_path / "port" / "uncond.npz"))
    clip, emb, mask = data[1]
    want_emb, want_mask = ez.embed_text(["sound number 1"])
    np.testing.assert_array_equal(emb, want_emb[0].numpy())
    np.testing.assert_array_equal(mask, want_mask[0].numpy())


def test_prepare_embeddings_cli(val_set, tmp_path):
    """``python -m ezaudio_tpu_torch.training.prepare_embeddings``: a config
    file, the manifest, an output directory; seeded T5 without
    ``--t5-ckpt``."""
    import json

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CONFIG))
    n = prepare_embeddings.main(["--config-name", str(cfg), "--meta", str(val_set / "meta.csv"),
                                 "--out-dir", str(tmp_path / "emb"), "--subset", "train",
                                 "--device", "cpu"],
                                t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                                vae_config=TINY_VAE_CONFIG)
    assert n == 1 and sorted(os.listdir(tmp_path / "emb")) == ["20.npz", "uncond.npz"]
