"""The port's debug helpers and demo CLIs on the CPU.

``debug.py`` against the JAX package's contract: ``assert_tree_finite``
names the bad leaves, ``finite_guard`` is all-or-nothing, and
``enable_nan_checks`` raises at the first op with a non-finite output.  The
demos at tiny configs: the wav each writes equals the direct call's
output exactly (the same model, seed and recipe; ``save_wav`` writes f32).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch import debug, demo
from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.tiny_config import TINY_CONFIG, TINY_SR, TINY_T5, TINY_VAE_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_T5 = T5EncoderConfig(**dataclasses.asdict(TINY_T5))
CN_CONFIG = dict(TINY_CONFIG,
                 controlnet=dict(cond_in=1, cond_blocks=[8, 16], cond_mask=True,
                                 cond_mask_prob=0.25, cond_mask_ratio=[0.25, 0.5],
                                 cond_mask_span=4),
                 conditioner=dict(condition_type="energy", hop_size=8, window_size=64,
                                  padding="reflect", min_db=-60, norm=True))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_assert_tree_finite_names_the_bad_leaves():
    good = {"a": torch.ones(3), "b": [np.zeros(2), {"c": torch.tensor(1.5)}], "n": None,
            "i": torch.arange(3)}
    debug.assert_tree_finite(good)
    bad = {"a": torch.ones(3), "b": [np.array([0.0, np.inf]), {"c": torch.tensor(np.nan)}]}
    with pytest.raises(FloatingPointError, match=r"grads: \['b/0', 'b/1/c'\]"):
        debug.assert_tree_finite(bad, "grads")
    lin = torch.nn.Linear(2, 2)
    debug.assert_tree_finite(lin)
    debug.assert_tree_finite(lin.state_dict())
    with torch.no_grad():
        lin.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="bias"):
        debug.assert_tree_finite(lin, "model")


def test_finite_guard_is_all_or_nothing():
    ups = {"w": torch.tensor([1.0, -2.0]), "b": [torch.tensor(3.0)]}
    out, bad = debug.finite_guard(ups)
    assert not bool(bad) and torch.equal(out["w"], ups["w"]) and torch.equal(out["b"][0],
                                                                            ups["b"][0])
    ups["b"][0] = torch.tensor(float("inf"))
    out, bad = debug.finite_guard(ups)
    assert bool(bad) and bad.shape == () and out["w"].eq(0).all() and out["b"][0] == 0
    fb = {"w": torch.full((2,), 7.0), "b": [torch.tensor(8.0)]}
    out, bad = debug.finite_guard(ups, fallback=fb)
    assert bool(bad) and torch.equal(out["w"], fb["w"]) and out["b"][0] == 8.0


def test_enable_nan_checks_raises_at_the_op():
    debug.enable_nan_checks()
    try:
        assert torch.log(torch.tensor(2.0)) > 0
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
        with pytest.raises(FloatingPointError, match="div"):
            torch.ones(2) / torch.zeros(2)
        debug.enable_nan_checks()  # on twice: still one mode
    finally:
        debug.enable_nan_checks(False)
    assert torch.log(torch.tensor(-1.0)).isnan()
    debug.enable_nan_checks(False)  # off twice: nothing to undo


@pytest.mark.parametrize("sub", ["t2a", "controlnet"])
def test_demo_help(sub):
    out = subprocess.run([sys.executable, "-m", "ezaudio_tpu_torch.demo", sub, "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--out" in out.stdout
    assert ("--fast" in out.stdout) == (sub == "t2a")
    assert ("--ref" in out.stdout) == (sub == "controlnet")


def test_t2a_demo_writes_the_direct_call(tmp_path):
    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    out = str(tmp_path / "t2a.wav")
    argv = ["t2a", "--prompt", "a bell", "--out", out, "--length", "1", "--steps", "3",
            "--seed", "4", "--device", "cpu"]
    assert demo.main(argv, config=TINY_CONFIG, t5_config=PORT_T5,
                     vae_config=TINY_VAE_CONFIG) == out
    ez = EzAudio(config=TINY_CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
                 device="cpu")
    sr, want = ez.generate_audio("a bell", length=1, ddim_steps=3, random_seed=4)
    got = load_wav(out)
    assert sr == TINY_SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_controlnet_demo_writes_the_direct_call(tmp_path):
    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet

    ref = str(tmp_path / "ref.wav")
    t = np.arange(2 * TINY_SR) / TINY_SR
    save_wav(ref, (0.5 * np.sin(2 * np.pi * 50 * t) * (t % 0.5 < 0.25)).astype(np.float32),
             TINY_SR)
    out = str(tmp_path / "cn.wav")
    argv = ["controlnet", "--prompt", "a drum", "--ref", ref, "--out", out, "--steps", "2",
            "--seed", "3", "--conditioning-scale", "0.8", "--device", "cpu"]
    demo.main(argv, config=CN_CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG)
    cn = EzAudioControlNet(config=CN_CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
                           device="cpu")
    sr, want = cn.generate_audio("a drum", ref, ddim_steps=2, random_seed=3,
                                 conditioning_scale=0.8)
    np.testing.assert_array_equal(load_wav(out), want)


def test_fast_recipe_and_the_default_device(monkeypatch, tmp_path):
    """``--fast`` passes the t2a script's recipe (steps capped by
    ``--steps``); without ``--device`` and without a GPU the demo raises."""
    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    seen = {}

    def fake(self, text, **kw):
        seen.update(kw)
        return self.sr, np.zeros(8, np.float32)

    monkeypatch.setattr(EzAudio, "generate_audio", fake)
    demo.main(["t2a", "--fast", "--steps", "10", "--out", str(tmp_path / "f.wav"),
               "--device", "cpu"], config=TINY_CONFIG, t5_config=PORT_T5,
              vae_config=TINY_VAE_CONFIG)
    assert seen == dict(length=10.0, guidance_scale=5.0, guidance_rescale=0.75, random_seed=0,
                        sampler="dpm", ddim_steps=10, layer_cache=(2, 2),
                        attn_impl="chunked_bf16", quant="int8", cfg_refresh=2)
    assert demo.fast_recipe(100)["ddim_steps"] == 25
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main(["t2a", "--out", str(tmp_path / "g.wav")], config=TINY_CONFIG,
                      t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG)
