"""``generate_audio(fused=True)`` on the port's tiny ``EzAudio`` on the CPU:
the tests of ``tests/test_api.py::TestFusedPath`` (fused equals staged for
every recipe knob, the chunked decode, the distilled sampler, initial
latents with int8), and the program cache.  On the CPU the fused program
runs the same function eagerly (``api/graphs.py``), so fused and staged are
bit-equal; the JAX package's fused program is held to its staged path by
its own tests, and the port's staged path to JAX's by
``tests/test_torch_pipeline.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import ezaudio_tpu_torch.ops.quant as qm
from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.tiny_config import (TINY_CONFIG, TINY_LATENT_SR, TINY_SR, TINY_T5,
                               TINY_VAE_CONFIG)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ez():
    return EzAudio(config=TINY_CONFIG, vae_config=TINY_VAE_CONFIG,
                   t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)), device="cpu")


RECIPES = [
    dict(ddim_steps=4, random_seed=3),                       # ddim + CFG, eta 1
    dict(ddim_steps=4, random_seed=3, sampler="dpm", layer_cache=(1, 2)),
    dict(ddim_steps=3, random_seed=5, guidance_scale=None),  # CFG off
    dict(ddim_steps=3, random_seed=5, guidance_interval=(100, 900)),
    dict(ddim_steps=8, random_seed=5, sampler="dpm", layer_cache=(1, 2),
         guidance_interval=(300, 800)),
    dict(ddim_steps=6, random_seed=2, sampler="dpm", cfg_refresh=2),
    dict(ddim_steps=4, random_seed=4, layer_cache=(1, 2)),  # cached DDIM, eta 1
]


@pytest.mark.parametrize("kw", RECIPES, ids=[str(sorted(r.items())) for r in RECIPES])
def test_fused_equals_staged(ez, kw):
    """Bit-equal (the JAX package allows 2e-6 with a guidance band; the
    port's program runs the staged ops in the staged order)."""
    _, wf = ez.generate_audio(["rain", "a dog"], length=2, fused=True, **kw)
    _, wu = ez.generate_audio(["rain", "a dog"], length=2, fused=False, **kw)
    assert wf.shape == (2, 2 * TINY_SR)
    np.testing.assert_array_equal(wf, wu)


def test_fused_chunked_decode(ez):
    """Six prompts: the program decodes in chunks of 4 and 2."""
    texts = [f"p{i}" for i in range(6)]
    kw = dict(length=2, ddim_steps=3, random_seed=2)
    _, wf = ez.generate_audio(texts, fused=True, **kw)
    _, wu = ez.generate_audio(texts, fused=False, **kw)
    assert wf.shape == (6, 2 * TINY_SR)
    np.testing.assert_array_equal(wf, wu)


def test_distilled_sampler_fused(ez):
    kw = dict(length=2, ddim_steps=4, sampler="distilled", random_seed=3)
    _, w = ez.generate_audio(["rain", "a dog"], **kw)
    assert w.shape == (2, 2 * TINY_SR) and np.isfinite(w).all()
    _, wf = ez.generate_audio(["rain", "a dog"], fused=True, **kw)
    np.testing.assert_array_equal(wf, w)
    _, wd = ez.generate_audio(["rain", "a dog"], length=2, ddim_steps=4, random_seed=3,
                              fused=True)
    assert np.abs(wd - w).max() > 1e-6  # another grid and no CFG: not the DDIM output
    with pytest.raises(ValueError, match="distilled"):
        ez.generate_audio("x", length=2, ddim_steps=4, sampler="distilled",
                          layer_cache=(1, 2), fused=True)


def test_fused_initial_latents_and_int8(ez, monkeypatch):
    lat = np.random.default_rng(0).standard_normal(
        (2, 2 * TINY_LATENT_SR, ez.latent_dim)).astype(np.float32)
    kw = dict(length=2, ddim_steps=3, random_seed=1, initial_latents=lat)
    monkeypatch.setattr(qm, "MIN_QUANT_ELEMENTS", 0)
    try:
        _, wf = ez.generate_audio(["a", "b"], fused=True, quant="int8", **kw)
        _, wu = ez.generate_audio(["a", "b"], fused=False, quant="int8", **kw)
        _, w32 = ez.generate_audio(["a", "b"], fused=True, **kw)
    finally:
        ez._fused.clear()  # programs made under the patched threshold
    np.testing.assert_array_equal(wf, wu)
    assert np.abs(wf - w32).max() > 0  # the int8 route ran


def test_fused_draws_what_the_staged_path_draws(ez, monkeypatch):
    """Every draw goes through ``utils.randn`` in the staged order (initial
    latents, then one per DDIM step), so injected draws reach both paths
    alike: here the i-th draw of a call is a ramp scaled by i."""
    calls = []

    def numbered(shape, generator, device, dtype=torch.float32):
        calls.append(tuple(shape))
        ramp = torch.linspace(-1, 1, int(np.prod(shape)), dtype=dtype, device=device)
        return ramp.reshape(shape) * (len(calls) % 4 + 1)

    monkeypatch.setattr(utils, "randn", numbered)
    kw = dict(length=1, ddim_steps=3, random_seed=9)
    _, wf = ez.generate_audio("rain", fused=True, **kw)
    n = len(calls)
    _, wu = ez.generate_audio("rain", **kw)
    assert n == len(calls) - n == 4 and calls[:n] == calls[n:]
    np.testing.assert_array_equal(wf, wu)


def test_program_cache(ez, monkeypatch):
    """One program per signature, reused; the least recently used dropped
    past the bound."""
    import ezaudio_tpu_torch.api.ezaudio as api

    monkeypatch.setattr(api, "FUSED_CACHE", 2)
    ez._fused.clear()
    kw = dict(length=1, ddim_steps=2, random_seed=0, fused=True)
    ez.generate_audio("a", **kw)
    ez.generate_audio("b", **kw)  # same signature
    assert len(ez._fused) == 1
    first = next(iter(ez._fused))
    ez.generate_audio(["a", "b"], **kw)
    ez.generate_audio("a", eta=0.0, **{k: v for k, v in kw.items()})
    assert len(ez._fused) == 2 and first not in ez._fused
    assert all(p.graph is None for p in ez._fused.values())  # no graphs on the CPU


@pytest.mark.parametrize("path", ["staged", "fused", "controlnet"])
def test_del_frees_the_model_without_gc(path):
    """ROADMAP F8: with the garbage collector off, ``del`` of a used
    ``EzAudio`` (staged, or fused: its programs hold it only weakly) or of a
    used ``EzAudioControlNet`` frees it and its weights at once."""
    import gc
    import weakref

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from tests.test_torch_controlnet import CONFIG, PORT_T5

    gc.collect()
    gc.disable()
    try:
        kw = dict(vae_config=TINY_VAE_CONFIG, t5_config=PORT_T5, device="cpu")
        if path == "controlnet":
            model = EzAudioControlNet(config=CONFIG, **kw)
            base = model.base
            model.generate_audio("rain", np.zeros(TINY_SR, np.float32), sampler="dpm",
                                 ddim_steps=2, random_seed=1)
        else:
            model = base = EzAudio(config=TINY_CONFIG, **kw)
            model.generate_audio("rain", length=0.5, ddim_steps=2, random_seed=1,
                                 fused=path == "fused")
            assert bool(model._fused) == (path == "fused")
        refs = [weakref.ref(x) for x in (model, base, base.dit, base.dit.model.time_ada.weight)]
        del model, base
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
