"""CLAP reranking on the CPU: ``EzAudio.generate_audio_reranked`` against
the JAX package's on carried weights (the tiny EzAudio and the tiny CLAP
of ``tests/test_torch_clap.py``, JAX's initial latents injected, eta 0),
its selection with a stub scorer, and ``GenerationServer(clap_scorer=)``'s
``submit_reranked`` against the direct call."""

import dataclasses

import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.audio.clap import CLAPScorer
from ezaudio_tpu_torch.convert.from_jax import (clap_params_to_torch,
                                                maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax, vae_state_dict_from_jax)
from ezaudio_tpu_torch.models.clap import CLAP
from ezaudio_tpu_torch.serving import GenerationServer
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.test_torch_clap import CFG, JCFG, jclap, padded_ids, seeded_clap_params
from tests.test_torch_controlnet import _seeded_init
from tests.tiny_config import TINY_CONFIG, TINY_SR, TINY_T5, TINY_VAE_CONFIG

PROMPTS = ["a dog barking", "rain on a tin roof"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX tiny EzAudio (every leaf seeded, ``_seeded_init``) and the
    port's on its weights; the JAX and the port's ``CLAPScorer`` on one set
    of seeded CLAP weights."""
    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(21)))
        jez = JaxEzAudio(config=TINY_CONFIG, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    ez = EzAudio(config=TINY_CONFIG, vae_config=TINY_VAE_CONFIG, device="cpu",
                 t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)))
    ez.dit.load_state_dict(maskdit_state_dict_from_jax(jez.dit_params["params"],
                                                       TINY_CONFIG["model"]))
    ez.t5.load_state_dict(t5_state_dict_from_jax(jez.t5_params, TINY_T5.num_layers))
    ez.autoencoder.model.load_state_dict(vae_state_dict_from_jax(jez.autoencoder.params))
    clap = CLAP(CFG)
    clap.load_state_dict(clap_params_to_torch(seeded_clap_params(np.random.default_rng(22)),
                                              CFG))
    sd = clap.state_dict()
    return jez, ez, jclap.CLAPScorer(cfg=JCFG, weights=sd), CLAPScorer(cfg=CFG, weights=sd,
                                                                        device="cpu")


def test_reranked_matches_jax(models):
    """Two prompts, three candidates each, CFG 3 + rescale 0.75, 3 DDIM
    steps, eta 0, JAX's initial latents: the (B, K) scores within 2e-4;
    the same choice wherever JAX's top two scores are more than 2e-4 apart
    (phase 20's rule in ``chip_smoke.py``; here one prompt is, one is not),
    and then the same best waveform; every candidate within the pipeline's
    tolerance (atol 1e-4, corr > 0.9999)."""
    jez, ez, jsc, sc = models
    rng = np.random.default_rng(23)
    noise = rng.standard_normal((6, 50, 8)).astype(np.float32)
    ids = padded_ids(rng, (7, 4))
    kw = dict(n_candidates=3, text_ids=ids, return_all=True, length=1.0, guidance_scale=3.0,
              guidance_rescale=0.75, ddim_steps=3, eta=0.0, random_seed=0,
              initial_latents=noise)
    _, jbest, jall, jscores = jez.generate_audio_reranked(PROMPTS, jsc, **kw)
    sr, best, allw, scores = ez.generate_audio_reranked(PROMPTS, sc, **kw)
    assert sr == TINY_SR and scores.shape == (2, 3) and allw.shape == (2, 3, TINY_SR)
    jscores, jbest = np.asarray(jscores), np.asarray(jbest)
    np.testing.assert_allclose(scores, jscores, atol=2e-4)
    top2 = np.sort(jscores, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2e-4
    assert decided.any()
    np.testing.assert_array_equal(scores.argmax(1)[decided], jscores.argmax(1)[decided])
    np.testing.assert_allclose(best[decided], jbest[decided], atol=1e-4)
    np.testing.assert_allclose(allw, np.asarray(jall), atol=1e-4)
    assert np.corrcoef(allw.ravel(), np.asarray(jall).ravel())[0, 1] > 0.9999


class _StubScorer:
    """Duck-typed CLAPScorer (as ``tests/test_api.py``'s): 2-d unit
    embeddings from the waveform's energy and the prompt's length."""

    def __init__(self):
        self.audio_calls = self.text_calls = 0

    @staticmethod
    def _unit(v):
        return np.stack([np.cos(v), np.sin(v)], axis=-1).astype(np.float32)

    def embed_audio(self, wav, sr):
        self.audio_calls += 1
        return self._unit(np.sqrt((np.asarray(wav) ** 2).mean(axis=-1)) * 50)

    def embed_text(self, texts):
        self.text_calls += 1
        return self._unit(np.asarray([float(len(t)) for t in texts]))


def test_selects_argmax_per_prompt(models):
    """The returned waveform is each prompt's argmax candidate; the B
    prompts are embedded once and the B*K waveforms once; a fixed seed
    reproduces a single-prompt call."""
    _, ez, _, _ = models
    scorer = _StubScorer()
    sr, best, allw, scores = ez.generate_audio_reranked(
        PROMPTS, scorer, n_candidates=3, return_all=True, length=1.0, ddim_steps=3,
        random_seed=11)
    assert best.shape == (2, TINY_SR) and allw.shape == (2, 3, TINY_SR)
    assert np.abs(allw[:, 0] - allw[:, 1]).max() > 1e-6  # distinct draws
    for b in range(2):
        np.testing.assert_array_equal(best[b], allw[b, scores[b].argmax()])
    assert scorer.text_calls == 1 and scorer.audio_calls == 1
    kw = dict(n_candidates=2, length=1.0, ddim_steps=3, random_seed=5)
    _, b1 = ez.generate_audio_reranked("rain", scorer, **kw)
    _, b2 = ez.generate_audio_reranked("rain", scorer, **kw)
    assert b1.shape == (TINY_SR,)
    np.testing.assert_array_equal(b1, b2)
    with pytest.raises(ValueError, match="n_candidates"):
        ez.generate_audio_reranked("rain", scorer, n_candidates=0)


def test_served_rerank_equals_direct(models):
    """``submit_reranked`` on a server whose recipe has ``fused=True``: the
    rerank runs staged (no fused program made) and equals the direct call
    at its seed and length; a plain request on the same server still takes
    the fused program; one rerank request counted."""
    _, ez, _, sc = models
    ids = padded_ids(np.random.default_rng(24), (6,))
    recipe = dict(length=1.0, ddim_steps=3, sampler="dpm")
    ez._fused.clear()
    with GenerationServer(ez, clap_scorer=sc, max_batch_size=2, max_wait_ms=10, fused=True,
                          **recipe) as srv:
        sr, wav = srv.submit_reranked(PROMPTS[0], n_candidates=2, seed=5,
                                      text_ids=ids).result(timeout=120)
        assert not ez._fused
        srv.submit(PROMPTS[1], seed=6).result(timeout=120)
        assert len(ez._fused) == 1
    _, direct = ez.generate_audio_reranked(PROMPTS[0], sc, n_candidates=2, text_ids=ids,
                                           random_seed=5, **recipe)
    assert sr == TINY_SR and wav.shape == (TINY_SR,)
    np.testing.assert_allclose(wav, direct, atol=1e-6)
    assert srv.stats["rerank_requests"] == 1 and srv.stats["requests"] == 2
