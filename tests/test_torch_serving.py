"""The port's micro-batching ``GenerationServer`` (``ezaudio_tpu_torch/serving.py``):
every test of ``tests/test_serving.py`` on the port, with the same fake
backends and the port's tiny ``EzAudio(device="cpu")``, except the served
ControlNet request, which ``tests/test_torch_controlnet.py`` holds against
the direct call (as ``tests/test_torch_rerank.py`` holds a served rerank);
plus served == solo for a (text, seed, length bucket) and a served
``fused=True`` request."""

import concurrent.futures
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.serving import GenerationServer
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG


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


class FakeEz:
    """Deterministic stand-in: the waveform encodes the prompt's hash."""

    def __init__(self, delay=0.01):
        self.delay = delay
        self.calls = []
        self.lock = threading.Lock()

    def generate_audio(self, texts, random_seed=None, **kw):
        with self.lock:
            self.calls.append(list(texts))
        time.sleep(self.delay)
        wavs = np.stack([np.full(16, float(hash(t) % 1000)) for t in texts])
        return 24000, wavs


class TestGenerationServer:
    def test_single_request(self):
        with GenerationServer(FakeEz(), max_batch_size=4, max_wait_ms=10) as srv:
            sr, wav = srv.generate("hello", seed=1, timeout=10)
        assert sr == 24000 and wav.shape == (16,)
        assert wav[0] == float(hash("hello") % 1000)

    def test_batching_aggregates(self):
        ez = FakeEz(delay=0.05)
        with GenerationServer(ez, max_batch_size=4, max_wait_ms=200) as srv:
            futs = [srv.submit(f"p{i}", seed=i) for i in range(4)]
            results = [f.result(timeout=10) for f in futs]
        assert any(sum(1 for t in c if t) >= 2 for c in ez.calls)
        for i, (sr, wav) in enumerate(results):
            assert wav.shape == (16,) and wav[0] == float(hash(f"p{i}") % 1000)

    def test_bucket_padding(self):
        ez = FakeEz()
        with GenerationServer(ez, max_batch_size=8, max_wait_ms=100,
                              batch_buckets=[4, 8]) as srv:
            [f.result(timeout=10) for f in [srv.submit(f"x{i}") for i in range(3)]]
        assert any(len(c) == 4 for c in ez.calls)  # 3 requests pad into a 4-bucket

    def test_error_propagates(self):
        class Broken:
            def generate_audio(self, *a, **k):
                raise RuntimeError("boom")

        with GenerationServer(Broken(), max_wait_ms=10) as srv:
            fut = srv.submit("x")
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=10)


class TestServerRecipePassthrough:
    def test_fast_recipe_kwargs_reach_generate(self):
        seen = {}

        class Spy(FakeEz):
            def generate_audio(self, texts, random_seed=None, **kw):
                seen.update(kw)
                return super().generate_audio(texts, random_seed=random_seed)

        with GenerationServer(Spy(), max_batch_size=2, max_wait_ms=10, ddim_steps=25,
                              sampler="dpm", guidance_interval=(300, 800),
                              layer_cache=(2, 2), quant="int8", fused=True) as srv:
            srv.generate("hello", seed=1, timeout=10)
        assert seen["sampler"] == "dpm" and seen["ddim_steps"] == 25
        assert seen["layer_cache"] == (2, 2) and seen["quant"] == "int8"
        assert seen["guidance_interval"] == (300, 800) and seen["fused"] is True

    def test_distilled_rejects_schedule_knobs_at_construction(self):
        with pytest.raises(ValueError, match="distilled"):
            GenerationServer(FakeEz(), sampler="distilled", guidance_interval=(300, 800))
        with pytest.raises(ValueError, match="distilled"):
            GenerationServer(FakeEz(), sampler="distilled", layer_cache=(2, 2))

    def test_real_pipeline_fast_recipe(self, ez):
        with GenerationServer(ez, max_batch_size=2, max_wait_ms=50, length=2.0,
                              ddim_steps=8, sampler="dpm", guidance_interval=(300, 800),
                              layer_cache=(1, 2)) as srv:
            futs = [srv.submit(p, seed=i) for i, p in enumerate(["rain", "a dog"])]
            outs = [f.result(timeout=300) for f in futs]
        for sr, wav in outs:
            assert np.isfinite(wav).all() and wav.shape == (2 * sr,)


class TestServingReviewFixes:
    def test_pads_never_empty_string(self):
        ez = FakeEz()
        with GenerationServer(ez, max_batch_size=8, max_wait_ms=100,
                              batch_buckets=[4, 8]) as srv:
            [f.result(timeout=10) for f in [srv.submit(f"x{i}") for i in range(3)]]
        assert all(all(t != "" for t in c) for c in ez.calls)

    def test_bucket_covers_max_batch_size(self):
        ez = FakeEz(delay=0.05)
        with GenerationServer(ez, max_batch_size=3, max_wait_ms=300) as srv:
            res = [f.result(timeout=10) for f in [srv.submit(f"p{i}") for i in range(3)]]
        assert len(res) == 3 and 3 in srv.buckets
        assert all(len(c) <= 3 for c in ez.calls)

    def test_stop_cancels_queued_requests(self):
        srv = GenerationServer(FakeEz(delay=0.2), max_batch_size=1, max_wait_ms=5).start()
        futs = [srv.submit(f"q{i}") for i in range(20)]
        srv.stop()
        assert not srv._thread.is_alive()
        for f in futs:  # every future resolves one way or another
            try:
                f.result(timeout=5)
            except concurrent.futures.CancelledError:
                pass
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError, match="stopped"):
            srv.submit("late")

    def test_per_request_seed_reproducible_across_batches(self, ez):
        """A (text, seed) pair reproduces whatever its batch (DPM is
        deterministic; atol 1e-4 as the JAX test, for batch-size sums)."""
        kw = dict(length=2.0, ddim_steps=6, sampler="dpm", max_wait_ms=200)
        with GenerationServer(ez, max_batch_size=2, **kw) as srv:
            f1 = srv.submit("rain", seed=5)
            srv.submit("a dog", seed=9)
            _, wav_batched = f1.result(timeout=600)
        with GenerationServer(ez, max_batch_size=1, **kw) as srv:
            _, wav_solo = srv.generate("rain", seed=5, timeout=600)
        np.testing.assert_allclose(wav_batched, wav_solo, atol=1e-4)


class TestHeterogeneousServing:
    def test_mixed_lengths_grouped_by_bucket(self):
        class LenSpy(FakeEz):
            def generate_audio(self, texts, random_seed=None, length=None, **kw):
                with self.lock:
                    self.calls.append((length, list(texts)))
                time.sleep(self.delay)
                return 24000, np.stack([np.zeros(int(length * 24000)) for _ in texts])

        ez = LenSpy(delay=0.05)
        with GenerationServer(ez, max_batch_size=8, max_wait_ms=300, length=10.0,
                              length_buckets=[5.0, 10.0]) as srv:
            f5 = [srv.submit(f"s{i}", seed=i, length=4.0) for i in range(2)]
            f10 = [srv.submit(f"l{i}", seed=i, length=10.0) for i in range(2)]
            for f in f5:
                sr, w = f.result(timeout=30)
                assert w.shape == (int(4.0 * sr),)  # trimmed to the request
            for f in f10:
                sr, w = f.result(timeout=30)
                assert w.shape == (int(10.0 * sr),)
        assert {c[0] for c in ez.calls} == {5.0, 10.0}, ez.calls  # 4 s rounds up to 5 s

    def test_mixed_length_seed_reproducible_across_compositions(self, ez):
        kw = dict(length=2.0, length_buckets=[1.0, 2.0], ddim_steps=6, sampler="dpm",
                  max_wait_ms=300)
        with GenerationServer(ez, max_batch_size=4, **kw) as srv:
            fa = srv.submit("rain", seed=5, length=1.0)
            fb = srv.submit("a dog", seed=9, length=2.0)
            fc = srv.submit("wind", seed=2, length=1.0)
            _, wav_mixed = fa.result(timeout=600)
            fb.result(timeout=600), fc.result(timeout=600)
        with GenerationServer(ez, max_batch_size=1, **kw) as srv:
            _, wav_solo = srv.generate("rain", seed=5, timeout=600, length=1.0)
        np.testing.assert_allclose(wav_mixed, wav_solo, atol=1e-4)

    def test_served_editing_path(self, ez):
        _, base = ez.generate_audio("base", length=2, ddim_steps=4, random_seed=3)
        with GenerationServer(ez, max_batch_size=4, max_wait_ms=200, length=2.0,
                              ddim_steps=4) as srv:
            fe = srv.submit_edit("edit", gt_file=base, boundary=0.25, mask_start=0.5,
                                 mask_length=0.5, seed=7)
            fg = srv.submit("generate too", seed=1)
            sr, edited = fe.result(timeout=600)
            _, gen = fg.result(timeout=600)
        assert edited.shape == base.shape
        assert np.isfinite(edited).all() and np.isfinite(gen).all()
        _, direct = ez.editing_audio("edit", boundary=0.25, gt_file=base, mask_start=0.5,
                                     mask_length=0.5, ddim_steps=4, random_seed=7)
        np.testing.assert_allclose(edited, direct, atol=1e-5)
        assert srv.stats["edit_requests"] == 1

    def test_controlnet_is_not_ported(self):
        """ControlNet requests are served now (tests/test_torch_controlnet.py);
        a server built without ``controlnet=`` still refuses them."""
        with GenerationServer(FakeEz(), max_batch_size=1) as srv:
            with pytest.raises(ValueError, match="controlnet"):
                srv.submit_controlnet("x", np.zeros(16, np.float32))
        assert srv.stats["controlnet_requests"] == 0


class TestServedRerank:
    def test_reranking_is_not_ported(self):
        """Reranking is served now: a server built with ``clap_scorer=``
        accepts ``submit_reranked`` and passes the request's candidates,
        seed and length to ``generate_audio_reranked`` (``test_serving.py``'s
        ``test_served_rerank_path``)."""
        class RerankEz(FakeEz):
            def generate_audio_reranked(self, text, scorer, n_candidates=4,
                                        random_seed=None, length=None, **kw):
                with self.lock:
                    self.calls.append(("rerank", text, scorer, n_candidates, random_seed,
                                       length, kw["fused"] if "fused" in kw else None))
                return 24000, np.full(16, float(n_candidates))

        ez, scorer = RerankEz(), object()
        with GenerationServer(ez, max_wait_ms=10, clap_scorer=scorer, fused=True) as srv:
            sr, wav = srv.submit_reranked("rain", n_candidates=3, seed=7,
                                          length=2.0).result(timeout=10)
        assert sr == 24000 and wav[0] == 3.0
        assert ez.calls[-1] == ("rerank", "rain", scorer, 3, 7, 2.0, None)  # fused dropped
        assert srv.stats["rerank_requests"] == 1

    def test_rerank_requires_scorer(self):
        with GenerationServer(FakeEz(), max_wait_ms=10) as srv:
            with pytest.raises(ValueError, match="clap_scorer"):
                srv.submit_reranked("x")


class TestServedAgainstSolo:
    def test_served_equals_solo_call(self, ez):
        """A served request and a solo ``generate_audio`` of the same
        (text, seed, length bucket): the slot's noise is the solo call's
        draw, so DPM gives the same waveform up to batch-size sums (atol
        1e-4); a bucket pad slot does not change it."""
        with GenerationServer(ez, max_batch_size=4, max_wait_ms=200, length=2.0,
                              length_buckets=[1.0, 2.0], ddim_steps=6,
                              sampler="dpm") as srv:
            futs = [srv.submit(t, seed=s, length=0.8)
                    for t, s in (("rain", 5), ("a dog", 9), ("wind", 2))]
            served = [f.result(timeout=600)[1] for f in futs]
            assert srv.stats["padded_slots"] >= 1 and srv.stats["batches"] < 3
        for (t, s), wav in zip((("rain", 5), ("a dog", 9), ("wind", 2)), served):
            _, solo = ez.generate_audio(t, length=1.0, ddim_steps=6, sampler="dpm",
                                        random_seed=s)
            assert wav.shape == (int(0.8 * 800),)
            np.testing.assert_allclose(wav, solo[: wav.shape[0]], atol=1e-4)

    def test_served_fused_request(self, ez):
        """``fused=True`` on the server: the fused program, with the slots'
        noise as initial latents, equals the staged served call (DDIM at
        eta 1, whose step draws follow the first request's seed: a solo
        call, which draws its initial latents from that generator first,
        is another sample)."""
        kw = dict(max_batch_size=2, max_wait_ms=10, length=1.0, ddim_steps=3)
        with GenerationServer(ez, fused=True, **kw) as srv:
            _, wf = srv.generate("rain", seed=4, timeout=600)
        with GenerationServer(ez, **kw) as srv:
            _, wu = srv.generate("rain", seed=4, timeout=600)
        np.testing.assert_array_equal(wf, wu)
