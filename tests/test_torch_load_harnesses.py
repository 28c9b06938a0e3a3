"""The load harnesses on the CPU (``validation/{serving_bench,fused_ab}.py``,
the counterparts of ``scripts/serving_bench.py`` and ``scripts/fused_ab.py``),
each through its ``main`` with the tiny ``EzAudio`` in place of the scripts'
s3_xl: a 2 s window at one rate and batches of up to 2, fused against staged
at 2 steps and batch 2.  On the CPU a fused call runs the staged program
eagerly, so its waveform equals the staged one bit for bit, as on the card
(``tests/test_torch_fused.py``); the timings are the CPU's and checked for
sign only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from ezaudio_tpu_torch.validation import fused_ab as fab
from ezaudio_tpu_torch.validation import serving_bench as sb
from tests.tiny_config import TINY_CONFIG, TINY_SR, TINY_T5, TINY_VAE_CONFIG

# the tiny model's 2 s clips (its 100 latent frames), 2 steps; depth 6, so
# that the fast recipe's layer_cache=(2, 2) has its 2 blocks a side
CUT = ["--length", "2", "--steps", "2", "--device", "cpu"]
CONFIG = dict(TINY_CONFIG, model=dict(TINY_CONFIG["model"], depth=6))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ez():
    return EzAudio(config=CONFIG, vae_config=TINY_VAE_CONFIG,
                   t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)), device="cpu")


@pytest.mark.parametrize("mixed", [False, True], ids=["one_length", "mixed"])
def test_serving_bench_serves_every_request(ez, mixed, capsys):
    rows = sb.main(["4", "--seconds", "2", "--max-batch", "2", *CUT]
                   + (["--mixed"] if mixed else []), ez=ez)
    out = capsys.readouterr().out
    assert len(rows) == 1
    r = rows[0]
    assert r["recipe"] == "fast" and r["mixed"] == mixed and r["offered_rps"] == 4.0
    assert r["sent"] > 1 and r["served"] == r["sent"]
    assert 0 < r["slot_fill"] <= 1 and r["batches"] >= 1
    assert 0 < r["p50_s"] <= r["p99_s"]
    lengths = [1.0, 2.0] if mixed else [2.0]
    assert sorted(r["per_length"]) == lengths
    assert sum(s["n"] for s in r["per_length"].values()) == r["served"]
    assert r["audio_s_per_s"] == pytest.approx(
        sum(L * s["n"] for L, s in r["per_length"].items()) / 2.0)
    assert "warming batch buckets [1, 2]" in out and "[fast" in out
    assert ("/mixed]" in out) == mixed and ("1s: p50" in out) == mixed


def test_serving_bench_ab_runs_staged_then_fused(ez):
    rows = sb.main(["4", "--seconds", "1", "--max-batch", "2", "--recipe", "default", "--ab",
                    *CUT], ez=ez)
    assert [r["recipe"] for r in rows] == ["default", "default/fused"]
    assert all(r["served"] == r["sent"] > 0 for r in rows)


def test_serving_bench_raises_when_a_request_fails(ez, monkeypatch):
    """A request the server fails (here: every call after the warm-up)
    makes ``main`` raise, so no run exits with requests lost."""
    warm = sb.warm

    def warm_then_break(ez_, server, lengths, kw):
        calls = warm(ez_, server, lengths, kw)

        def broken(*a, **k):
            raise RuntimeError("the card fell over")

        monkeypatch.setattr(ez_, "generate_audio", broken)
        return calls

    monkeypatch.setattr(sb, "warm", warm_then_break)
    with pytest.raises(RuntimeError, match="fell over"):
        sb.main(["4", "--seconds", "1", "--max-batch", "2", *CUT], ez=ez)


def test_fused_ab_rows_and_equal_waveforms(ez, capsys):
    rows = fab.main(["--batch", "2", *CUT], ez=ez)
    out = capsys.readouterr().out
    assert [r["recipe"] for r in rows] == ["fast+gi recipe", "reference recipe"]
    for r in rows:
        assert r["batch"] == 2 and r["steps"] == 2 and r["max_abs_err"] == 0.0
        assert r["wav_shape"] == [2, 2 * TINY_SR]
        assert r["staged_ms"] > 0 and r["fused_ms"] > 0
        assert r["fused_delta"] == pytest.approx(r["staged_ms"] / r["fused_ms"] - 1)
    assert out.count("fused delta") == 2 and "[reference recipe, FUSED]" in out


def test_fused_ab_raises_when_fused_differs(ez, monkeypatch):
    real = ez.generate_audio

    def shifted(*a, fused=False, **k):
        sr, w = real(*a, fused=fused, **k)
        return sr, (w + np.float32(1e-3) if fused else w)

    monkeypatch.setattr(ez, "generate_audio", shifted)
    with pytest.raises(AssertionError, match="differs from the staged"):
        fab.main(["--batch", "2", *CUT], ez=ez)


def test_both_run_on_the_card_unless_asked(monkeypatch):
    """Without ``--device`` the scripts' model is built on CUDA, which
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    for mod in (sb, fab):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])


def test_load_phase_rehearses_on_cpu(ez, monkeypatch):
    """Phase 36 of ``chip_smoke.py`` on the tiny model with the kernels'
    plain twins counted as launches: every staged and (here eager) fused
    call launches what its recipe and batch imply, the fast recipe's
    ``chunked_bf16`` none of kernel 1, every request is served, and fused
    equals staged."""
    import chip_smoke as cs
    from tests.test_torch_chip_smoke import _counted_kernels

    _counted_kernels(monkeypatch)
    # 1 s and 2 s requests: self-attention over 50 and 100 frames, cross to
    # the T5's 12 padded tokens; 4 heads of 16
    cases = [(2, 4, L, Lk, 16, m) for L in (50, 100) for Lk, m in ((L, False), (12, True))]
    rows = cs.load_harness_paths("cpu", ez=ez, steps=2, length=2.0, rate=4.0, window=1.0,
                                 max_batch=2, ab_batch=2, attn_cases=cases)
    served, ab = rows
    assert served["path"] == "load_served" and served["served"] == served["sent"] > 0
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_call = cs.want_attention(depth, 2)
    units = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    # the warm-up's 2 buckets x 2 lengths, then the window's batches, each a
    # DDIM-2 call of up to 2 clips (one decode chunk)
    calls = 4 + served["batches"]
    assert served["calls"] == calls
    assert [served["attention_launches"], served["resunit_launches"]] == [per_call * calls,
                                                                          units * calls]
    # fused_ab: per recipe 6 staged and 6 fused calls (eager here); the fast
    # recipe's attention is plain torch
    assert ab["calls"] == 24
    assert [ab["attention_launches"], ab["resunit_launches"]] == [12 * per_call, 24 * units]
    assert [r["max_abs_err"] for r in ab["recipes"]] == [0.0, 0.0]
    with pytest.raises(AssertionError, match="attention shapes not in phase 3"):
        cs.load_harness_paths("cpu", ez=ez, steps=2, length=2.0, rate=4.0, window=0.5,
                              max_batch=2, ab_batch=2, attn_cases=cases[:2])


@pytest.mark.parametrize("kw,batch,want", [
    (dict(ddim_steps=100), 8, (2 * 29 * 100, 24)),
    (sb.RECIPES["fast"], 4, (0, 12)),
    (dict(fab.REF, ddim_steps=5), 2, (2 * 29 * 5, 12)),
    (dict(ddim_steps=5, layer_cache=(2, 2)), 1, (2 * (3 * 29 + 2 * 2 * 2), 12)),
])
def test_load_call_launches(kw, batch, want):
    """s3_xl (depth 28): a call's launches by recipe and batch."""
    import chip_smoke as cs

    assert cs.load_call_launches(28, 12, batch, kw) == want
