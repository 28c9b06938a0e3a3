"""``chip_smoke.py`` without a GPU: it must refuse (non-zero exit, no
result line), and its phases must run end to end at a tiny size on the CPU,
with the kernels' plain versions standing in and counted as launches."""

import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def counted(plain, wrapper):
    """``plain`` counted as a launch of ``wrapper``'s kernel, by dtype, as
    the wrapper counts one on the card."""
    from ezaudio_tpu_torch.ops.kernels import _build

    def run(*a, **k):
        _build.count(wrapper, a[0].dtype)
        return plain(*a, **k)
    return run


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_cuda_or_the_port(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("this host has a GPU: chip_smoke.py would run")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = tmp_path
    out = _run(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_mma_rate_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: mma_rate.py would run")
    out = subprocess.run([sys.executable, "mma_rate.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "tflops" not in out.stdout


def test_phases_rehearse_on_cpu(monkeypatch):
    import chip_smoke as cs
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr
    from ezaudio_tpu_torch.config import get_model_config

    def time_cpu(fn, reps=1, iters=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(cs, "time_ms", time_cpu)
    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    gen = torch.Generator().manual_seed(0)
    rows = cs.check_attention("cpu", gen, [(1, 2, 20, 20, 64, False), (2, 2, 20, 9, 72, True)])
    assert len(rows) == 4 and all(r["max_abs_err"] == 0.0 for r in rows)
    rows = cs.check_resunit("cpu", gen, [(1, 100, 128, 9), (2, 37, 128, 1)])
    assert all(r["max_abs_err"] == 0.0 for r in rows)

    cfg = get_model_config("s3_l").to_dict()
    cfg["model"].update(embed_dim=32, depth=6, num_heads=4, context_dim=16,
                        ada_sola_rank=2, ada_sola_alpha=2)
    cfg["text_encoder"]["model"] = "tiny"
    ez = cs.build_ezaudio("cpu", config=cfg)
    rows = cs.main_path(ez, length=0.1)
    assert [r["attention_launches"] for r in rows] == [1400, 1400]
    assert [r["resunit_launches"] for r in rows] == [12, 12]
    row = cs.card_vs_cpu(gen, dev="cpu", cfg=cfg)
    assert row["max_abs_err"] == 0.0 and row["attention_launches"] == 42

    # every path's launches are checked inside run_path; pin the counts here
    rows = cs.edit_paths(ez, length=0.1, long_steps=4) + cs.sampler_paths(ez, length=0.1)
    counts = {r["path"]: [r["attention_launches"], r["resunit_launches"]] for r in rows}
    assert counts == {"editing": [1400, 24], "long": [168, 60], "dpm": [350, 12],
                      "dpm_cache_band_refresh": [278, 12], "ddim_cache": [1100, 12],
                      "distilled": [112, 12]}
    assert rows[0]["wav_shape"] == [2400] and rows[1]["wav_shape"] == [4800]
    # the edit's boundary is clamped to half its mask: a 0.06 s window, which
    # the encoder and the decoder give the kernel at 1440 samples
    assert rows[0]["audio_s"] == pytest.approx(0.06)
    assert rows[0]["resunit_shapes"] == [(1440, 128), (720, 128), (180, 256), (30, 512)]
    assert cs.uncovered_shapes(rows[:1]) == [(30, 512), (180, 256), (720, 128), (1440, 128)]
    assert cs.uncovered_shapes(rows[:1], [(1, 1440, 128, 1), (1, 720, 128, 3),
                                          (1, 180, 256, 9), (1, 30, 512, 1)]) == []
    rows = cs.card_vs_cpu_fast(dev="cpu", cfg=cfg, length=0.1)
    assert [r["max_abs_err"] for r in rows] == [0.0, 0.0]
    assert rows[1]["attention_launches"] == 42


def test_new_phases_rehearse_on_cpu(monkeypatch):
    """Phases 10-12 end to end at a tiny size: fused (eager on the CPU)
    equal to staged, int8 shapes and checks, the served requests and their
    comparisons; launches counted by the plain versions as in the test
    above."""
    import chip_smoke as cs
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr
    import ezaudio_tpu_torch.ops.quant as qm
    from ezaudio_tpu_torch.config import get_model_config

    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=1, iters=1: 0.0)
    monkeypatch.setattr(cs, "graph_ms", lambda fn, iters=1, reps=1: 0.0)
    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    monkeypatch.setattr(qm, "MIN_QUANT_ELEMENTS", 0)  # the tiny widths quantize too
    cfg = get_model_config("s3_l").to_dict()
    cfg["model"].update(embed_dim=32, depth=2, num_heads=4, context_dim=16,
                        ada_sola_rank=2, ada_sola_alpha=2)
    cfg["text_encoder"]["model"] = "tiny"
    ez = cs.build_ezaudio("cpu", config=cfg)
    staged = cs.main_path(ez, length=0.1)
    rows = cs.fused_paths(ez, staged, length=0.1, replays=1)
    assert [r["max_abs_err_vs_staged"] for r in rows] == [0.0, 0.0]
    assert [(r["attention_launches"], r["resunit_launches"]) for r in rows] == [(1200, 24)] * 2
    assert rows[0]["resunit_shapes"] == staged[0]["resunit_shapes"]

    gen = torch.Generator().manual_seed(0)
    (int8, fused8), checks = cs.int8_paths(ez, gen, staged[0], length=0.1)
    assert (int8["attention_launches"], int8["resunit_launches"]) == (600, 12)
    assert int8["vs_f32_max_abs"] > 0 and fused8["max_abs_err_vs_staged"] == 0.0
    shapes = {tuple(c["shape"]) for c in checks}
    assert {(2, 256, 32), (10, 32, 32), (200, 16, 32)} <= shapes  # time MLP, tokens, text
    assert all(c["bit_equal"] for c in checks)

    kw = dict(clip_s=0.1, steps=3, lengths=(0.1,) * 4 + (0.04,) * 2)
    served = cs.served_paths(ez, **kw)
    served_fused = cs.served_paths(ez, fused=True, **kw)
    assert served["stats"]["batches"] == served_fused["stats"]["batches"] == 3
    assert (served["attention_launches"], served["resunit_launches"]) == (54, 48)
    assert served["wav_shapes"] == [[2400]] * 4 + [[960]] * 2 + [[2400]]
    rows = cs.served_checks(ez, served, served_fused)
    assert [r["max_abs_err"] for r in rows][-1] == 0.0  # the edit is the direct call
    assert cs.uncovered_shapes([served], [(2, 2500, 512, 9)]) != []


def _attention_variant(q, k, v, fault=None):
    """Attention as a bf16 kernel might compute it: scores summed in another
    order (f64, then f32), p rounded to bf16.  ``fault`` keeps p in f32,
    keeps the accumulator in bf16, or drops the second key tile."""
    s = (q.double() @ k.double().transpose(-1, -2) * q.shape[-1] ** -0.5).float()
    if fault == "drop_tile":
        s[..., 32:64] = float("-inf")
    p = torch.softmax(s, dim=-1)
    if fault != "p_f32":
        p = p.bfloat16()
    if fault != "bf16_acc":
        return (p.double() @ v.double()).bfloat16()
    acc = torch.zeros(q.shape, dtype=torch.bfloat16)
    for j in range(k.shape[2]):
        acc = acc + p[..., j:j + 1] * v[:, :, j:j + 1, :]
    return acc


@pytest.mark.parametrize("fault,passes", [(None, True), ("p_f32", False),
                                          ("bf16_acc", False), ("drop_tile", False)])
def test_bf16_attention_limit_separates_rounding_from_faults(fault, passes):
    import chip_smoke as cs
    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, L, 64, generator=gen).bfloat16() for L in (128, 160, 160))
    got = _attention_variant(q, k, v, fault)
    ok, _, share = cs.attention_agreement(got, attention_plain(q, k, v), v)
    assert ok == passes, share


def _tf32(x):
    """x rounded to TF32 (10-bit mantissa), to nearest with ties away from
    zero, as ``csrc/mma_tf32.cuh::to_tf32`` does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, split):
    """``a @ b`` as the tensor cores compute it from TF32 operands, with
    exact products: one TF32 product (``split=1``) or the 3xTF32 split
    ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (``split=3``)."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah.double() @ bh.double()
    if split == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


@pytest.mark.parametrize("split,passes", [(3, True), (1, False)])
def test_f32_limits_need_3xtf32(split, passes):
    """The f32 limits of ``chip_smoke.py`` pass kernels whose products are
    3xTF32 and fail kernels that use one TF32 product: attention at f32
    (``attention_agreement``, atol 1e-4) and the ResidualUnit (RESUNIT_TOL).
    On these inputs 3xTF32 stays near 1e-6, one TF32 product near 5e-4
    (attention) and 2e-3 (ResidualUnit)."""
    import chip_smoke as cs
    from ezaudio_tpu_torch.ops.activations import snake_beta_vae
    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain
    from ezaudio_tpu_torch.ops.kernels.resunit import residual_unit_plain

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 64, 64, generator=gen) for _ in range(3))
    s = _tf32_matmul(q, k.transpose(-1, -2), split) * 64 ** -0.5
    got = _tf32_matmul(torch.softmax(s, -1), v, split)
    ok, err, _ = cs.attention_agreement(got, attention_plain(q, k, v), v)
    assert ok == passes, err

    d = 9
    x, w7, b7, w1, b1, a1, be1, a2, be2 = cs.resunit_args("cpu", gen, 1, 128, 128)
    h = torch.nn.functional.pad(snake_beta_vae(x, a1, be1), (0, 0, 3 * d, 3 * d))
    conv = sum(_tf32_matmul(h[:, j * d:j * d + 128], w7[j], split).double()
               for j in range(7)).float()
    got = x + (_tf32_matmul(snake_beta_vae(conv + b7, a2, be2), w1, split) + b1)
    err = (got - residual_unit_plain(x, w7, b7, w1, b1, a1, be1, a2, be2, d)).abs().max()
    assert bool(err <= cs.RESUNIT_TOL) == passes, err.item()


def test_controlnet_phases_rehearse_on_cpu(monkeypatch):
    """Phases 13-15 end to end at a tiny size, the 10 s window cut to 0.1 s:
    the ControlNet runs and their launch counts (the ControlNet's depth // 2
    blocks added to ``want_attention``), the burst clip, card against CPU
    (here CPU against CPU: equal), the served request against the direct
    call."""
    import numpy as np

    import chip_smoke as cs
    import ezaudio_tpu_torch.api.controlnet as api_cn
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr
    from ezaudio_tpu_torch.config import get_model_config

    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    monkeypatch.setattr(api_cn, "WINDOW_SECONDS", 0.1)
    assert cs.want_attention(24, 50, controlnet=True) == 3700
    assert cs.want_attention(24, 25, controlnet=True) == 1850
    clip = cs.burst_clip(24000, 2.0)
    on = np.abs(clip.reshape(4, -1)).max(-1)
    assert clip.shape == (48000,) and on[0] > 0.3 and on[1] == 0 and on[2] > 0.3

    cfg = get_model_config("energy").to_dict()
    cfg["model"].update(embed_dim=32, depth=2, num_heads=4, context_dim=16,
                        ada_sola_rank=2, ada_sola_alpha=2)
    cfg["text_encoder"]["model"] = "tiny"
    cn = cs.build_controlnet("cpu", config=cfg)
    runs = [(name, dict(kw, ddim_steps=3)) for name, kw in cs.CONTROLNET_RUNS]
    rows = cs.controlnet_paths(cn, clip_s=0.1, runs=runs)
    assert [r["path"] for r in rows] == [name for name, _ in cs.CONTROLNET_RUNS]
    assert all((r["attention_launches"], r["resunit_launches"]) == (24, 12) for r in rows)
    assert all(r["wav_shape"] == [2400] for r in rows)
    row = cs.controlnet_card_vs_cpu(dev="cpu", cfg=cfg, clip_s=0.1)
    assert row["max_abs_err"] == 0.0 and row["attention_launches"] == 42
    row = cs.controlnet_served(cn, clip_s=0.1, steps=3, lengths=(0.1, 0.1))
    assert row["stats"]["controlnet_requests"] == 1
    assert row["controlnet_vs_direct_max_abs_err"] == 0.0
    assert row["wav_shapes"] == [[2400]] * 3


def test_bf16_phases_rehearse_on_cpu(monkeypatch):
    """Phases 16-19 end to end at a tiny size: bf16 staged and fused with
    every launch counted as bf16, a bf16 path that runs its decode in f32
    failing the per-dtype count, bf16 card against CPU (here CPU against
    CPU: equal), the checkpoint round trip, s3_xl's path; the bf16
    ResidualUnit rows and their shapes in ``uncovered_shapes``."""
    import chip_smoke as cs
    import ezaudio_tpu_torch.api.controlnet as api_cn
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr
    from ezaudio_tpu_torch.config import get_model_config

    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=1, iters=1: 0.0)
    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    monkeypatch.setattr(api_cn, "WINDOW_SECONDS", 0.1)
    gen = torch.Generator().manual_seed(0)
    rows = cs.check_resunit("cpu", gen, [(1, 100, 128, 9)], "bfloat16")
    assert rows[0]["dtype"] == "bfloat16" and rows[0]["max_abs_err"] == 0.0

    def tiny(name):
        cfg = get_model_config(name).to_dict()
        cfg["model"].update(embed_dim=32, depth=2, num_heads=4, context_dim=16,
                            ada_sola_rank=2, ada_sola_alpha=2)
        cfg["text_encoder"]["model"] = "tiny"
        return cfg

    f32 = cs.main_path(cs.build_ezaudio("cpu", config=tiny("s3_l")), length=0.1)
    ez = cs.build_ezaudio("cpu", config=tiny("s3_l"), dtype="bfloat16")
    rows = cs.bf16_paths(ez, f32, length=0.1, replays=1)
    assert [r["launches_by_dtype"] for r in rows[:2]] == [
        {"attention.bfloat16": 600, "resunit.bfloat16": 12}] * 2
    assert rows[2]["max_abs_err_vs_staged"] == 0.0
    assert 0 < rows[0]["vs_f32"]["max_abs_diff"] and rows[0]["vs_f32"]["corr"] > 0.9
    shapes = rows[0]["resunit_shapes"]
    assert shapes == [(2400, 128, "bfloat16"), (1200, 128, "bfloat16"),
                      (300, 256, "bfloat16"), (50, 512, "bfloat16")]
    assert cs.uncovered_shapes(rows[:1]) == sorted(shapes)
    assert cs.uncovered_shapes(rows[:1], bf16_cases=[(1, L, C, 1) for L, C, _ in shapes]) == []
    ez.autoencoder.model.float()  # a decode that quietly runs in f32
    with pytest.raises(AssertionError, match="by dtype"):
        cs.bf16_paths(ez, f32, length=0.1, replays=1)

    row = cs.bf16_card_vs_cpu(gen, dev="cpu", cfg=tiny("s3_l"), length=0.1)
    assert row["max_abs_err"] == 0.0 and row["launches_by_dtype"] == {
        "attention.bfloat16": 30, "resunit.bfloat16": 12}
    cn = cs.build_controlnet("cpu", config=tiny("energy"))
    row = cs.checkpoint_round_trip(cn, length=0.1, steps=2)
    assert row["weights_on_device"]
    assert 0 < row["generate_rel_err"] <= cs.CKPT_REL_TOL  # the refolded VAE rounds
    assert row["controlnet_rel_err"] <= cs.CKPT_REL_TOL
    row = cs.s3_xl_path("cpu", config=tiny("s3_xl"), length=0.1)
    assert row["launches_by_dtype"] == {"attention.bfloat16": 600, "resunit.bfloat16": 12}


def test_rerank_and_vc_phases_rehearse_on_cpu(monkeypatch):
    """Phases 20-22 end to end at a tiny size: the reranked call's launches
    (one batched call, one decode chunk), the CPU re-scoring (here CPU
    against CPU: equal), the served rerank equal to the direct call with
    one rerank request counted, and the ContentVec features at one frame
    per latent frame (a tiny conv stack with the x320 downsample)."""
    import chip_smoke as cs
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.models.hubert import HubertConfig
    from tests.test_torch_clap import CFG as CLAP_CFG

    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    cfg = get_model_config("s3_l").to_dict()
    cfg["model"].update(embed_dim=32, depth=2, num_heads=4, context_dim=16,
                        ada_sola_rank=2, ada_sola_alpha=2)
    cfg["text_encoder"]["model"] = "tiny"
    ez = cs.build_ezaudio("cpu", config=cfg)
    scorer = cs.build_scorer("cpu", CLAP_CFG)
    ids = cs.clap_ids(vocab=CLAP_CFG.text.vocab_size, lengths=(12, 8, 5, 3))
    assert ids.shape == (4, 12) and (ids[1:, -1] == 1).all() and (ids[:, 0] == 0).all()
    res = cs.rerank_path(ez, scorer, ids, length=0.1)
    assert (res["attention_launches"], res["resunit_launches"]) == (600, 12)
    assert res["all"].shape == (4, 2400) and res["wav_shape"] == [2400]
    assert set(res["score_ms"]) == {"embed_audio", "prepare_audio", "audio_tower", "embed_text"}
    row = cs.clap_card_vs_cpu(scorer, res, ids)
    assert row["audio_max_abs_err"] == row["text_max_abs_err"] == 0.0
    assert row["card_choice"] == row["cpu_choice"]
    row = cs.served_rerank(ez, scorer, ids, steps=3, length=0.1)
    assert row["stats"]["rerank_requests"] == 1 and row["vs_direct"]["max_abs_err"] == 0.0
    assert (row["attention_launches"], row["resunit_launches"]) == (2 * 3 * 3 * 2, 24)

    vc = HubertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=32, conv_dim=(8, 8, 8), conv_kernel=(10, 8, 8),
                      conv_stride=(5, 8, 8), num_conv_pos_embeddings=8,
                      num_conv_pos_embedding_groups=2)
    row = cs.vc_path("cpu", cfg=vc, seconds=1.0, reps=1)
    assert row["shape"] == [1, 50, 16] and row["max_abs_err"] == 0.0


def test_clap_limits_catch_a_transposed_bias_gather():
    """Phase 20's limits separate a fault from agreement: a CLAP whose
    window attention gathers its relative-position bias transposed moves
    the audio embeddings far past CLAP_EMBED_ATOL on the same weights, and
    scores moved by 1e-3 fail CLAP_SCORE_ATOL."""
    import numpy as np

    import chip_smoke as cs
    from ezaudio_tpu_torch.audio.clap import CLAPScorer
    from ezaudio_tpu_torch.models.clap import _SelfAttention
    from tests.test_torch_clap import CFG as CLAP_CFG

    good = CLAPScorer(CLAP_CFG, device="cpu")
    bad = CLAPScorer(CLAP_CFG, device="cpu", weights=good.model.state_dict())
    for m in bad.model.modules():
        if isinstance(m, _SelfAttention):
            n = int(m.relative_index.numel() ** 0.5)
            m.relative_index = m.relative_index.reshape(n, n).T.reshape(-1)
    wav = np.random.default_rng(0).standard_normal((2, 24000)).astype(np.float32) * 0.1
    ids = cs.clap_ids(vocab=CLAP_CFG.text.vocab_size, lengths=(6, 4))
    emb = [(s.embed_audio(wav, 24000), s.embed_text(ids)) for s in (bad, good)]
    scores = [a @ t[0] for a, t in emb]
    cs.clap_agreement("same", *emb[1][:1], *emb[1][:1], *emb[1][1:], *emb[1][1:],
                      scores[1], scores[1])
    with pytest.raises(AssertionError, match="embeddings disagree"):
        cs.clap_agreement("transposed", emb[0][0], emb[1][0], emb[0][1], emb[1][1],
                          scores[0], scores[1])
    with pytest.raises(AssertionError, match="scores disagree"):
        cs.clap_agreement("scores", *emb[1][:1], *emb[1][:1], *emb[1][1:], *emb[1][1:],
                          scores[1] + 1e-3, scores[1])


@pytest.mark.parametrize("cpu_scores,passes", [
    ([0.30, 0.30015, 0.10], True),   # the CPU's top two within CLAP_TIE: a tie
    ([0.30, 0.3005, 0.10], False),   # decided: the card must choose as the CPU does
])
def test_clap_choice_rule(cpu_scores, passes):
    """Phase 20's choice rule: a tie may break either way, a decided choice
    may not."""
    import numpy as np

    import chip_smoke as cs

    emb = np.eye(3)
    card_scores = np.array([0.3001, 0.30005, 0.10])  # the card chooses candidate 0
    check = lambda: cs.clap_agreement("choice", emb, emb, emb[:1], emb[:1], card_scores,
                                      np.array(cpu_scores))
    if passes:
        check()
    else:
        with pytest.raises(AssertionError, match="different candidates"):
            check()


def test_contentvec_shape_rule():
    """Phase 22: ContentVec-base on 10 s at 24 kHz gives 500 frames, one per
    latent frame; another frame count or width fails."""
    import chip_smoke as cs
    from ezaudio_tpu_torch.models.hubert import HubertConfig

    cfg = HubertConfig()
    assert cs.vc_frames(cfg, 24000, 10.0) == cs.vc_frames(cfg, 16000, 10.0) == 500
    cs.check_vc_shape(torch.zeros(1, 500, 768), cfg, 24000, 10.0)
    for shape in ((1, 499, 768), (1, 500, 512), (2, 500, 768)):
        with pytest.raises(AssertionError, match="vc: features"):
            cs.check_vc_shape(torch.zeros(shape), cfg, 24000, 10.0)


def _tiny_s3_l():
    from ezaudio_tpu_torch.config import get_model_config

    cfg = get_model_config("s3_l").to_dict()
    cfg["model"].update(embed_dim=32, depth=2, num_heads=4, context_dim=16,
                        ada_sola_rank=2, ada_sola_alpha=2)
    cfg["text_encoder"]["model"] = "tiny"
    return cfg


def test_training_phases_rehearse_on_cpu(monkeypatch):
    """Phases 23-25 end to end at a tiny size: the kernels' gradients
    against the plain twin's, ``train_cli`` with full remat (4 attention
    launches per block and step, 12 ResidualUnit launches per encode, all
    f32), the restart equal to the uninterrupted run, and one train step
    under each remat policy against itself with full remat (here CPU
    against CPU: equal; 2 launches per block without remat)."""
    import chip_smoke as cs
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr

    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=1, iters=1: 0.0)
    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    gen = torch.Generator().manual_seed(0)
    rows = cs.check_attention_grad("cpu", gen, [(2, 2, 16, 16, 8, False), (3, 2, 16, 9, 8, True)])
    assert all(g["rel_err"] == 0.0 for r in rows for g in r["grads"].values())
    assert rows[0]["grad_fn"] == "FusedAttentionBackward"
    row = cs.check_resunit_grad("cpu", gen, (2, 50, 128, 3))
    assert len(row["grads"]) == 9 and set(row["grads"].values()) == {0.0}

    row = cs.training_path("cpu", cfg=_tiny_s3_l(), clips=4, batch=2, seconds=0.1, steps=3,
                           resume_at=2)
    assert row["launches_per_step"] == [[12, 12]] * 3
    assert row["resumed_losses"] == row["losses"][2:]
    assert (row["attention_launches"], row["resunit_launches"]) == (48, 48)
    assert row["resunit_batch_shapes"] == sorted(
        (2, L, C, d) for L, C in ((2400, 128), (1200, 128), (300, 256), (50, 512))
        for d in (1, 3, 9))
    assert cs.uncovered_shapes([row], [(1, L, C, 1) for L, C in row["resunit_shapes"]]) == []

    rows = cs.train_step_card_vs_cpu(gen, dev="cpu", cfg=_tiny_s3_l(), batch=2, text_len=12)
    assert [r["remat"] for r in rows] == ["full", "dots", "off"]
    for row, launches in zip(rows, (12, 12, 6)):
        assert row["loss"][0] == row["loss"][1] and row["param_max_abs_err"] == 0.0
        assert row["qkv_grads"] == 18 and row["launches"][0] == launches


def test_training_limits_catch_a_detached_attention_and_a_transposed_gradient():
    """Phase 23's and phase 25's limits: an attention whose output is
    detached (zero q, k and v gradients) and a gradient transposed fail;
    the gradients themselves, summed in another order, pass."""
    import chip_smoke as cs

    g = torch.Generator().manual_seed(1)
    want = {n: torch.randn(2, 2, 8, 8, generator=g) for n in "qkv"}
    noisy = {n: w * (1 + 1e-7 * torch.randn(w.shape, generator=g)) for n, w in want.items()}
    assert cs.grad_agreement(noisy, want, cs.KERNEL_GRAD_TOL)[0]
    assert not cs.grad_agreement({n: torch.zeros_like(w) for n, w in want.items()}, want,
                                 cs.KERNEL_GRAD_TOL)[0]
    assert not cs.grad_agreement(dict(want, k=want["k"].transpose(-1, -2)), want,
                                 cs.KERNEL_GRAD_TOL)[0]

    names = [f"model.{b}.{a}.to_{x}.weight" for b in ("in_blocks.0", "mid_block", "out_blocks.0")
             for a in ("attn", "cross_attn") for x in "qkv"] + ["model.time_ada.weight"]
    grads = {n: torch.randn(8, 8, generator=g) for n in names}
    params = {n: torch.randn(8, 8, generator=g) for n in names}
    cpu = dict(loss=1.0, grad_norm=2.0, grads=grads, params=params, launches=(12, 0))

    def card(**kw):
        return dict(cpu, **kw)

    assert cs.train_step_agreement(card(), cpu, 1e-4, 2, 12)[1] == []
    detached = {n: torch.zeros_like(v) if "attn.to_" in n else v for n, v in grads.items()}
    bad = cs.train_step_agreement(card(grads=detached), cpu, 1e-4, 2, 12)[1]
    assert any(b.startswith("gradients") for b in bad) and any("q/k/v" in b for b in bad)
    flipped = dict(grads, **{"model.time_ada.weight": grads["model.time_ada.weight"].t()})
    assert cs.train_step_agreement(card(grads=flipped), cpu, 1e-4, 2, 12)[1] == [
        "gradients ['model.time_ada.weight']"]
    moved = {n: p + 3e-4 if n == names[0] else p for n, p in params.items()}
    assert cs.train_step_agreement(card(params=moved), cpu, 1e-4, 2, 12)[1] == [
        "updated parameters"]
    # a gradient that is rounding noise around an exact 0 (the cross
    # attention's key-norm bias) is held to the floor, not to its own scale
    noise = dict(grads, **{"model.time_ada.weight": torch.full((8, 8), 1e-11)})
    shifted = dict(noise, **{"model.time_ada.weight": torch.full((8, 8), 3e-11)})
    assert cs.train_step_agreement(card(grads=shifted), dict(cpu, grads=noise), 1e-4, 2,
                                   12)[1] == []


def test_train_flops_count_what_each_module_sees():
    """``train_flops`` counts each linear by the tokens it sees: without
    remat it is 3 times the forward's products as torch's own counter
    reads them (text-side and per-sample linears included), and full
    remat adds the blocks' forward once more."""
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke as cs
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config

    m = _tiny_s3_l()["model"]
    torch.manual_seed(0)
    model = maskdit_from_config(dict(m, img_size=10))
    B, T, L = 2, 10, 7
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.randn(B, T, m["out_chans"]), torch.tensor([3, 500]),
              torch.randn(B, L, m["context_dim"]), context_mask=torch.ones(B, L, dtype=torch.bool))
    counts = fc.get_flop_counts()
    blocks = sum(sum(v.values()) for k, v in counts.items()
                 if k.endswith(".mid_block") or (k.count(".") == 3 and "_blocks." in k))
    assert cs.train_flops(model, B, T, L, remat=False) == 3 * fc.get_total_flops()
    assert cs.train_flops(model, B, T, L) == 3 * fc.get_total_flops() + blocks
