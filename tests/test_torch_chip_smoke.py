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


def _resunit_variant(fault):
    """``residual_unit_plain`` in bf16, or a variant of it with ``fault``."""
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.activations import snake_beta_vae
    from ezaudio_tpu_torch.ops.kernels.resunit import residual_unit_plain

    def run(x, w7, b7, w1, b1, a1, be1, a2, be2, d):
        if fault != "f64_sums":
            if fault == "dropped_tap":
                w7 = torch.cat([w7[:6], torch.zeros_like(w7[6:])])
            if fault == "w1_transposed":
                w1 = w1.T.contiguous()
            return residual_unit_plain(x, w7, b7, w1, b1, a1, be1, a2, be2, d)
        # the same function summed in f64: the plain rounding points, other sums
        f = [t.double() for t in (x, w7, b7, w1, b1, a1, be1, a2, be2)]
        h = snake_beta_vae(f[0], f[5], f[6]).to(x.dtype).double()
        h = F.conv1d(h.transpose(1, 2), f[1].permute(2, 1, 0), f[2],
                     padding=3 * d, dilation=d).transpose(1, 2)
        g = snake_beta_vae(h, f[7], f[8]).to(x.dtype).double()
        return (f[0] + g @ f[3] + f[4]).to(x.dtype)
    return run


@pytest.mark.parametrize("fault, passes", [("none", True), ("f64_sums", True),
                                           ("dropped_tap", False), ("w1_transposed", False)])
def test_resunit_bf16_rule_reads_g_from_the_kernel(fault, passes):
    """``resunit_bf16_agreement``, phase 3's bf16 ResidualUnit rule: the
    plain version and the same function summed in f64 (its g rounds the
    other way in some channels) pass; a conv that drops a tap (g moves) or
    a 1x1 product that takes W1 transposed (only the output moves) fails."""
    import chip_smoke as cs

    args = cs.resunit_args("cpu", torch.Generator().manual_seed(0), 2, 300, 128)
    b16 = [a.bfloat16() for a in args[:5]] + args[5:]
    ok, stats = cs.resunit_bf16_agreement(_resunit_variant(fault), b16, 3)
    assert ok == passes, stats
    if fault == "none":
        assert stats["max_abs_err"] == 0.0 and stats["g_diff_share"] == 0.0
    if fault == "f64_sums":
        assert stats["g_diff_share"] > 0 and stats["out_ratio"] <= 1.0


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


def _tiny_energy():
    from ezaudio_tpu_torch.config import get_model_config

    cfg = get_model_config("energy").to_dict()
    cfg["model"].update(embed_dim=32, depth=2, num_heads=4, context_dim=16,
                        ada_sola_rank=2, ada_sola_alpha=2)
    cfg["text_encoder"]["model"] = "tiny"
    return cfg


def _counted_kernels(monkeypatch):
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr

    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))


def test_controlnet_train_phase_rehearses_on_cpu(monkeypatch):
    """Phase 26 at a tiny size: the fine-tune's launches (the base's 3
    blocks, its 1 out-block recomputed, the ControlNet's 1 block: 10 a
    step), the frozen bytes, every trainable tensor moved, the zero
    blocks' gradients; card against CPU (here CPU against CPU: equal).  A
    trainer that leaves the zero blocks unchanged fails, and so does one
    that moves a base parameter."""
    import chip_smoke as cs
    import ezaudio_tpu_torch.training.controlnet_trainer as ct

    _counted_kernels(monkeypatch)
    cfg = _tiny_energy()
    assert cs.controlnet_train_launches(dict(cfg["model"], depth=24)) == 2 * (25 + 12 + 12)
    row = cs.controlnet_train_path("cpu", cfg=cfg, batch=2, seconds=0.2, steps=2)
    assert row["launches_per_step"] == [[10, 0]] * 2
    assert row["zero_block_grad_min"] > 0 and row["trainable_tensors_unmoved"] == 0
    row = cs.controlnet_train_card_vs_cpu(torch.Generator(), dev="cpu", cfg=cfg, text_len=12)
    assert row["loss"][0] == row["loss"][1] and row["qkv_grads"] == 6

    real_mask = ct.trainable_mask
    with monkeypatch.context() as mp:  # the zero blocks left out of the optimizer
        mp.setattr(ct, "trainable_mask", lambda cn: {
            n: v and not n.startswith("controlnet_zero_blocks.")
            for n, v in real_mask(cn).items()})
        with pytest.raises(AssertionError, match="did not move"):
            cs.controlnet_train_path("cpu", cfg=cfg, batch=2, seconds=0.2, steps=1)
    call = ct.ControlNetTrainStep.__call__

    def leaky(self, *a, **k):  # a step that also moves a base parameter
        out = call(self, *a, **k)
        with torch.no_grad():
            next(self.dit.parameters()).add_(1e-3)
        return out

    monkeypatch.setattr(ct.ControlNetTrainStep, "__call__", leaky)
    with pytest.raises(AssertionError, match="frozen tensors changed"):
        cs.controlnet_train_path("cpu", cfg=cfg, batch=2, seconds=0.2, steps=1)


def _tiny_ez():
    import dataclasses

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
    from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

    return EzAudio(config=dict(TINY_CONFIG, model=dict(TINY_CONFIG["model"], depth=2,
                                                       use_checkpoint=True)),
                   t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                   vae_config=TINY_VAE_CONFIG, device="cpu")


def test_distill_flow_and_tool_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """Phases 27 and 29 at a tiny size: the distillation stage (200 launches
    a step at s3_l: 2 teacher calls and the student's call with remat), the
    landing check, the student served with ``sampler='distilled'``; card
    against CPU; the flow step and Heun sample; ``eval_udit`` in MAE mode,
    ``prepare_embeddings`` and one step from its files.  A student that
    aliases the teacher fails."""
    import chip_smoke as cs
    from ezaudio_tpu_torch.diffusion import distill
    from tests.tiny_config import TINY_VAE_CONFIG

    _counted_kernels(monkeypatch)
    assert cs.distill_train_launches(dict(depth=24, use_checkpoint=True)) == 200
    ez = _tiny_ez()
    row = cs.distill_path(ez, batch=2, seconds=0.2, steps=2, n_student=2)
    assert row["launches_per_step"] == [[24, 0]] * 2 and row["land_rel_err"] <= 1e-5
    assert row["served"]["attention_launches"] == 2 * 6 and row["teacher_tensors_changed"] == 0
    row = cs.distill_card_vs_cpu(torch.Generator(), dev="cpu", cfg=_tiny_s3_l(), text_len=12)
    assert row["loss"][0] == row["loss"][1] and row["launches"][0] == 24
    rows = cs.flow_paths(ez, batch=2, seconds=0.2, steps=2)
    assert [r["attention_launches"] for r in rows] == [12, 2 * 2 * 6]
    rows = cs.tool_paths(ez, str(tmp_path), clips=2, seconds=0.5, batch=2,
                         t5_config=ez.t5_cfg, vae_config=TINY_VAE_CONFIG)
    assert [(r["path"], r["resunit_launches"]) for r in rows] == [
        ("eval_udit_mae", 12), ("train_offline_embeddings", 6)]
    assert rows[0]["attention_launches"] == 50 * 6  # 50 DDIM steps, a CFG pair a call

    monkeypatch.setattr(distill, "student_from_teacher",
                        lambda t: t.train().requires_grad_(True))  # an alias
    with pytest.raises(ValueError, match="shares tensors"):
        cs.distill_path(_tiny_ez(), batch=2, seconds=0.2, steps=1, n_student=2)


def test_bf16_train_phase_rehearses_on_cpu(monkeypatch):
    """Phase 28 at a tiny size: kernel 1's bf16 gradients against SDPA's,
    ``train_cli --dtype bfloat16`` (every launch bf16, f32 parameters and
    moments, the restart equal), one bf16 step per optimizer card against
    CPU (here CPU against CPU).  A step whose parameters are bf16 fails."""
    import chip_smoke as cs
    from ezaudio_tpu_torch import utils
    from ezaudio_tpu_torch.training import trainer as tr

    _counted_kernels(monkeypatch)
    rows = cs.check_attention_grad_bf16("cpu", torch.Generator().manual_seed(0),
                                        [(2, 2, 32, 32, 16, False), (2, 2, 32, 9, 16, True)])
    assert all(s["ok"] for r in rows for s in r["grads"].values())
    row = cs.training_path("cpu", cfg=_tiny_s3_l(), clips=4, batch=2, seconds=0.1, steps=3,
                           resume_at=2, dtype="bfloat16")
    assert row["launches_per_step"] == [[12, 12]] * 3 and row["mixed_precision_faults"] == []
    assert row["resumed_losses"] == row["losses"][2:]
    assert all(len(s) == 3 and s[2] == "bfloat16" for s in row["resunit_shapes"])
    rows = cs.bf16_train_card_vs_cpu(torch.Generator(), dev="cpu", cfg=_tiny_s3_l(), text_len=12)
    assert [r["optimizer"] for r in rows] == ["adamw", "adamw_mu_bf16", "adafactor"]
    assert all(r["grad_card_to_cpu"] == 0.0 and r["faults"] == [] for r in rows)

    create = tr.Trainer.create.__func__

    def cast_first(cls, model, *a, **k):  # bf16 parameters instead of f32 masters
        if k.get("dtype") == torch.bfloat16:
            utils.cast_params_(model, torch.bfloat16)
        return create(cls, model, *a, **k)

    monkeypatch.setattr(tr.Trainer, "create", classmethod(cast_first))
    with pytest.raises(AssertionError, match="mixed precision"):
        cs.bf16_train_card_vs_cpu(torch.Generator(), dev="cpu", cfg=_tiny_s3_l(), text_len=12,
                                  optimizers=cs.BF16_TRAIN_OPTIMIZERS[:1])


def test_zero_gradient_rule_holds_noise_to_noise():
    """Phase 26's exact-zero gradients (a key norm's bias): rounding noise
    that differs beyond the floor passes as noise; a card gradient there
    that is signal fails."""
    import chip_smoke as cs

    g = torch.Generator().manual_seed(2)
    names = [f"in_blocks.0.{a}.to_{x}.weight" for a in ("attn", "cross_attn") for x in "qkv"]
    grads = {n: torch.randn(8, 8, generator=g) * 5e-3 for n in names}
    grads["in_blocks.0.cross_attn.norm_k.bias"] = torch.full((8,), 5e-11)
    params = {n: torch.zeros_like(v) for n, v in grads.items()}
    cpu = dict(loss=1.0, grad_norm=2.0, grads=grads, params=params, launches=(10, 0))
    zero = ["in_blocks.0.cross_attn.norm_k.bias"]
    noisy = dict(grads, **{zero[0]: torch.full((8,), 1e-9)})
    assert cs.train_step_agreement(dict(cpu, grads=noisy), cpu, 1e-4, 2, 10, n_attn=2)[1] != []
    assert cs.train_step_agreement(dict(cpu, grads=noisy), cpu, 1e-4, 2, 10, n_attn=2,
                                   zero_names=zero)[1] == []
    signal = dict(grads, **{zero[0]: torch.full((8,), 1e-4)})
    assert cs.train_step_agreement(dict(cpu, grads=signal), cpu, 1e-4, 2, 10, n_attn=2,
                                   zero_names=zero)[1] == [f"zero gradients {zero}"]


TINY_VAE = dict(channels=4, latent_dim=4, c_mults=(1, 2), strides=(2, 4))
TINY_DAC = dict(encoder_dim=4, encoder_rates=(2, 4), latent_dim=8, decoder_dim=16,
                decoder_rates=(4, 2), n_codebooks=3, codebook_size=16, codebook_dim=4,
                sample_rate=8000)
TINY_ENCODEC = dict(dimension=8, n_filters=4, ratios=(4, 2), n_q=3, codebook_size=16,
                    sample_rate=8000)
TINY_DISC = dict(periods=(2,), fft_sizes=(128,))
TINY_STEP = dict(stft_windows=(128, 64))


def test_codec_phase_rehearses_on_cpu(monkeypatch):
    """Phase 30 end to end at a tiny size: the VAE codec trainer (12
    kernel-2 launches a step at these widths, every tensor moved, every
    weight-norm gradient non-zero), its step card against CPU (here CPU
    against CPU: equal) and float64, DAC (near ties, the ``.dac`` round
    trip, train steps), EnCodec, the facade both ways and the
    pretransforms."""
    import chip_smoke as cs

    _counted_kernels(monkeypatch)
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")
    row = cs.codec_train_path("cpu", TINY_VAE, batch=2, samples=1024, steps=2, sr=8000,
                              disc_kw=TINY_DISC, step_kw=TINY_STEP)
    assert row["launches_per_step"] == [[0, 12]] * 2 and row["resunit_launches"] == 24
    assert row["unmoved"] == {"gen": [], "disc": []} and row["weight_norm_min_grad"] > 0
    assert row["weight_norm_tensors"] == 2 * 32  # g and v of 16 convs a side
    assert row["resunit_batch_shapes"] == sorted(
        (2, L, C, d) for L, C in ((1024, 4), (512, 4)) for d in (1, 3, 9))
    row = cs.codec_step_card_vs_cpu("cpu", TINY_VAE, batch=2, samples=1024, sr=8000,
                                    disc_kw=TINY_DISC, step_kw=TINY_STEP)
    assert row["card_launches"] == [0, 12]
    for k in ("card_vs_cpu", "card_plain_vs_cpu"):  # the CPU "kernel" is the plain twin
        assert all(a == b for a, b in row[k]["metrics"].values()), k
        assert row[k]["leaky_flips"] == {} and row[k]["needed_factor"]["gen"]["l2"] == 1.0, k
    row = cs.dac_paths("cpu", seconds=0.5, dac_kw=TINY_DAC, train_batch=2, train_samples=1024,
                       train_steps=2, disc_kw=TINY_DISC, step_kw=TINY_STEP)
    assert row["near_tie"]["frames_differing"] == 0 and row["dacfile"]["codes_equal"]
    assert row["codes_shape"] == [1, 3, 500] and row["train"]["launches"] == [[0, 0]] * 2
    row = cs.encodec_path("cpu", seconds=0.5, kw=TINY_ENCODEC)
    assert row["codes_equal_share"] == 1.0 and row["codes_shape"] == [1, 3, 500]
    rows = cs.facade_paths("cpu", seconds=0.25, vae_kw=TINY_VAE, dac_kw=TINY_DAC,
                           encodec_kw=TINY_ENCODEC, chunk=(64, 16))
    counts = {r["path"]: r["resunit_launches"] for r in rows}
    assert counts == {"facade_stable_vae_q_first": 12, "facade_stable_vae_q_last": 12,
                      "facade_dac_q_first": 0, "facade_dac_q_last": 0,
                      "facade_dac_chunked": 0, "facade_encodec_q_first": 0,
                      "facade_encodec_q_last": 0}
    rows = cs.pretransform_paths("cpu", seconds=0.5, sr=8000, bands=4, levels=2)
    assert [r["latent_shape"] for r in rows] == [[1, 1000, 4], [1, 1000, 4]]
    # the orthogonal wavelet reconstructs exactly; the PQMF bank's error is
    # printed, not checked: the JAX package's bank is near-perfect at 8
    # bands only (ROADMAP F12), and the port computes the same function
    assert rows[1]["reconstruction_rel_rms"] < 1e-5


def test_codec_limits_catch_a_shifted_code_and_a_transposed_codebook(monkeypatch):
    """Phase 30's near-tie rule: a code shifted by one fails, a true near
    tie passes; a card codec whose codebooks are transposed (read as
    (dim, size) and reshaped back) fails DAC's and EnCodec's checks."""
    import chip_smoke as cs

    model = cs.build_codec("dac", "cpu", 5, **TINY_DAC).eval()
    clip = torch.from_numpy(cs.codec_clip(8000, 0.5, seed=2))
    with torch.no_grad():
        z = model.encode_latent(model.preprocess(clip))
        codes = model.quantizer(z)[1]
    scores = cs.rvq_scores(model, z, "dac")
    row, agree, bad = cs.near_tie_codes(codes, codes, scores)
    assert bad == [] and agree.all() and row["frames_differing"] == 0
    shifted = codes.clone()
    shifted[0, 1, 7] = (shifted[0, 1, 7] + 1) % 16
    row, agree, bad = cs.near_tie_codes(shifted, codes, scores)
    assert len(bad) == 1 and "frame 0,7 codebook 1" in bad[0] and not agree[0, 7]
    # a near tie: the card's code within CODEC_TIE of the CPU's best
    tied = [s.clone() for s in scores]
    tied[1][7, shifted[0, 1, 7]] = tied[1][7, codes[0, 1, 7]] - cs.CODEC_TIE / 2
    assert cs.near_tie_codes(shifted, codes, tied)[2] == []

    build = cs.build_codec
    calls = {"n": 0}

    def transposed_on_card(kind, dev, seed=0, **kw):
        m = build(kind, dev, seed, **kw)
        calls["n"] += 1
        if calls["n"] == 2:  # the second model built is the card's
            with torch.no_grad():
                books = ([q.codebook.weight for q in m.quantizer.quantizers] if kind == "dac"
                         else [v.codebook for v in m.quantizer.layers])
                for w in books:
                    w.copy_(w.t().reshape(w.shape))
        return m

    monkeypatch.setattr(cs, "build_codec", transposed_on_card)
    with pytest.raises(AssertionError, match="dac: frame"):
        cs.dac_paths("cpu", seconds=0.5, dac_kw=TINY_DAC)
    calls["n"] = 0
    with pytest.raises(AssertionError, match="encodec: frame"):
        cs.encodec_path("cpu", seconds=0.5, kw=TINY_ENCODEC)


def test_codec_kink_floor_applies_only_where_a_flip_is_shown():
    """A LeakyReLU input whose sign differs between the card and the CPU
    names its chain of convs and its sub-discriminator's ``conv_post``; only
    there does a gradient get CODEC_KINK_FLOOR.  The same gradient error on
    a tensor of another chain fails."""
    import chip_smoke as cs

    chain = "discriminators.5.band_convs.2"
    got = [("discriminators.0.convs", torch.tensor([0.5, -2.0])),
           (chain, torch.tensor([3e-9, 1.0, -4.0]))]
    want = [("discriminators.0.convs", torch.tensor([0.5, -2.0])),
            (chain, torch.tensor([-2e-9, 1.0, -4.0]))]
    rows, kinks = cs.leaky_flips(got, want)
    assert rows == {chain: dict(n=1, largest_abs_got=pytest.approx(3e-9),
                                largest_abs_want=pytest.approx(2e-9))}
    assert kinks == [f"{chain}.", "discriminators.5.conv_post."]
    assert cs.leaky_flips(want, want) == ({}, [])

    names = [f"{chain}.0.0.weight_v", "discriminators.5.conv_post.weight_g",
             "discriminators.0.convs.0.0.weight_v"]
    cpu = {n: torch.full((4,), 1e-5) for n in names}  # below both floors
    cpu["big"] = torch.full((4,), 1.0)  # the network's largest gradient: 1
    # float64 1e-8 from the CPU on "big" only: an L2 yardstick of 2e-8
    ref = dict({n: v.double() for n, v in cpu.items()}, big=cpu["big"].double() + 1e-8)
    gen = {"w": torch.ones(2)}

    def step(grads):
        return dict(metrics={"disc/loss": 1.0}, gen_grads=gen, disc_grads=grads,
                    gen_params={}, disc_params={})

    lr = {"gen": 1e-3, "disc": 1e-3}
    for name in names:
        # 5e-8 off: past TRAIN_GRAD_TOL of the 1e-4 floor (1e-8), inside the
        # kink floor's (1e-7); the CPU sits on float64, so no factor helps
        moved = dict(cpu, **{name: cpu[name] + 5e-8})
        row, bad = cs.codec_step_agreement(step(moved), step(cpu), step(ref), lr, 8.0, kinks)
        assert (bad == []) == name.startswith(tuple(kinks)), (name, bad)
        assert row["passed_by_the_kink_floor"] == ([name] if bad == [] else []), name
        assert cs.codec_step_agreement(step(moved), step(cpu), step(ref), lr, 8.0)[1], name


def test_codec_limits_catch_a_detached_residual_unit(monkeypatch):
    """A ResidualUnit routed through the kernel with its weights detached
    trains nothing in its convs: no gradient reaches their ``weight_g`` /
    ``weight_v``, and phase 30 (a) fails."""
    import chip_smoke as cs
    from ezaudio_tpu_torch.codecs import oobleck_fast

    real = oobleck_fast.resunit_fused

    def detached(x, unit):
        with torch.no_grad():
            y = real(x, unit)
        return x + (y - x)  # the residual path only

    monkeypatch.setattr(oobleck_fast, "resunit_fused", detached)
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")
    with pytest.raises(AssertionError, match="zero weight-norm gradients"):
        cs.codec_train_path("cpu", TINY_VAE, batch=2, samples=1024, steps=1, sr=8000,
                            disc_kw=TINY_DISC, step_kw=TINY_STEP)


def test_variant_phase_rehearses_on_cpu(monkeypatch):
    """Phase 31 at a tiny width on the CPU: config (a) staged, fused and
    bf16, config (c), every launch counted and every attention shape
    checked; (d)'s card-against-CPU comparisons (the CPU against itself);
    and phase 30 (a)'s codec restart, bit-equal."""
    import chip_smoke as cs
    import ezaudio_tpu_torch.ops.kernels.attention as ka
    import ezaudio_tpu_torch.ops.kernels.resunit as kr

    monkeypatch.setattr(ka, "attention_plain", counted(ka.attention_plain, ka.fused_attention))
    monkeypatch.setattr(kr, "residual_unit_plain",
                        counted(kr.residual_unit_plain, kr.fused_residual_unit))
    full = cs.variant_config

    def tiny(depth=None, **switches):
        cfg = full(**switches)
        cfg["model"].update(embed_dim=32, depth=depth or 2, num_heads=4, context_dim=16)
        cfg["text_encoder"].update(model="tiny", max_length=7)
        cfg["model"]["context_max_length"] = 7
        return cfg

    monkeypatch.setattr(cs, "variant_config", tiny)
    monkeypatch.setattr(cs, "SWITCH_FRAMES", 12)
    monkeypatch.setattr(cs, "VARIANT_STEPS", 10)
    cases = [(2, 4, 12, 12, 8, "concat"), (2, 4, 13, 13, 8, "concat")]
    assert cs.uncovered_attention({(12, 12, 8, True), (13, 13, 8, False)}, cases) == [
        (13, 13, 8, False)]
    rows = cs.variant_paths("cpu", reps=2, length=0.1, attn_cases=cases)
    counts = {r["path"]: [r["attention_launches"], r["resunit_launches"]] for r in rows}
    # 3 blocks a call, one self-attention each, 10 calls; 12 units a decode
    assert counts == {"variant[1]": [30, 12], "variant[4]": [30, 12],
                      "variant_fused[1]": [90, 36], "variant_bf16[1]": [30, 12],
                      "variant_token[1]": [30, 12]}
    assert rows[-2]["launches_by_dtype"] == {"attention.bfloat16": 30,
                                             "resunit.bfloat16": 12}
    rows = cs.variant_card_vs_cpu(torch.Generator().manual_seed(0), dev="cpu")
    assert len(rows) == 1 + len(cs.SWITCH_CASES) + 3 + 1
    assert all(r.get("max_abs_err", 0.0) == 0.0 for r in rows[:-1])
    row = cs.codec_restart("cpu", widths=TINY_VAE, batch=2, samples=960, steps=2,
                           disc_kw=TINY_DISC, step_kw=TINY_STEP)
    assert row["tensors_differ"] == [] and row["losses_resumed"] == row["losses_straight"]


def test_toolkit_phase_rehearses_on_cpu(monkeypatch, tmp_path):
    """Phase 32 at a tiny size on the CPU: both demos through ``demo.main``
    (tiny configs, ``--device cpu``, 3 steps) with their launches counted;
    ``AudioSignal``, the transform batch, the quality metrics and Whisper,
    each against the CPU itself; ``istft`` twice bit-equal; nothing of
    TOOLKIT_FORBIDDEN imported."""
    import dataclasses

    import chip_smoke as cs
    from ezaudio_tpu_torch.models.whisper import WhisperConfig
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
    from tests.test_torch_debug_demo import CN_CONFIG
    from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

    _counted_kernels(monkeypatch)
    towers = dict(t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                  vae_config=TINY_VAE_CONFIG)
    whisper = WhisperConfig(vocab_size=64, d_model=32, encoder_layers=1, decoder_layers=1,
                            encoder_attention_heads=2, decoder_attention_heads=2,
                            encoder_ffn_dim=64, decoder_ffn_dim=64, max_target_positions=80,
                            decoder_start_token_id=1, eos_token_id=2)
    rows = cs.toolkit_paths(str(tmp_path), "cpu", demo_argv=("--steps", "3", "--device", "cpu"),
                            t2a_kw=dict(config=TINY_CONFIG, **towers),
                            cn_kw=dict(config=CN_CONFIG, **towers),
                            data_kw=dict(clips=4, seconds=0.5, sr=24000, batch=2),
                            whisper_cfg=whisper)
    # 3 steps of 5 blocks (+ 2 ControlNet blocks), self and cross each; 6 units a decode
    assert [(r["path"], r["attention_launches"], r["resunit_launches"]) for r in rows] == [
        ("demo_t2a", 30, 6), ("demo_controlnet", 42, 6)]
    assert rows[0]["wav_shape"] == [10 * 800]
    assert cs.want_attention(24, 100) == 5000 and cs.want_attention(24, 50, controlnet=True) == 3700
    assert cs.vae_units() == 12


@pytest.mark.parametrize("case,passes", [("equal", True), ("near_tie", True),
                                         ("shifted", False), ("prompt", False)])
def test_whisper_id_rule_catches_a_shifted_id(case, passes):
    """The card's ids against the CPU's: equal, or differing first where
    the CPU's logits are within WHISPER_TIE, passes; an id shifted by one
    at a clear margin, or a differing prompt, fails."""
    import numpy as np

    import chip_smoke as cs

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32)
    cpu = np.concatenate([np.full((2, 1), 7), logits.argmax(-1)], 1)
    card = cpu.copy()
    if case == "near_tie":
        logits[1, 2, cpu[1, 3] + 1] = logits[1, 2, cpu[1, 3]] - cs.WHISPER_TIE / 2
        card[1, 3] += 1
        card[1, 4:] = 0  # after the first difference nothing is compared
    elif case == "shifted":
        top2 = np.sort(logits[1, 2])[-2:]
        assert top2[1] - top2[0] > cs.WHISPER_TIE
        card[1, 3] += 1 if cpu[1, 3] + 1 < 40 else -1
    elif case == "prompt":
        card[0, 0] = 8
    row, bad = cs.whisper_ids_agreement(card, cpu, logits, 1)
    assert (not bad) == passes, bad
    assert row["first_difference"] == {"equal": [None, None], "near_tie": [None, 3],
                                       "shifted": [None, 3], "prompt": [0, None]}[case]


def test_parallel_phase_rehearses_on_cpu(monkeypatch, tmp_path):
    """Phase 33 at a tiny size on the CPU: (a) the t2a stand-in through
    flac (bit-exact), mp3 and ogg and the native batches into the VAE
    encode with their kernel 2 launches; (b) a gloo world of one: the
    meshed EzAudio equal to the plain one and the two meshed train steps
    (one FSDP2-wrapped) held to the plain step; (c) the ring's hop math at
    sp = 4 against the kernel's plain twin and SDPA."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    import chip_smoke as cs
    from ezaudio_tpu_torch.data import codec_loader, native_loader
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
    from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

    if not native_loader.available():
        pytest.skip("g++ missing")
    _counted_kernels(monkeypatch)
    t = np.arange(12000) / 24000
    clip = (0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.05 * np.random.default_rng(0).standard_normal(t.size))[None].astype(np.float32)
    (tmp_path / "a").mkdir()
    row = cs.nonwav_paths(clip, 24000, str(tmp_path / "a"), "cpu", clips=4, seconds=0.5,
                          batch=2, vae_config=TINY_VAE_CONFIG)
    assert row["libav"] == codec_loader.available()
    assert row["launches_per_batch"] == [6, 6] and row["resunit_launches"] == 12
    if row["libav"]:
        assert row["formats"]["flac"]["bit_exact"]
        assert row["formats"]["mp3"]["snr_db"] > cs.MP3_MIN_SNR_DB
    cfg = json_copy(TINY_CONFIG)
    rows = cs.world_one_paths("cpu", cfg=cfg,
                              t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                              vae_config=TINY_VAE_CONFIG, length=1.0, steps=2,
                              init_method=f"file://{tmp_path / 'rendezvous'}")
    assert not dist.is_initialized()
    assert [r["path"] for r in rows] == ["mesh_off[1]", "mesh_world1[1]", "train_world1_mesh",
                                         "train_world1_hsdp"]
    assert rows[1]["rel_err_vs_no_mesh"] <= cs.MESH_TOL
    assert rows[1]["attention_launches"] == 2 * 5 * 2 and rows[1]["resunit_launches"] == 6
    assert rows[3]["fsdp2_wrapped"] and rows[3]["dtensor_params"] > 0
    ring = cs.ring_math("cpu", torch.Generator().manual_seed(0),
                        cases=[(2, 2, 16, 16, 8)], sp=4, time_it=False)
    assert len(ring) == 4 and all(r["sp"] == 4 for r in ring)


def json_copy(obj):
    import json

    return json.loads(json.dumps(obj))
