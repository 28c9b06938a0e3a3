"""Phase 35 of ``chip_smoke.py`` (the mid product harnesses) rehearsed on the
CPU, its launch counts, the RoPE tables' fault it found (ROADMAP F22), and
``distill_serve_mid``'s main at the script's CPU-smoke knobs.

The rehearsal runs the phase at a tiny size with the kernels' plain twins
counted as launches: 2 s clips (the ControlNet's window set to 2 s), a
tiny x480 VAE, depth 2 at one head of 64, the VAE fit on 0.1 s crops.
Every path's launches are those ``product_want`` computes, the cached
VAE, data and teacher of (b) launch nothing, the ControlNet starts at
scale 1 equal to scale 0, card against CPU reads 0 (the CPU on both sides).
"""

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.validation import distill_serve_mid as ds
from ezaudio_tpu_torch.validation import mid_common as mc
from tests.test_torch_quality_harness import TINY_MID_VAE


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_product_phase_rehearses_on_cpu(monkeypatch, tmp_path):
    import chip_smoke as cs
    from tests.test_torch_chip_smoke import _counted_kernels

    _counted_kernels(monkeypatch)
    fit = mc.fit_vae_facade
    monkeypatch.setattr(mc, "fit_vae_facade", lambda *a, **k: fit(*a, **dict(k, seg_s=0.1)))
    # 2 s clips: self-attention over 100 frames, an edit window of 1.12 s (56
    # frames), the T5's 8 tokens, verify_dit's 100 context tokens
    cases = [(2, 1, L, Lk, 64, m) for L in (100, 56) for Lk, m in ((L, False), (8, "t5_8"))]
    with cs.controlnet_window(2.0):
        rows = cs.product_paths("cpu", str(tmp_path), vae_config=TINY_MID_VAE, dim=64, heads=1,
                                frames=100, fit_steps=1, attn_cases=cases)
    got = {r["path"]: [r["attention_launches"], r["resunit_launches"]] for r in rows}
    assert got == {
        "product_vae_fit": [0, 24], "product_data": [0, 36], "product_teacher": [30, 0],
        "product_distill": [72, 0], "product_roundtrip": [0, 24],
        "product_served_teacher": [60, 24], "product_served_student": [24, 24],
        "product_student_direct": [24, 12], "product_cached_vae": [0, 0],
        "product_cached_data": [0, 0], "product_cached_teacher": [0, 0],
        "product_edit_rows": [360, 252], "product_cn_data": [0, 12], "product_cn_start": [16, 0],
        "product_cn_train": [24, 0], "product_cn_trained": [16, 0], "product_cn_eval": [140, 24],
        "product_cvc_encode": [0, 12], "product_cvc_roundtrip": [0, 24],
        "product_verify": [12, 24]}
    assert cs.uncovered_shapes(rows, cases=[(1, L, C, 1) for L, C in {
        tuple(s) for r in rows for s in r["resunit_shapes"]}]) == []


@pytest.mark.parametrize("path,kw,want", [
    ("distill", dict(depth=2, steps=4), (72, 0)),
    ("distill", dict(depth=12, steps=1500), (6 * 13 * 1500, 0)),
    ("serve", dict(depth=2, steps=10, clips=4, batches=1), (60, 24)),
    ("serve", dict(depth=2, steps=4, clips=9, batches=3), (3 * 24, 36 + 24)),
    ("roundtrip", dict(depth=2, clips=8), (0, 24)),
    ("roundtrip", dict(depth=2, clips=9), (0, 48)),
    ("edit_rows", dict(depth=2, steps=10, edits=2, n_eval=8), (360, 144 + 72 + 24 + 12)),
    ("cn_call", dict(depth=2, clips=2), (16, 0)),
    ("cn_train", dict(depth=12, steps=3), (3 * 2 * 19, 0)),
    ("cn_eval", dict(depth=2, steps=10), (80 + 60, 24)),
    ("verify", dict(depth=2), (12, 24)),
])
def test_product_launch_counts(path, kw, want):
    """Phase 35's expected launches: a model call two attentions in each of
    depth + 1 blocks (a CFG pair one call), the ControlNet's depth // 2
    in-blocks on top; three calls a distillation step; 12 ResidualUnits an
    encode or decode call of up to 8 clips (a served batch of up to 4)."""
    import chip_smoke as cs

    assert cs.product_want(path, **kw) == want


def test_rope_tables_made_in_inference_mode_train():
    """ROADMAP F22: a sampler call in inference mode makes the RoPE tables of
    its length; a later train step at that length takes their gradient path
    (they were inference tensors, which autograd refuses to save)."""
    from ezaudio_tpu_torch.validation.quality_validate import seeded_maskdit
    from ezaudio_tpu_torch.validation.quality_validate_mid import model_config

    model = seeded_maskdit(model_config(2, 32, 2, 20, 4, False), 0, "cpu").eval()
    x, ctx = torch.randn(2, 20, 4), torch.randn(2, 3, 64)
    t = torch.tensor([10, 500])
    with torch.inference_mode():
        model(x, t, ctx)
    model.train()
    out = model(x.requires_grad_(), t, ctx)[0]
    out.square().mean().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_distill_serve_main_prints_every_row(tmp_path, capsys):
    """The script's CPU-smoke knobs, cut to 2 s clips and 8 + 4 clips (the
    fitted VAE served from the cache: a fit step costs ~10 s here)."""
    from ezaudio_tpu_torch.validation.quality_validate_mid import make_vae

    facade, _, _ = make_vae("cpu", TINY_MID_VAE)
    mc._save_params(str(tmp_path / "mid_vae" / "s1_b4"), facade.model.state_dict(), {"steps": 1})
    rows = ds.main(["--device", "cpu", "--depth", "2", "--dim", "64", "--frames", "100",
                    "--train-steps", "3", "--distill-steps", "2", "--n-train", "8",
                    "--n-eval", "4", "--batch", "4", "--serve-batch", "4", "--vae-steps", "1",
                    "--cache-root", str(tmp_path)], vae_config=TINY_MID_VAE)
    out = capsys.readouterr().out
    assert [r[0] for r in rows] == [ds.TEACHER_ROW, ds.STUDENT_ROW]
    for name, fad, acc, thr, wall in rows:
        assert f"| {name} |" in out and np.isfinite([fad, acc, thr, wall]).all()
    assert "student checkpoint saved+reloaded" in out and "stage walls" in out
