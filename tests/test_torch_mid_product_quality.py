"""The editing/ControlNet harness, checkpoint verification and the MNRU
calibrations of the port (``validation/{quality_edit_controlnet_mid,
verify_checkpoints,calibrate_pesq_mnru,calibrate_nsim_mnru}.py``) against
the JAX scripts on the CPU.

  (v)    ``seam_db`` and ``pearson`` bit-equal to the script's; the editing
         table equal to the one the JAX script's ``main`` prints when both
         run on the same deterministic stand-in EzAudio (so the mask frames,
         the draws, the splices and every row agree); the ControlNet's
         fine-tune starts from zero projections, on the harness's path and
         on the public one (``EzAudioControlNet(zero_projections=True)``;
         scale 1 gives scale 0's output, the in-blocks the base's), the
         zeroed leaves those the JAX init zeroes, and leaves them after a
         step;
  (vi)   ``verify_*`` on the reference-format ``.pt`` fixtures of
         ``tests/test_export.py::TestVerifyCheckpoints`` give the JAX script's
         reports (the DiT's inputs JAX's draws); a missing or extra tensor
         is refused, naming it;
  (vii)  both calibrations on a reduced grid (Q 10 and 25, one reference)
         print what the JAX scripts print with ``QS`` and ``N_REFS`` so;
  (viii) the editing/ControlNet and verification mains at the scripts' CPU-smoke
         knobs print every row (``distill_serve_mid``'s: test_torch_mid_product_chip.py).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.validation import calibrate_nsim_mnru as cal_nsim
from ezaudio_tpu_torch.validation import calibrate_pesq_mnru as cal_pesq
from ezaudio_tpu_torch.validation import mid_common as mc
from ezaudio_tpu_torch.validation import quality_edit_controlnet_mid as qc
from ezaudio_tpu_torch.validation import verify_checkpoints as vc
from ezaudio_tpu_torch.validation.quality_validate_mid import synth_clip
from tests.test_parity import load
from tests.test_torch_mid_product import _scripts
from tests.test_torch_quality_harness import TINY_MID_VAE

# The bf16 DiT's mean |f(999) - f(9)| is held by the statistical rule of
# tests/test_torch_bf16.py: the port's bf16 value no farther from the f32
# value (the port's f32 run, which is JAX's within 1e-5) than BF16_REF_FACTOR
# times JAX's bf16 value is.  (Read: port bf16 0.3653, f32 0.3648, JAX bf16
# 0.3691 on the fixture: JAX's op-by-op bf16 rounds more intermediates.)
BF16_REF_FACTOR = 2.0
SDR_ATOL = 1e-3  # dB, the f32 sine round trip's SI-SDR (read 4e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (v) the editing rows and the ControlNet's start
def test_seam_and_pearson_bit_equal():
    (jqc,) = _scripts("quality_edit_controlnet_mid")
    rng = np.random.default_rng(20)
    m = rng.standard_normal((3, 500, 8)).astype(np.float32)
    np.testing.assert_array_equal(qc.seam_db(m, 150, 350), jqc.seam_db(m, 150, 350))
    np.testing.assert_array_equal(qc.seam_db(m, 12, 40, w=5), jqc.seam_db(m, 12, 40, w=5))
    a, b = rng.standard_normal((2, 1000)).astype(np.float32)
    assert qc.pearson(a, b) == jqc.pearson(a, b)
    assert qc.pearson(a, a) == jqc.pearson(a, a)


class _StandInCodec:
    """A deterministic VAE stand-in: each frame of ``ratio`` samples
    projected onto 8 channels."""

    def __init__(self, ratio):
        self.ratio = ratio
        self.w = np.random.default_rng(0).standard_normal((ratio, 8)).astype(np.float32)

    def encode(self, wavs, sample=False):
        w = np.asarray(wavs, np.float32)[..., 0]
        return np.tanh(w.reshape(len(w), -1, self.ratio) @ self.w / np.sqrt(self.ratio))


class _StandInEz:
    """``editing_audio`` pastes a clip of the prompt's class, drawn from the
    seed, over the mask (scaled by the crossfade)."""
    sr, latent_sr = 24000, 50

    def __init__(self):
        self.autoencoder = _StandInCodec(self.sr // self.latent_sr)

    def editing_audio(self, text, boundary, gt_file, mask_start, mask_length, ddim_steps,
                      guidance_scale, random_seed, crossfade=0.0):
        out = np.asarray(gt_file, np.float32).copy()
        s0, s1 = round(mask_start * self.sr), round((mask_start + mask_length) * self.sr)
        clip = synth_clip(np.random.default_rng(random_seed), mc.PROMPTS.index(text), s1 - s0,
                          self.sr)
        out[s0:s1] = clip * (1.0 - 2.0 * crossfade) + 0.01 * boundary
        return self.sr, out


def _table(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("| ")]


def test_edit_table_equals_jax_main(monkeypatch, capsys):
    (jqc,) = _scripts("quality_edit_controlnet_mid")
    rng = np.random.default_rng(21)
    data = dict(m_eval=rng.standard_normal((32, 500, 8)).astype(np.float32), mu=0.125, sd=0.75)
    ez = _StandInEz()

    def roundtrip(ez_, m, mu, sd):
        return np.tanh(m * 0.9 + 0.01)

    for mod in (jqc, mc):
        monkeypatch.setattr(mod, "build_mid_ezaudio",
                            lambda *a, **k: (ez, {"diff": mc.MID_DIFF}, {}, None))
        monkeypatch.setattr(mod, "fit_vae", lambda *a, **k: None)
        monkeypatch.setattr(mod, "prepare_data", lambda *a, **k: data)
        monkeypatch.setattr(mod, "train_teacher", lambda *a, **k: None)
        monkeypatch.setattr(mod, "roundtrip_latents", roundtrip)
    monkeypatch.setattr(jqc, "N_EDIT", 4)
    for k in ("QC_XFADE", "QC_N_SAME", "QC_SKIP_EDIT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("QC_SKIP_CN", "1")
    jqc.main()
    want = _table(capsys.readouterr().out)
    out = qc.main(["--device", "cpu", "--n-edit", "4", "--skip-cn"])
    got = _table(capsys.readouterr().out)
    assert len(want) == 8 and got == want
    assert set(out) == {"edit"} and len(out["edit"]) == 15
    # the mask frames the script computes inline, and its preserved frames
    start, length, m0, m1 = qc.mask_geometry(500, 50)
    assert (start, length, m0, m1) == (0.3 * 10.0, 0.4 * 10.0, 150, 350)
    keep = qc.preserved_frames(500, 50, m0, m1)
    assert keep.sum() == 500 - 200 - 2 * 42


@pytest.fixture
def tiny_controlnet(tmp_path):
    """A depth-2 mid EzAudio with the ControlNet blocks at 2 s windows
    (the conditioner's 200 frames halve to the 100 latent frames)."""
    import chip_smoke as cs

    with cs.controlnet_window(2.0):
        ez, _, _, _ = mc.build_mid_ezaudio(2, 64, 1, 100, with_controlnet=True, device="cpu",
                                           vae_config=TINY_MID_VAE)
        data = dict(mu=0.0, sd=1.0, **mc._text(ez))
        a = qc.parse_args(["--frames", "100", "--batch", "2", "--cache-root", str(tmp_path)])
        yield qc.Harness(ez, data, a)


def test_controlnet_starts_from_zero_projections(tiny_controlnet):
    """The harness's start and the public path's: ``EzAudioControlNet(base=,
    zero_projections=True)`` has its projections and ``mask_embed`` zeroed
    (the default keeps the seeded draw, F6), scale 1 gives scale 0's output,
    and one ``make_controlnet_train_step`` step moves the zero blocks."""
    import chip_smoke as cs
    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.models.controlnet import SHARED_WITH_BASE
    from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step

    h = tiny_controlnet

    def zeroed(cn):
        pre = cn.controlnet.controlnet_pre
        return [pre.mask_embed] + [p for m in [pre.conv_out, *cn.controlnet.controlnet_zero_blocks]
                                   for p in m.parameters()]

    assert all(p.any() for p in zeroed(EzAudioControlNet(base=h.ez)))  # the seeded default
    cn = h.controlnet()
    assert zeroed(cn) and all(not p.any() for p in zeroed(cn))
    base = h.ez.dit.model.state_dict()
    for name in SHARED_WITH_BASE:  # copied from the base, kept
        mine = getattr(cn.controlnet, name)
        if mine is not None:
            for k, v in mine.state_dict().items():
                assert torch.equal(v, base[f"{name}.{k}"]), (name, k)
    rng = np.random.default_rng(3)
    cls, lat, cond = h.controlnet_data(cn, rng, 4)
    start = cs.controlnet_outputs(cn, h.data, cond, 100)
    assert torch.equal(start[0], start[1])
    curve = h.train_controlnet(cn, h.ez.noise_scheduler, 2, rng, cls, lat, cond)
    assert [s for s, _ in curve] == [0, 1] and all(np.isfinite(m) for _, m in curve)
    trained = cs.controlnet_outputs(cn, h.data, cond, 100)
    assert (trained[0] - trained[1]).abs().max() > 0
    assert not cn.controlnet.training

    # the public path alone: the API's option, then one step of the trainer
    pub = EzAudioControlNet(base=h.ez, zero_projections=True)
    start = cs.controlnet_outputs(pub, h.data, cond, 100)
    assert torch.equal(start[0], start[1])
    step = make_controlnet_train_step(h.ez.dit, pub.controlnet, h.ez.noise_scheduler,
                                      learning_rate=1e-3, warmup=0)
    idx = np.arange(2)
    step({"latents": torch.as_tensor(lat[idx]), "condition": torch.as_tensor(cond[idx]),
          "text": torch.as_tensor(h.data["cond_emb"][cls[idx]]),
          "text_mask": torch.as_tensor(h.data["cond_mask"][cls[idx]])}, seed=0)
    # the zero blocks move; conv_out's gradient passes through them, zero
    # at this first step (as in JAX)
    for m in pub.controlnet.controlnet_zero_blocks:
        assert m.weight.abs().max() > 0 and m.bias.abs().max() > 0
    moved = cs.controlnet_outputs(pub, h.data, cond, 100)
    assert (moved[0] - moved[1]).abs().max() > 0


def test_zero_projections_zero_what_the_jax_init_zeroes():
    """Among the ControlNet's own parameters (those not copied from the
    base), ``zero_projections_`` zeroes exactly the leaves the JAX
    package's init (flax, its own initializers) writes as zeros."""
    from ezaudio_tpu.models.controlnet import controlnet_from_config as jax_cn_from_config
    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.convert.from_jax import controlnet_state_dict_from_jax
    from ezaudio_tpu_torch.models.controlnet import (SHARED_WITH_BASE, controlnet_from_config,
                                                      zero_projections_)
    from tests.test_torch_finetune import CN_CFG
    from tests.test_torch_training import MODEL

    B, L, C, LC, CTX = 1, 20, 8, 6, 32
    model = jax_cn_from_config(MODEL, CN_CFG)
    params = jax.jit(lambda k: model.init(
        {"params": k, "mask": k}, jnp.zeros((B, L, 2 * C + 1)), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, LC, CTX)), condition=jnp.zeros((B, 2 * L, 1))))(
            jax.random.PRNGKey(0))["params"]
    zero_in_jax = controlnet_state_dict_from_jax(
        jax.tree.map(lambda v: np.full(v.shape, float(np.any(v)), np.float32), params),
        MODEL, CN_CFG)
    cn = controlnet_from_config(MODEL, CN_CFG)
    zero_projections_(init_random_(cn, torch.Generator().manual_seed(0)))
    own = [n for n, _ in cn.named_parameters() if n.split(".", 1)[0] not in SHARED_WITH_BASE]
    want = sorted(n for n in own if not zero_in_jax[n].any())
    got = sorted(n for n, p in cn.named_parameters() if n in own and not p.any())
    assert got == want and "controlnet_pre.mask_embed" in got


# ---------------------------------------------------------------------------
# (vi) checkpoint verification on the reference-format fixtures
def _fixture_sd(name):
    return {k[len("sd."):]: torch.tensor(v) for k, v in load(name).items()
            if k.startswith("sd.")}


VAE_CFG = dict(  # the fixture's geometry (tests/test_export.py)
    model_type="autoencoder", sample_rate=800, audio_channels=1,
    model=dict(
        encoder=dict(type="oobleck", config=dict(in_channels=1, channels=8, c_mults=[1, 2],
                                                  strides=[2, 4], latent_dim=8, use_snake=True)),
        decoder=dict(type="oobleck", config=dict(out_channels=1, channels=8, c_mults=[1, 2],
                                                  strides=[2, 4], latent_dim=4, use_snake=True,
                                                  final_tanh=False)),
        bottleneck=dict(type="vae"), latent_dim=4, downsampling_ratio=8, io_channels=1))


@pytest.fixture(scope="module")
def checkpoint_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    vae = {}
    for k, v in load("vae_tiny.npz").items():
        for src, dst in (("enc.layers.", "autoencoder.encoder.layers."),
                         ("dec.layers.", "autoencoder.decoder.layers.")):
            if k.startswith(src):
                vae[dst + k[len(src):]] = torch.tensor(v)
    files = dict(dit=({"model": _fixture_sd("maskdit_tiny.npz")}),
                 vae=({"state_dict": vae}), controlnet=({"model": _fixture_sd(
                     "controlnet_tiny.npz")}))
    paths = {}
    for name, obj in files.items():
        paths[name] = str(d / f"{name}.pt")
        torch.save(obj, paths[name])
    return paths


def _jax_draws(monkeypatch):
    """``utils.randn`` replaced by the JAX script's bf16 draws (one key)."""
    def randn(shape, generator, device, dtype=torch.float32):
        x = jax.random.normal(jax.random.PRNGKey(0), tuple(shape), jnp.bfloat16)
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(device=device, dtype=dtype)

    monkeypatch.setattr(utils, "randn", randn)


def test_verify_reports_match_jax(checkpoint_files, monkeypatch):
    from tests.test_controlnet import TINY_CN
    from tests.test_dit import TINY_MODEL

    (jvc,) = _scripts("verify_checkpoints")
    _jax_draws(monkeypatch)
    p = checkpoint_files
    want = jvc.verify_dit(p["dit"], TINY_MODEL, context_len=7)
    got = vc.verify_dit(p["dit"], TINY_MODEL, context_len=7, device="cpu")
    assert set(got) == set(want)
    for k in ("converted_params", "reference_tensors", "count_ok", "t_conditioning_live",
              "finite"):
        assert got[k] == want[k], k
    with monkeypatch.context() as mp:  # the same run in f32
        mp.setattr(utils, "cast_params_", lambda module, dtype: module)
        randn = utils.randn
        mp.setattr(utils, "randn", lambda shape, g, dev, dtype: randn(shape, g, dev))
        f32 = vc.verify_dit(p["dit"], TINY_MODEL, context_len=7, device="cpu")
    ref = f32["t_conditioning_delta"]
    assert abs(got["t_conditioning_delta"] - ref) <= BF16_REF_FACTOR * abs(
        want["t_conditioning_delta"] - ref)
    want = jvc.verify_vae(p["vae"], VAE_CFG, num_blocks=2, sine_seconds=0.5)
    got = vc.verify_vae(p["vae"], VAE_CFG, sine_seconds=0.5, device="cpu")
    assert set(got) == set(want)
    for k in ("converted_params", "reference_tensors", "roundtrip_ok", "finite"):
        assert got[k] == want[k], k
    assert abs(got["roundtrip_si_sdr_db"] - want["roundtrip_si_sdr_db"]) <= SDR_ATOL
    assert (vc.verify_controlnet(p["controlnet"], TINY_MODEL, TINY_CN)
            == jvc.verify_controlnet(p["controlnet"], TINY_MODEL, TINY_CN))


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_verify_refuses_a_missing_or_extra_tensor(tmp_path, fault):
    from tests.test_dit import TINY_MODEL

    sd = _fixture_sd("maskdit_tiny.npz")
    key = "model.final_layer.linear.weight" if "model.final_layer.linear.weight" in sd else \
        sorted(sd)[0]
    if fault == "missing":
        sd.pop(key)
    else:
        key = "model.extra.weight"
        sd[key] = torch.zeros(3)
    path = str(tmp_path / "dit.pt")
    torch.save({"model": sd}, path)
    with pytest.raises(RuntimeError, match=key.replace(".", r"\.")):
        vc.verify_dit(path, TINY_MODEL, context_len=7, device="cpu")


# ---------------------------------------------------------------------------
# (vii) the calibrations on a reduced grid
@pytest.mark.parametrize("name", ["calibrate_pesq_mnru", "calibrate_nsim_mnru"])
def test_calibration_matches_jax_on_a_reduced_grid(name, monkeypatch):
    (jcal,) = _scripts(name)
    monkeypatch.setattr(jcal, "QS", (10, 25))
    monkeypatch.setattr(jcal, "N_REFS", 1)
    outs = []
    for fn in (jcal.main, lambda: {"calibrate_pesq_mnru": cal_pesq,
                                   "calibrate_nsim_mnru": cal_nsim}[name].main(
            ["--qs", "10,25", "--n-refs", "1", "--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n| ") >= 3


def test_calibration_defaults_are_the_scripts():
    a = cal_pesq.parse_args(["--device", "cpu"])
    (jp, jn) = _scripts("calibrate_pesq_mnru", "calibrate_nsim_mnru")
    assert a.qs == jp.QS == jn.QS and a.n_refs == jp.N_REFS == jn.N_REFS
    assert cal_pesq.FS == jp.FS and [cal_pesq.anchor_mos(q) for q in a.qs] == [
        jp.anchor_mos(q) for q in a.qs]


# ---------------------------------------------------------------------------
# (viii) the mains at the scripts' CPU-smoke knobs
def _seed_fit_cache(root):
    """The fitted VAE served from the cache (a fit step costs ~10 s here)."""
    from ezaudio_tpu_torch.validation.quality_validate_mid import make_vae

    facade, _, _ = make_vae("cpu", TINY_MID_VAE)
    mc._save_params(str(root / "mid_vae" / "s1_b4"), facade.model.state_dict(), {"steps": 1})


def test_edit_controlnet_main_prints_every_row(tmp_path, capsys):
    import chip_smoke as cs

    _seed_fit_cache(tmp_path)
    with cs.controlnet_window(2.0):
        out = qc.main(["--device", "cpu", "--depth", "2", "--dim", "64", "--frames", "100",
                       "--train-steps", "3", "--cn-steps", "2", "--n-train", "8",
                       "--n-edit", "2", "--n-same", "2", "--n-cn-train", "4", "--n-cn-eval", "1",
                       "--edit-steps", "2", "--batch", "2", "--vae-steps", "1",
                       "--cache-root", str(tmp_path)], vae_config=TINY_MID_VAE)
    text = capsys.readouterr().out
    rows = _table(text)
    assert len(rows) == 2 + 7 + 2  # two headers, 7 editing rows, 2 ControlNet rows
    assert set(out) == {"edit", "controlnet"}
    assert np.isfinite(list(out["edit"].values()) + list(out["controlnet"].values())).all()


def test_verify_main_prints_every_report(checkpoint_files, capsys):
    from tests.test_controlnet import TINY_CN
    from tests.test_dit import TINY_MODEL

    p = checkpoint_files
    reports = vc.main(["--dit", p["dit"], "--vae", p["vae"], "--controlnet", p["controlnet"],
                       "--device", "cpu"], config=dict(model=TINY_MODEL, controlnet=TINY_CN),
                      vae_config=VAE_CFG)
    out = capsys.readouterr().out
    assert set(reports) == {"vae", "dit", "controlnet"}
    for what in ("VAE params:", "VAE round-trip SI-SDR", "DiT params:", "DiT t-conditioning",
                 "ControlNet params:"):
        assert what in out
    if not torch.cuda.is_available():  # no --device: the card, or a refusal
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vc.main(["--dit", p["dit"]])
