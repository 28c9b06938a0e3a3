"""The quality-validation harnesses of the port (``ezaudio_tpu_torch/validation/``)
against the JAX harnesses in ``scripts/`` on the CPU.

  (i)   the numpy helpers bit-equal to the scripts' own;
  (ii)  ``encode_dataset`` through a tiny VAE carried from JAX: latents
        within ENCODE_ATOL of JAX's;
  (iii) a tiny MaskDiT carried across (f32, highest matmul precision): the
        rows composed as the scripts compose them (DDIM at eta 1 with JAX's
        step draws injected, DPM, layer_cache, guidance_interval, int8 with
        ``MIN_QUANT_ELEMENTS`` 0) give latents within ROW_TOL of scale of
        the JAX calls and FD within FD_RTOL (int8: the ``INT8_*`` limits,
        every linear through the int8 product at every step, and the f32 row
        past INT8_MEDIAN_TOL as a control), the readout's classes equal;
  (iv)  the parameter cache round-trips bit for bit, and the cache key
        follows the VAE fingerprint;
  (v)   each module's ``main`` on ``--device cpu`` at the scripts' CPU-smoke
        knobs prints every row.  The smokes check plumbing: every sampler's
        step count is capped at SMOKE_STEPS, and the mid harness runs a tiny
        x480 VAE (its fit served from the cache) and a tiny CLAP.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.validation import distill_validate as dv
from ezaudio_tpu_torch.validation import mid_common as mc
from ezaudio_tpu_torch.validation import quality_validate as qv
from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

ENCODE_ATOL = 1e-5   # the tiny VAE's latents, port against JAX (max |z| ~ 1)
ROW_TOL = 1e-5       # sampled latents, share of the JAX latents' largest magnitude (read 6e-7)
FD_RTOL = 1e-5       # the rows' FD, relative (read 1e-7); the readout's classes equal
# An int8 forward is discontinuous: an f32 sum taken in another order now
# and then puts an activation on the other side of a rounding boundary
# (tests/test_torch_quant.py: one forward of a tiny MaskDiT, JAX against
# the port, differs by 0.027).  Over a 4-step loop the latents read 1.6e-2
# of scale and corr 0.99991, the FD 2.5e-3 relative.
INT8_ROW_TOL, INT8_MIN_CORR, INT8_FD_RTOL = 5e-2, 0.999, 2e-2
# Those limits hold the port's f32 row too (1.8e-2, corr 0.99989 against
# JAX's int8 row): the median of |port - JAX| over the latents, as a share
# of scale, tells the two apart.  The port's int8 row reads 1.1e-3, its f32
# row 3.0e-3; the int8 row must lie within the limit and the f32 row past it.
INT8_MEDIAN_TOL = 2e-3
SMOKE_STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripts():
    """The JAX harnesses, imported as oracles; their import points JAX's
    compile cache at the repo root, which is put back."""
    cache = jax.config.jax_compilation_cache_dir
    try:
        from scripts import quality_validate as jqv
        from scripts import quality_validate_mid as jqvm
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return jqv, jqvm


# ---------------------------------------------------------------------------
# (i) numpy helpers
def test_numpy_helpers_bit_equal():
    jqv, jqvm = _scripts()
    a, b = qv.make_batch(np.random.default_rng(3), 5), jqv.make_batch(np.random.default_rng(3), 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(qv.features(a[0]), jqv.features(a[0]))
    for cls in range(4):
        np.testing.assert_array_equal(qvm.synth_clip(np.random.default_rng(cls), cls, 4800, 24000),
                                      jqvm.synth_clip(np.random.default_rng(cls), cls, 4800,
                                                      24000))
    cls = np.array([3, 0, 2, 1, 1])
    np.testing.assert_array_equal(qvm.class_text(cls), jqvm.class_text(cls))
    lat = np.random.default_rng(4).standard_normal((6, 500, 8)).astype(np.float32)
    np.testing.assert_array_equal(qvm.latent_class(lat), jqvm.latent_class(lat))
    np.testing.assert_array_equal(qvm.features(lat), jqvm.features(lat))
    from ezaudio_tpu_torch.models.clap import ClapConfig

    texts = mc.PROMPTS + ["", "A Dog barking"]
    for x, y in zip(qvm._crc_tokenizer(ClapConfig())(texts),
                    jqvm._crc_tokenizer(ClapConfig())(texts)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# (ii) the dataset encode
def test_encode_dataset_matches_jax():
    from ezaudio_tpu.codecs.facade import AutoencoderFacade as JaxFacade
    from ezaudio_tpu.codecs.oobleck import vae_from_config as jax_vae
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
    from ezaudio_tpu_torch.convert.from_jax import vae_state_dict_from_jax
    from tests.test_torch_modules import seeded_params
    from tests.tiny_config import TINY_SR, TINY_VAE_CONFIG

    _, jqvm = _scripts()
    jmodel = jax_vae(TINY_VAE_CONFIG, dtype=jnp.float32)
    r = jmodel.downsampling_ratio
    params = seeded_params(jmodel, np.random.default_rng(5), jnp.zeros((1, 4 * r, 1)))["params"]
    model = vae_from_config(TINY_VAE_CONFIG).eval()
    model.load_state_dict(vae_state_dict_from_jax(jax.device_get(params)))
    want, wcls = jqvm.encode_dataset(3, 1, JaxFacade(jmodel, params), TINY_SR, r)
    got, gcls = qvm.encode_dataset(3, 1, AutoencoderFacade(model), TINY_SR, r, jqvm.FRAMES)
    np.testing.assert_array_equal(gcls, wcls)
    assert got.shape == want.shape == (3, jqvm.FRAMES, model.latent_dim)
    np.testing.assert_allclose(got, want, atol=ENCODE_ATOL)


# ---------------------------------------------------------------------------
# (iii) the rows on a carried MaskDiT
FRAMES, CH, N = 40, 4, 4


@pytest.fixture(scope="module")
def carried():
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
    from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from tests.test_torch_modules import seeded_params

    cfg = qvm.model_config(4, 32, 4, FRAMES, CH, False)
    jmodel = jax_maskdit(cfg)
    params = seeded_params(jmodel, np.random.default_rng(6), jnp.zeros((1, FRAMES, CH)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, qvm.D)))["params"]
    params = jax.device_get(params)
    model = maskdit_from_config(cfg).eval().requires_grad_(False)
    model.load_state_dict(maskdit_state_dict_from_jax(params, cfg))
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((N, FRAMES, CH)).astype(np.float32)
    cls = np.array([0, 1, 2, 3])
    ref = rng.standard_normal((3 * N, FRAMES, CH)).astype(np.float32)
    return jmodel, params, model, noise, cls, ref


def _jax_rows(jmodel, sched):
    """The scripts' composition (scripts/quality_validate_mid.py:496-536)."""
    from ezaudio_tpu.diffusion.dpm import dpm_solver_sample
    from ezaudio_tpu.diffusion.sampling import sample_latents, sample_latents_layer_cached

    G = qvm.GUIDANCE

    def apply_base(params, lat, t, ctx_pair, **kw):
        return jmodel.apply({"params": params}, lat, t, ctx_pair[:lat.shape[0]], **kw)

    def ddim(steps, interval=None):
        return lambda p, n, c: sample_latents(
            lambda lat, t: apply_base(p, lat, t, c)[0], sched, n, jax.random.PRNGKey(8), steps,
            guidance_scale=G, guidance_rescale=0.0, eta=1.0, guidance_interval=interval)

    def dpm(steps, layer_cache=None, interval=None, cfg_refresh=1):
        def builder(p, n, c):
            kw = {}
            if layer_cache is not None:
                k, m = layer_cache
                kw = dict(layer_cache_fns=(
                    lambda lat, t: apply_base(p, lat, t, c, collect_deep_k=k)[0],
                    lambda lat, t, deep: apply_base(p, lat, t, c, deep_cache=(k, deep))[0]),
                    cache_interval=m)
            return dpm_solver_sample(lambda lat, t: apply_base(p, lat, t, c)[0], sched, n, steps,
                                     guidance_scale=G, guidance_interval=interval,
                                     cfg_refresh_interval=cfg_refresh, **kw)
        return builder

    def ddim_lc(steps, k, m):
        return lambda p, n, c: sample_latents_layer_cached(
            lambda lat, t: apply_base(p, lat, t, c, collect_deep_k=k)[0],
            lambda lat, t, deep: apply_base(p, lat, t, c, deep_cache=(k, deep))[0],
            sched, n, jax.random.PRNGKey(8), steps, cache_interval=m, guidance_scale=G)

    return ddim, dpm, ddim_lc


ROWS = {  # name -> (builder, its arguments after the schedule, int8); k = 1
    "ddim_eta1_interval": ("ddim", (4, (300, 800)), False),
    "ddim_layer_cache": ("ddim_lc", (4, 1, 2), False),
    "dpm": ("dpm", (4,), False),
    "dpm_lc_gi_cfgr2": ("dpm", (4, (1, 2), (300, 800), 2), False),
    "ddim_int8": ("ddim", (4,), True),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_rows_match_jax(carried, row, monkeypatch):
    import ezaudio_tpu.ops.quant as jquant
    import ezaudio_tpu_torch.ops.quant as tquant
    from ezaudio_tpu.audio.metrics import frechet_audio_distance as jax_fad
    from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
    from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance

    _, jqvm = _scripts()
    jmodel, params, model, noise, cls, ref = carried
    kind, args, int8 = ROWS[row]
    jsched = JaxSchedule.from_config(qvm.DIFF_CFG)
    jbuilder = dict(zip(("ddim", "dpm", "ddim_lc"), _jax_rows(jmodel, jsched)))[kind](*args)
    builder = dict(ddim=qvm.ddim, dpm=qvm.dpm, ddim_lc=qvm.ddim_lc)[kind](qv.schedule(), *args)
    txt = qvm.class_text(cls)
    ctx_pair = jnp.concatenate([jnp.asarray(txt), jnp.zeros_like(txt)], 0)
    if int8:
        monkeypatch.setattr(jquant, "MIN_QUANT_ELEMENTS", 0)
        with jquant.quant_context("int8"):
            want = np.asarray(jax.jit(jbuilder)(params, jnp.asarray(noise), ctx_pair))
    else:
        want = np.asarray(jax.jit(jbuilder)(params, jnp.asarray(noise), ctx_pair))
    key = jax.random.PRNGKey(8)

    def step_noise(i, shape):  # the JAX samplers' fold_in draws (ROADMAP F1)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), shape)))

    products = []
    int8_matmul = tquant.int8_matmul
    monkeypatch.setattr(tquant, "int8_matmul",
                        lambda a, b: products.append(a.shape) or int8_matmul(a, b))

    def run(quant_int8):
        return qvm.run_config(model, builder, torch.from_numpy(noise), torch.from_numpy(txt), N,
                              quant_int8=quant_int8, step_noise=step_noise)

    got = run(int8)
    assert tquant.MIN_QUANT_ELEMENTS == 256 * 256  # restored after the row
    # one model call a step on the CFG pair: every linear quantized in each
    n_linears = sum(isinstance(m, tquant.QuantLinear) for m in model.modules())
    assert len(products) == (n_linears * args[0] if int8 else 0)
    scale = np.abs(want).max()
    fd = frechet_audio_distance(qvm.features(got), qvm.features(ref))
    jfd = float(jax_fad(jqvm.features(want), jqvm.features(ref)))
    if int8:
        assert np.abs(got - want).max() <= INT8_ROW_TOL * scale
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > INT8_MIN_CORR
        assert abs(fd - jfd) <= INT8_FD_RTOL * abs(jfd)
        f32 = run(False)
        assert len(products) == n_linears * args[0]  # the f32 row took none
        median = [float(np.median(np.abs(x - want))) / scale for x in (got, f32)]
        assert median[0] <= INT8_MEDIAN_TOL < median[1], median
    else:
        assert np.abs(got - want).max() <= ROW_TOL * scale
        assert abs(fd - jfd) <= FD_RTOL * abs(jfd)
    np.testing.assert_array_equal(qvm.latent_class(got), jqvm.latent_class(want))


# ---------------------------------------------------------------------------
# (iv) the caches
TINY_MID_VAE = dict(
    model_type="autoencoder", sample_rate=24000, audio_channels=1,
    model=dict(
        encoder=dict(type="oobleck", config=dict(in_channels=1, channels=8, c_mults=[1, 2, 2, 4],
                                                  strides=[2, 4, 6, 10], latent_dim=16,
                                                  use_snake=True)),
        decoder=dict(type="oobleck", config=dict(out_channels=1, channels=8, c_mults=[1, 2, 2, 4],
                                                  strides=[2, 4, 6, 10], latent_dim=8,
                                                  use_snake=True, final_tanh=False)),
        bottleneck=dict(type="vae"), latent_dim=8, downsampling_ratio=480, io_channels=1))


def test_param_cache_round_trip_and_key(tmp_path):
    model = qv.seeded_maskdit(dict(qv.MODEL_CFG, embed_dim=32), 3, "cpu")
    sd = model.state_dict()
    mc._save_params(str(tmp_path / "p"), sd, {"steps": 7})
    got, meta = mc._load_params(str(tmp_path / "p"))
    assert meta == {"steps": 7} and set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    args = qvm.parse_args(["--device", "cpu", "--cache-root", str(tmp_path)])
    h = qvm.MidHarness(args, "cpu", vae_config=TINY_MID_VAE)
    key = h.cache_key("diffusion", 4000, 0)
    assert key.endswith("_cpu_v" + h.fingerprint())
    with torch.no_grad():
        next(h.facade.model.parameters()).mul_(1.5)
    assert h.cache_key("diffusion", 4000, 0) != key


# ---------------------------------------------------------------------------
# (v) the mains at CPU-smoke size
def _cap(monkeypatch, module, name, index):
    """Cap the step count (positional argument ``index``) of a row builder."""
    orig = getattr(module, name)

    def capped(*a, **k):
        a = list(a)
        a[index] = min(a[index], SMOKE_STEPS)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, capped)


def _small_toy(monkeypatch):
    monkeypatch.setattr(qv, "MODEL_CFG", dict(qv.MODEL_CFG, embed_dim=32))
    monkeypatch.setattr(qv, "N_EVAL", 4)
    monkeypatch.setattr(qv, "TRAIN_BATCH", 4)
    for name in ("ddim", "dpm", "ddim_lc"):
        _cap(monkeypatch, qvm, name, 1)


def test_toy_rows_are_the_mid_rows():
    """The toy table's ten rows are built by the mid harness's builders
    (the ones test_rows_match_jax holds), layer caching at k = 1, in the
    JAX harness's order."""
    sched = qv.schedule()
    rows = qv.configs(sched)
    assert [c[0] for c in rows] == list(qv.TOY_ROWS) and len(rows) == 10
    mid = {c[0]: c for c in qvm.row_configs(sched, qv.MODEL_CFG["depth"])}
    for name, builder, recipe in rows:
        assert builder.__qualname__ == mid[name][1].__qualname__ and recipe == mid[name][2]
    assert [c[2] for c in rows if c[2]] == [{"quant_int8": True}]


def test_toy_mains_print_every_row(monkeypatch, capsys):
    _small_toy(monkeypatch)
    table = qv.main(["3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(table) == 10
    for name, (fad, acc) in table.items():
        assert f"| {name} |" in out and np.isfinite(fad) and 0.0 <= acc <= 1.0
    table = dv.main(["2", "--distill-steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(table) == list(dv.CALLS)
    assert all(f"| {name} |" in out for name in table)


def test_mid_main_prints_every_row(monkeypatch, capsys, tmp_path):
    """The scripts' CPU-smoke geometry (depth 2: no layer-cache rows, which
    test_rows_match_jax and the phase-34 rehearsal hold), 150 frames (the
    tiny VAE's readout passes the gate from there): the whole table, flow
    and distillation without the CLAP columns; then a second run with them
    on a ``--rows`` subset, which reuses the first run's cached latents and
    teacher."""
    from ezaudio_tpu_torch.models.clap import ClapAudioConfig, ClapConfig, ClapTextConfig
    from tests.test_torch_clap import AUDIO, TEXT

    for name in ("ddim", "dpm", "ddim_lc"):
        _cap(monkeypatch, qvm, name, 1)
    _cap(monkeypatch, qvm, "flow_builder", 0)
    argv = ["--device", "cpu", "--depth", "2", "--dim", "64", "--frames", "150",
            "--train-steps", "3", "--batch", "4", "--n-train", "16", "--n-eval", "8",
            "--eval-chunk", "8", "--vae-steps", "1", "--distill-steps", "2",
            "--cache-root", str(tmp_path)]
    rows, walls = qvm.main(argv + ["--clap", "0"], vae_config=TINY_MID_VAE)
    out = capsys.readouterr().out
    names = [c[0] for c in qvm.row_configs(qv.schedule(), 2)]
    names += ["flow-matching Euler-50 + CFG", "flow-matching Euler-25 + CFG",
              "distilled-8 (no CFG pair)", "distilled-4 (no CFG pair)"]
    assert [r[0] for r in rows] == names and len(names) == 12
    for name, fad, acc in rows:
        assert f"| {name} |" in out and np.isfinite([fad, acc]).all()
    assert "readout accuracy on reference latents: 1.000" in out
    assert set(walls["rows_s"]) == set(names)

    # the fitted VAE served from the cache (a fit step costs ~10 s here): the
    # seeded weights, so the latents and the teacher of the first run apply
    facade, _, _ = qvm.make_vae("cpu", TINY_MID_VAE)
    mc._save_params(str(tmp_path / "mid_vae" / "s1_b4"), facade.model.state_dict(),
                    {"steps": 1})
    clap = ClapConfig(text=ClapTextConfig(**TEXT), audio=ClapAudioConfig(**AUDIO),
                      projection_dim=20)
    rows, _ = qvm.main(argv + ["--flow", "0", "--distill", "0", "--rows", "dpm-solver"],
                       vae_config=TINY_MID_VAE, clap_config=clap)
    out = capsys.readouterr().out
    assert [r[0] for r in rows] == ["DPM-Solver++(2M)-25", "DPM-Solver++(2M)-10"]
    assert all(np.isfinite(r[1:]).all() for r in rows)
    for what in ("reusing cached fitted VAE", "reusing cached latents", "reusing cached params",
                 "| CLAP score | CLAP-FAD |"):
        assert what in out


def test_fit_keeps_the_best_smoothed_snapshot(tmp_path):
    """The fit's snapshot rule on a short crop: ``steps // 4`` onward, every
    50th step, the best EMA of mrstft; the cache then serves it."""
    facade, sr, _ = qvm.make_vae("cpu", TINY_MID_VAE)
    walls = mc.fit_vae_facade(facade, sr, steps=2, batch=1, seg_s=0.1, cache_root=str(tmp_path))
    assert len(walls) == 2
    fitted = {k: v.clone() for k, v in facade.model.state_dict().items()}
    params, meta = mc._load_params(str(tmp_path / "mid_vae" / "s2_b1"))
    assert meta["steps"] == 2 and np.isfinite(meta["best_ema_mrstft"])
    assert all(torch.equal(params[k], fitted[k]) for k in fitted)
    again, _, _ = qvm.make_vae("cpu", TINY_MID_VAE)
    assert mc.fit_vae_facade(again, sr, steps=2, batch=1, seg_s=0.1,
                             cache_root=str(tmp_path)) == []
    assert all(torch.equal(again.model.state_dict()[k], fitted[k]) for k in fitted)
