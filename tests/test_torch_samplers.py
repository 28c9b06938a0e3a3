"""The port's fast samplers against the JAX package on the CPU: DPM-Solver++
(2M), the guidance band, layer caching (DDIM and DPM), cfg_refresh and the
distilled sampler, each against its JAX function with the same closure
model and the same noise (latents atol 1e-5); and UDiT's layer-cache split
against JAX MaskDiT on carried weights.  The EzAudio-level sampler
arguments are held against JAX ``EzAudio`` in ``test_torch_pipeline.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax
from tests.test_torch_modules import _np_tree
from tests.tiny_config import TINY_CONFIG

B, L, C = 2, 6, 4
W = np.random.default_rng(21).uniform(0.5, 1.5, (2 * B, 1, C)).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedules():
    from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule

    return (JaxSchedule.from_config(TINY_CONFIG["diff"]),
            DDIMSchedule.from_config(TINY_CONFIG["diff"]))


def _models(lib):
    """A CFG-aware, time-dependent, nonlinear v-model (cond rows of W on a
    single batch, ``[cond; uncond]`` rows on the pair) and its layer-cache
    pair: the full call returns ``deep = 0.5 x``, a cached call adds
    ``0.2 deep`` of the group head's input."""
    if lib is jnp:
        def model(x, t):
            return 0.3 * x * jnp.asarray(W[:x.shape[0]]) + 0.1 * jnp.tanh(x) + t / 1000.0
    else:
        def model(x, t):
            return 0.3 * x * torch.from_numpy(W[:x.shape[0]]) + 0.1 * torch.tanh(x) + t / 1000.0

    def full(x, t):
        return model(x, t), 0.5 * x

    def cached(x, t, deep):
        return model(x, t) + 0.2 * deep

    return model, full, cached


def _noise(seed=0):
    return np.random.default_rng(seed).standard_normal((B, L, C)).astype(np.float32)


DPM_CASES = {
    "cfg": dict(guidance_scale=3.0, guidance_rescale=0.5),
    "no_cfg": dict(),
    "band": dict(guidance_scale=3.0, guidance_interval=(300.0, 800.0)),
    "refresh2_band": dict(guidance_scale=3.0, guidance_rescale=0.3,
                          guidance_interval=(300.0, 800.0), cfg_refresh_interval=2),
    "refresh3": dict(guidance_scale=3.0, cfg_refresh_interval=3),
    "cache2_band_refresh2": dict(guidance_scale=3.0, cache_interval=2,
                                 guidance_interval=(300.0, 800.0), cfg_refresh_interval=2),
    "cache3_rescale": dict(guidance_scale=3.0, guidance_rescale=0.5, cache_interval=3),
}


@pytest.mark.parametrize("case", list(DPM_CASES))
def test_dpm_matches_jax(case):
    """9 steps (a partial cache group at the end): latents atol 1e-5."""
    from ezaudio_tpu.diffusion.dpm import dpm_solver_sample as jax_dpm
    from ezaudio_tpu_torch.diffusion.dpm import dpm_solver_sample

    kw = dict(DPM_CASES[case])
    js, ts = _schedules()
    noise = _noise(1)
    jm, jfull, jcached = _models(jnp)
    tm, tfull, tcached = _models(torch)
    jkw, tkw = dict(kw), dict(kw)
    if "cache_interval" in kw:
        jkw["layer_cache_fns"], tkw["layer_cache_fns"] = (jfull, jcached), (tfull, tcached)
    want = np.asarray(jax_dpm(jm, js, jnp.asarray(noise), 9, **jkw))
    got = dpm_solver_sample(tm, ts, torch.from_numpy(noise), 9, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


DDIM_CASES = {
    "band": dict(guidance_scale=3.0, guidance_rescale=0.5, guidance_interval=(300.0, 800.0)),
    "cache2_band": dict(cache_interval=2, guidance_scale=3.0,
                        guidance_interval=(300.0, 800.0)),
    "cache3_remainder": dict(cache_interval=3, guidance_scale=3.0, guidance_rescale=0.5),
    "cache2_no_cfg": dict(cache_interval=2),
}


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_ddim_band_and_layer_cache_match_jax(case, eta):
    """8 steps; at eta 1 with the JAX fold_in draws injected (ROADMAP F1).
    Latents atol 1e-5 at eta 0; 1e-4 at eta 1, where the JAX f32 loop
    itself lies up to 6e-5 from a float64 run of it (TestDDIM)."""
    from ezaudio_tpu.diffusion.sampling import sample_latents as jax_sample
    from ezaudio_tpu.diffusion.sampling import sample_latents_layer_cached as jax_cached
    from ezaudio_tpu_torch.diffusion.sampling import (sample_latents,
                                                      sample_latents_layer_cached)

    kw, steps = dict(DDIM_CASES[case]), 8
    js, ts = _schedules()
    noise = _noise(2)
    key = jax.random.PRNGKey(7)
    draws = [np.array(jax.random.normal(jax.random.fold_in(key, i), noise.shape))
             for i in range(steps)]
    jm, jfull, jcached = _models(jnp)
    tm, tfull, tcached = _models(torch)
    interval = kw.pop("cache_interval", None)
    if interval is None:
        want = jax_sample(jm, js, jnp.asarray(noise), key, steps, eta=eta, **kw)
        got = sample_latents(tm, ts, torch.from_numpy(noise), steps, eta=eta,
                             step_noise=lambda i: torch.from_numpy(draws[i]), **kw)
    else:
        want = jax_cached(jfull, jcached, js, jnp.asarray(noise), key, steps,
                          cache_interval=interval, eta=eta, **kw)
        got = sample_latents_layer_cached(
            tfull, tcached, ts, torch.from_numpy(noise), steps, cache_interval=interval,
            eta=eta, step_noise=lambda i: torch.from_numpy(draws[i]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 if eta == 0 else 1e-4)


def test_distilled_matches_jax():
    """Tables equal; 4 student steps from the same noise: atol 1e-5."""
    from ezaudio_tpu.diffusion.distill import distill_tables as jax_tables
    from ezaudio_tpu.diffusion.distill import distilled_sample as jax_distilled
    from ezaudio_tpu_torch.diffusion.distill import distill_tables, distilled_sample

    js, ts = _schedules()
    jt, tt = jax_tables(js, 4), distill_tables(ts, 4)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, np.asarray(b))
    noise = _noise(3)
    want = jax_distilled(_models(jnp)[0], js, jnp.asarray(noise), jt)
    got = distilled_sample(_models(torch)[0], ts, torch.from_numpy(noise), tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_band_helpers_match_jax():
    from ezaudio_tpu.diffusion import sampling as jax_sampling
    from ezaudio_tpu_torch.diffusion import sampling

    ts = _schedules()[1].step_tables(25)[2]
    for band in (None, (300.0, 800.0), (2000.0, 3000.0), (float(ts[3]), float(ts[3]))):
        for cfg_on in (True, False):
            got = sampling.guidance_band(ts, 25, cfg_on, band)
            np.testing.assert_array_equal(
                got, jax_sampling.guidance_band(ts, 25, cfg_on, band))
            assert (list(sampling.equal_flag_runs(got))
                    == list(jax_sampling.equal_flag_runs(got)))
            np.testing.assert_array_equal(sampling.group_band(got, 2, 12),
                                          jax_sampling.group_band(got, 2, 12))
    with pytest.raises(ValueError, match="t_lo <= t_hi"):
        sampling.guidance_band(ts, 25, True, (800.0, 300.0))


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dit_pair():
    """JAX MaskDiT (tiny config, depth 4: k = 1) and the port on the same
    carried weights, every zero-initialized head pushed off zero."""
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config

    cfg = TINY_CONFIG["model"]
    jmodel = jax_maskdit(cfg)
    init = jax.jit(lambda k: jmodel.init({"params": k, "mask": k}, jnp.zeros((1, 16, 8)),
                                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 32))))
    params = {"params": _np_tree(init(jax.random.PRNGKey(0))["params"],
                                 np.random.default_rng(8))}
    model = maskdit_from_config(cfg).eval()
    model.load_state_dict(maskdit_state_dict_from_jax(params["params"], cfg))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 32)).astype(np.float32)
    return jmodel, params, model, x, ctx


def test_layer_cache_split_exact_and_matches_jax(dit_pair):
    """Port: the cached forward fed the just-collected deep activation is
    bit-identical to the full forward, and collecting leaves the full
    output unchanged.  Against JAX on carried weights (atol 1e-4, as the
    MaskDiT forward): the full output, the deep activation, and a cached
    forward at another timestep."""
    jmodel, params, model, x, ctx = dit_pair
    t0, t1 = np.array([500, 500]), np.array([400, 400])
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        plain, _ = model(xt, torch.from_numpy(t0), ct)
        (full, deep), _ = model(xt, torch.from_numpy(t0), ct, collect_deep_k=1)
        cached, _ = model(xt, torch.from_numpy(t0), ct, deep_cache=(1, deep))
        other, _ = model(xt, torch.from_numpy(t1), ct, deep_cache=(1, deep))
    torch.testing.assert_close(cached, full, rtol=0, atol=0)
    torch.testing.assert_close(plain, full, rtol=0, atol=0)

    collect = jax.jit(lambda p, t: jmodel.apply(p, x, t, ctx, collect_deep_k=1)[0])
    use = jax.jit(lambda p, t, d: jmodel.apply(p, x, t, ctx, deep_cache=(1, d))[0])
    jfull, jdeep = collect(params, t0)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=1e-4)
    np.testing.assert_allclose(deep.numpy(), np.asarray(jdeep), atol=1e-4)
    np.testing.assert_allclose(other.numpy(), np.asarray(use(params, t1, jdeep)), atol=1e-4)
    assert np.abs(other.numpy() - full.numpy()).max() > 1e-4  # the cache is used


@pytest.mark.parametrize("kw", [dict(collect_deep_k=2), dict(deep_cache=(0, None))])
def test_layer_cache_k_out_of_range_raises(dit_pair, kw):
    _, _, model, x, ctx = dit_pair
    with pytest.raises(ValueError, match="layer cache k"):
        model(torch.from_numpy(x), 10, torch.from_numpy(ctx), **kw)
