"""The codec trainer (``ezaudio_tpu_torch/training/codec_trainer.py``) on the
CPU against the JAX package's ``make_codec_train_steps``: one ``'vae'`` step
here (a tiny ``AudioVAE`` with live weight norm, its ResidualUnits through
kernel 2's wrapper, the plain twin on the CPU) and one ``'dac'`` step in
``tests/test_torch_codec_training_dac.py`` (a tiny DAC with live weight
norm and quantizer dropout), each on the same carried
weights (every leaf drawn from a seed) and the same draws: the posterior
noise and the dropout counts, injected on both sides (ROADMAP F1).

Each step runs three times: JAX's in float64 (under ``jax.enable_x64``,
its modules' ``dtype`` float64), the reference; the port's in float64 and
in f32 (its modules ``.to(dtype)``).  Limits, each with its reason:
  * float64, the port against JAX, the same function: every loss term
    within rtol ANCHOR_LOSS_RTOL, every gradient within ANCHOR_TOL of its
    scale (the tensor's largest entry, or GRAD_FLOOR times its network's
    largest where that is more), every updated parameter within
    ANCHOR_TOL lr (readings: losses 5.7e-16, gradients 4.3e-11 of scale,
    parameters 2.5e-11 lr);
  * f32 against JAX's float64: every loss term within LOSS_RTOL (reading
    2.2e-7).  At random weights the generator's gradient is
    ill-conditioned in f32 (log10 STFT magnitudes, snake alphas summed
    over time): JAX's own f32 step reads up to 2.8e-2 of a tensor's scale
    from its float64 one (a DAC decoder snake's alpha; the VAE 3.2e-3)
    and 7.0e-3 of the norm in L2 (the VAE 9.8e-4); the discriminator's is
    not (JAX's f32: 1.2e-6 of scale, 1.2e-7 in L2).  So each gradient
    within F32_GRAD_TOL of its scale and each network's gradient as one
    vector within F32_L2_TOL of its norm in L2, limits JAX's own f32 step
    meets (the port's f32 reads 7.6e-3 and 2.3e-3 in the generator,
    1.3e-6 and 2.2e-7 in the discriminator);
  * every f32 updated parameter: within 2 lr of JAX's everywhere (Adam's
    first step moves a parameter by lr g / (|g| + eps), whose sign may flip
    for a gradient near 0) and within 1e-3 lr where the float64 gradient
    exceeds 1e-4 and four times the f32 gradient's distance from it (there
    the f32 gradient has its sign, and the ratio moves by less than
    eps / |g| < 1e-4).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu.codecs.discriminator import Discriminator as JaxDisc
from ezaudio_tpu.codecs.oobleck import AudioVAE as JaxVAE
from ezaudio_tpu.training import codec_trainer as jct
from ezaudio_tpu_torch.codecs.discriminator import Discriminator
from ezaudio_tpu_torch.codecs.oobleck import AudioVAE
from ezaudio_tpu_torch.convert import from_jax
from ezaudio_tpu_torch.convert.from_jax import (discriminator_state_dict_from_jax,
                                                vae_state_dict_from_jax)
from ezaudio_tpu_torch.ops.kernels import resunit as kr
from ezaudio_tpu_torch.training import codec_trainer as tct
from tests.test_torch_controlnet import _seeded_init

VAE = dict(io_channels=1, channels=4, latent_dim=4, c_mults=(1, 2), strides=(2, 4),
           use_weight_norm=True)
DISC = dict(periods=(2,), fft_sizes=(128,), rates=(), sample_rate=8000)
STEP = dict(sample_rate=8000, gen_lr=1e-3, disc_lr=2e-3, warmup=0.0, stft_windows=(128, 64))
ANCHOR_TOL = 1e-8
ANCHOR_LOSS_RTOL = 1e-10
LOSS_RTOL = 1e-5
F32_GRAD_TOL = dict(gen=3e-2, disc=1e-5)
F32_L2_TOL = dict(gen=1e-2, disc=1e-6)
GRAD_FLOOR = 1e-4
B, T = 2, 1024


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capturing_adamw(real):
    """optax.adamw whose state also keeps the gradients it was given."""
    def make(*a, **k):
        inner = real(*a, **k)
        return optax.GradientTransformation(
            lambda p: (jax.tree.map(jnp.zeros_like, p), inner.init(p)),
            lambda g, s, p=None: (lambda u: (u[0], (g, u[1])))(inner.update(g, s[1], p)))
    return make


@contextlib.contextmanager
def _draws(noise=None, dropout=None):
    with pytest.MonkeyPatch.context() as mp:
        if noise is not None:
            mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(noise))
        if dropout is not None:
            mp.setattr(jax.random, "randint",
                       lambda key, shape, lo, hi, dtype=None: jnp.asarray(dropout))
        yield


def _weight_norm_gains(tree, rng, name=""):
    """Each weight-normed conv's ``g`` set to ``||v||`` times 1 + N(0, 0.1),
    as a fresh weight norm starts (the seeded N(0, 0.05) gains shrink the
    codec's output to ~1e-4, where its STFT magnitudes sit at the loss's
    1e-5 clamp and the gradient is not differentiable in f32 or f64); the
    transposed convs (``up``) norm per input channel."""
    if "v" in tree:
        v = np.asarray(tree["v"])
        axes = (0, 2) if name == "up" else tuple(range(v.ndim - 1))
        g = np.sqrt(np.square(v).sum(axes)) * (1 + 0.1 * rng.standard_normal(tree["g"].shape))
        return dict(tree, g=g.astype(np.float32))
    return {k: _weight_norm_gains(v, rng, k) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _jax_step64(kind, codec_cls, kw, gp, dp, audio, draws):
    """JAX's step in float64 (under ``jax.enable_x64``, the modules'
    ``dtype`` float64) from the f32 trees ``gp``/``dp``: its metrics, the
    gradients optax received and the updated parameters, as JAX holds
    them."""
    wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jct.optax, "adamw", _capturing_adamw(optax.adamw))
        step, gtx, dtx = jct.make_codec_train_steps(
            codec_cls(**kw, dtype=jnp.float64), JaxDisc(**DISC, dtype=jnp.float64),
            codec_kind=kind, **STEP)
        gp, dp = wide(gp), wide(dp)
        state = jct.CodecTrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                                    gen_opt=gtx.init(gp), disc_params=dp, disc_opt=dtx.init(dp))
        with _draws(**{k: v.astype(np.float64) if v.dtype.kind == "f" else v
                       for k, v in draws.items()}):
            state, metrics = step(state, jnp.asarray(audio, jnp.float64), jax.random.PRNGKey(1))
        state, metrics = jax.device_get((state, metrics))
    return dict(metrics=metrics, gen_grads=state.gen_opt[0], disc_grads=state.disc_opt[0],
                gen_params=state.gen_params, disc_params=state.disc_params)


def _port_names(tree, to_port, dtype):
    """``to_port`` of a JAX tree, its tensors kept in ``dtype``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(from_jax, "_t", lambda a: torch.from_numpy(np.array(a, dtype=dtype)))
        return to_port(tree)


def _run(kind, codec_cls, port_cls, kw, to_port, audio, draws, seed):
    """One step of ``kind`` from the same seeded weights and ``draws``: JAX's
    in float64, the port's in f32 and in float64.  ``({dtype: (port step,
    its output with the updated parameters)}, JAX's under the port's
    names)``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(seed)))
        key = jax.random.PRNGKey(0)
        gp = codec_cls(**kw).init({"params": key, "sample": key, "dropout": key},
                                  jnp.zeros((1, 64, 1)))["params"]
        dp = JaxDisc(**DISC).init(key, jnp.zeros((1, 512, 1)))["params"]
    rng = np.random.default_rng(seed + 1)
    gp, dp = _weight_norm_gains(jax.device_get(gp), rng), _weight_norm_gains(
        jax.device_get(dp), rng)
    to_disc = lambda t: discriminator_state_dict_from_jax(t, DISC["periods"], (),  # noqa: E731
                                                          DISC["fft_sizes"])
    codec, disc = port_cls(**kw), Discriminator(**DISC)
    codec.load_state_dict(to_port(gp), strict=True)
    disc.load_state_dict(to_disc(dp), strict=True)
    out = _jax_step64(kind, codec_cls, kw, gp, dp, audio, draws)
    conv = dict(gen=to_port, disc=to_disc)
    want = dict(metrics=out["metrics"], **{
        f"{side}_{k}": _port_names(out[f"{side}_{k}"], conv[side], np.float64)
        for side in ("gen", "disc") for k in ("grads", "params")})
    got = {}
    for dtype in (torch.float32, torch.float64):
        step = tct.make_codec_train_steps(copy.deepcopy(codec).to(dtype),
                                          copy.deepcopy(disc).to(dtype), kind, **STEP)
        tdraws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
        res = step(torch.from_numpy(audio).to(dtype), seed=0, draws=tdraws, return_grads=True)
        res.update(gen_params={n: p.detach() for n, p in step.codec.named_parameters()},
                   disc_params={n: p.detach() for n, p in step.disc.named_parameters()})
        got[dtype] = (step, res)
    return got, want


def _check_anchor(got, want):
    """The port's float64 step against JAX's: the same function."""
    assert set(got) - {"gen_grads", "disc_grads", "gen_params", "disc_params"} \
        == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=ANCHOR_LOSS_RTOL, err_msg=k)
    for side, lr in (("gen", STEP["gen_lr"]), ("disc", STEP["disc_lr"])):
        grads, wgrads = got[f"{side}_grads"], want[f"{side}_grads"]
        assert set(grads) == set(wgrads)
        least = GRAD_FLOOR * max(w.abs().max().item() for w in wgrads.values())
        for n, w in wgrads.items():
            assert w.dtype == grads[n].dtype == torch.float64, n
            scale = max(w.abs().max().item(), least)
            err = (grads[n] - w).abs().max().item()
            assert err <= ANCHOR_TOL * scale, f"float64 {side} grad {n}: {err}, scale {scale}"
        for n, p in got[f"{side}_params"].items():
            err = (p - want[f"{side}_params"][n]).abs().max().item()
            assert err <= ANCHOR_TOL * lr, f"float64 {side} parameter {n}: {err}"


def _check(got, want):
    _check_anchor(got[torch.float64][1], want)
    tstep, out = got[torch.float32]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(out[k].item(), float(v), rtol=LOSS_RTOL, err_msg=k)
    for side, lr in (("gen", STEP["gen_lr"]), ("disc", STEP["disc_lr"])):
        grads, ref = out[f"{side}_grads"], want[f"{side}_grads"]
        least = GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
        for n, r in ref.items():
            scale = max(r.abs().max().item(), least)
            err = (grads[n].double() - r).abs().max().item()
            assert err <= F32_GRAD_TOL[side] * scale, \
                f"{side} grad {n}: {err} from float64, scale {scale}"
        l2 = sum((grads[n].double() - r).square().sum() for n, r in ref.items()).sqrt()
        norm = sum(r.square().sum() for r in ref.values()).sqrt()
        assert l2 <= F32_L2_TOL[side] * norm, f"{side}: {l2} from float64 in L2, norm {norm}"
        for n, p in out[f"{side}_params"].items():
            r, w = ref[n].numpy(), want[f"{side}_params"][n].numpy()
            diff = np.abs(p.double().numpy() - w)
            assert diff.max() <= 2 * lr, n
            stable = np.abs(r) > np.maximum(1e-4, 4 * np.abs(grads[n].double().numpy() - r))
            assert diff[stable].max(initial=0) <= 1e-3 * lr, n
    assert tstep.step == 1 and tstep.gen_opt.count == tstep.disc_opt.count == 1


def _audio(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000
    a = 0.4 * np.sin(2 * np.pi * 220 * t)[None] + 0.1 * rng.standard_normal((B, T))
    return a[..., None].astype(np.float32)


def test_vae_step_matches_jax(monkeypatch):
    counted = []

    def record(x, *args):
        counted.append(x.requires_grad)
        return real(x, *args)

    real = kr.fused_residual_unit
    from ezaudio_tpu_torch.codecs import oobleck_fast
    monkeypatch.setattr(oobleck_fast, "fused_residual_unit", record)
    noise = np.random.default_rng(7).standard_normal((B, T // 8, 4)).astype(np.float32)
    got, want = _run("vae", JaxVAE, AudioVAE, VAE, vae_state_dict_from_jax, _audio(0), dict(noise=noise),
                     seed=11)
    out = got[torch.float32][1]
    assert set(out) >= {"gen/kl", "gen/mrstft", "gen/adv", "gen/fm", "disc/loss"}
    # 12 units, 6 encode and 6 decode, through the kernel's autograd wrapper,
    # in the f32 step and in the float64 one
    assert len(counted) == 24 and all(counted)
    _check(got, want)
    assert all(out["gen_grads"][n].abs().max() > 0
               for n in out["gen_grads"] if n.endswith(("weight_g", "weight_v")))


@pytest.mark.parametrize("step", [0, 1, 300, 5000])
@pytest.mark.parametrize("warmup", [0.0, 0.999])
def test_inverse_lr_matches_jax(step, warmup):
    kw = dict(base_lr=1.5e-4, inv_gamma=100.0, power=0.5, warmup=warmup)
    assert tct.inverse_lr(**kw)(step) == float(jct.inverse_lr(**kw)(jnp.asarray(step)))
    assert tct.inverse_lr(1.0, 1e9, 0.5, 0.999)(0) < 0.01


def test_vae_facade_quantization_last_matches_jax(monkeypatch):
    """``quantization_first=False``: encode returns the encoder's mean ||
    scale (kernel 2's routing on the port, flax's units on JAX, the same
    function in f32) and decode samples the posterior first, on the same
    noise (JAX's ``PRNGKey(0)`` draw injected on the port, F1)."""
    from ezaudio_tpu.codecs.facade import AutoencoderFacade as JaxFacade
    from ezaudio_tpu_torch import utils
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade

    jvae = JaxVAE(**VAE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(2)))
        params = jax.device_get(jvae.init({"params": jax.random.PRNGKey(0),
                                           "sample": jax.random.PRNGKey(0)},
                                          jnp.zeros((1, 64, 1)))["params"])
    vae = AudioVAE(**VAE)
    vae.load_state_dict(vae_state_dict_from_jax(params), strict=True)
    jf, tf = JaxFacade(jvae, params, quantization_first=False), \
        AutoencoderFacade(vae, quantization_first=False)
    audio = _audio(3)
    ms, jms = tf.encode(audio), np.asarray(jf.encode(jnp.asarray(audio)))
    assert ms.shape == (B, T // 8, 8)  # 2 * latent_dim
    np.testing.assert_allclose(ms.numpy(), jms, atol=1e-5)
    noise = jax.device_get(jax.random.normal(jax.random.PRNGKey(0), (B, T // 8, 4)))
    monkeypatch.setattr(utils, "randn", lambda shape, gen, dev, dtype=torch.float32:
                        torch.from_numpy(np.asarray(noise)).to(dev, dtype))
    want = np.asarray(jf.decode(jnp.asarray(jms)))
    np.testing.assert_allclose(tf.decode(ms).numpy(), want, atol=1e-5)
