"""The port's GAN discriminators and losses
(``ezaudio_tpu_torch/codecs/discriminator.py``) on the CPU against the JAX
package's, on carried weights drawn from a seed
(``tests/test_torch_controlnet.py::_seeded_init``): every feature map of
MPD, MSD (rate 2: every other sample) and MRD within 1e-5 of its largest magnitude (f32
convolutions and the FFT summed in another order), the losses within rtol
1e-5, and the gradients of both losses (the discriminator's parameters and
the fake input) within 1e-4 of each tensor's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu.codecs import discriminator as jd
from ezaudio_tpu_torch.codecs import discriminator as td
from ezaudio_tpu_torch.convert.from_jax import discriminator_state_dict_from_jax
from tests.test_torch_controlnet import _seeded_init

KW = dict(periods=(3,), rates=(2,), fft_sizes=(64,), sample_rate=8000)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(5)))
        jm = jd.Discriminator(**KW)
        params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 512, 1)))["params"])
    m = td.Discriminator(**KW)
    m.load_state_dict(discriminator_state_dict_from_jax(params, KW["periods"], KW["rates"],
                                                        KW["fft_sizes"]), strict=True)
    return jm, params, m


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    real = (0.3 * rng.standard_normal((2, 499, 1))).astype(np.float32)  # MPD pads 499
    return real, (0.5 * real + 0.05 * rng.standard_normal(real.shape)).astype(np.float32)


def _fmap_np(f):
    """NCHW / NCT -> the JAX package's channel-last layout."""
    return np.moveaxis(f.detach().numpy(), 1, -1)


def test_feature_maps_match_jax(pair, clips):
    jm, params, m = pair
    real, _ = clips
    want = jax.device_get(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(real)))
    with torch.no_grad():
        got = m(torch.from_numpy(real))
    assert len(got) == len(want) == 3  # MPD, MSD, MRD
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for j, (fg, fw) in enumerate(zip(g, w)):
            fg = _fmap_np(fg)
            assert fg.shape == fw.shape, (i, j)
            np.testing.assert_allclose(fg, fw, rtol=0, atol=1e-5 * max(np.abs(fw).max(), 1e-6),
                                       err_msg=f"sub {i} map {j}")


def test_losses_and_gradients_match_jax(pair, clips):
    jm, params, m = pair
    real, fake = clips

    def jlosses(p, f):
        d_fake = jm.apply({"params": p}, f)
        d_real = jm.apply({"params": p}, jnp.asarray(real))
        adv, fm = jd.generator_loss(d_fake, d_real)
        return jd.discriminator_loss(d_fake, d_real), adv, fm

    @jax.jit
    def jgrads(p, f):
        (dl, (adv, fm)), g_disc = jax.value_and_grad(
            lambda q: (lambda o: (o[0], o[1:]))(jlosses(q, f)), has_aux=True)(p)
        g_fake = jax.grad(lambda v: sum(jlosses(p, v)[1:]))(f)
        return dl, adv, fm, g_disc, g_fake

    jdl, jadv, jfm, jg_disc, jg_fake = jax.device_get(jgrads(params, jnp.asarray(fake)))
    want = discriminator_state_dict_from_jax(jax.device_get(jg_disc), KW["periods"],
                                             KW["rates"], KW["fft_sizes"])

    f = torch.from_numpy(fake).requires_grad_()
    d_fake, d_real = m(f), m(torch.from_numpy(real))
    dl = td.discriminator_loss(d_fake, d_real)
    adv, fm = td.generator_loss(d_fake, d_real)
    for got, w in ((dl, jdl), (adv, jadv), (fm, jfm)):
        np.testing.assert_allclose(got.item(), float(w), rtol=1e-5)
    names, ps = zip(*m.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(dl, ps, retain_graph=True)))
    for n, g in grads.items():
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-8),
                                   err_msg=n)
    (gf,) = torch.autograd.grad(adv + fm, f)
    w = np.asarray(jg_fake)
    np.testing.assert_allclose(gf.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    # feature matching reads the real maps without their gradient, and is 0
    # on equal inputs
    assert td.generator_loss(d_real, d_real)[1].item() == 0.0
