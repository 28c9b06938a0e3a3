"""The port's bottlenecks (``ezaudio_tpu_torch/codecs/bottlenecks.py``) on
the CPU against the JAX package's: the same inputs (and, for the RVQ, the
same carried weights; for the MMD, the same noise) give the same outputs,
within 1e-6 (f32 elementwise work, sums in another order), codes equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.codecs import bottlenecks as jb
from ezaudio_tpu_torch.codecs import bottlenecks as tb
from ezaudio_tpu_torch.convert.from_jax import rvq_state_dict_from_jax

TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_tanh_and_l2(rng):
    x = (3 * rng.standard_normal((2, 8, 4))).astype(np.float32)
    for J, T in ((jb.TanhBottleneck, tb.TanhBottleneck), (jb.L2Bottleneck, tb.L2Bottleneck)):
        got, info = T().encode(torch.from_numpy(x))
        assert info == {}
        _close(got, J().encode(jnp.asarray(x))[0])
        _close(T().decode(got), J().decode(jnp.asarray(got.numpy())))
    z, _ = tb.L2Bottleneck().encode(torch.from_numpy(x))
    np.testing.assert_allclose(z.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_wasserstein_mmd_matches_jax_on_the_same_noise(rng):
    x = rng.standard_normal((1, 64, 8)).astype(np.float32)
    noise = rng.standard_normal((64, 8)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(noise))
        _, want = jb.WassersteinBottleneck().encode(jnp.asarray(x), key=jax.random.PRNGKey(0),
                                                    return_info=True)
    w = tb.WassersteinBottleneck()
    out, info = w.encode(torch.from_numpy(x), noise=torch.from_numpy(noise), return_info=True)
    _close(out, x)
    _close(info["mmd"], want["mmd"], 1e-5)
    assert w.encode(torch.from_numpy(x))[1] == {}  # no draw asked for
    gen = torch.Generator().manual_seed(0)
    _, near = w.encode(torch.from_numpy(x), generator=gen, return_info=True)
    _, far = w.encode(torch.from_numpy(x) + 3.0, generator=gen, return_info=True)
    assert near["mmd"] < far["mmd"]


def test_rvq_bottleneck_matches_jax(rng):
    kw = dict(input_dim=8, n_codebooks=2, codebook_size=16, codebook_dim=4)
    jm = jb.RVQBottleneck(**kw)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)
    enc = lambda m, v: m.encode(v)  # noqa: E731
    params = jax.device_get(jax.jit(lambda k, v: jm.init(k, v, method=enc))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    zq, info = jm.apply(params, jnp.asarray(x), method=enc)
    m = tb.RVQBottleneck(**kw)
    m.rvq.load_state_dict(rvq_state_dict_from_jax(params["params"]["rvq"]), strict=True)
    with torch.no_grad():
        got, ginfo = m.encode(torch.from_numpy(x))
        dec = m.decode_tokens(ginfo["codes"])
    np.testing.assert_array_equal(ginfo["codes"].numpy(), np.asarray(info["codes"]))
    _close(got, zq, 1e-5)
    _close(dec, got, 1e-5)
    for k in ("commitment_loss", "codebook_loss"):
        _close(ginfo[k], info[k], 1e-5)


@pytest.mark.parametrize("levels", [(8, 5, 5, 5), (8, 5, 2), (2, 3, 4)])
def test_fsq_matches_jax(rng, levels):
    x = (2 * rng.standard_normal((2, 12, len(levels)))).astype(np.float32)
    jm, m = jb.FSQBottleneck(levels=levels), tb.FSQBottleneck(levels=levels)
    want, winfo = jm.encode(jnp.asarray(x))
    got, info = m.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(info["codes"].numpy(), np.asarray(winfo["codes"]))
    _close(got, want)
    assert got.abs().max() <= 1.0 and info["codes"].max() < np.prod(levels)
    _close(m.decode_tokens(info["codes"]), jm.decode_tokens(winfo["codes"]))
    _close(m.decode_tokens(info["codes"]), got)
    # straight-through: the gradient is the bound's
    xt = torch.from_numpy(x).requires_grad_()
    m.encode(xt)[0].sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jm.encode(v)[0]))(jnp.asarray(x))
    _close(xt.grad, jg, 1e-5)


class TestFSQBinaryLevel:
    def test_binary_channel_not_collapsed(self):
        """A level of 2 keeps both codes (the arctanh shift would pin it)."""
        fsq = tb.FSQBottleneck(levels=(8, 5, 2))
        z = torch.from_numpy(np.stack([np.full((4, 3), -3.0), np.full((4, 3), 3.0)])).float()
        b = fsq._bound(z)
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(jb.FSQBottleneck((8, 5, 2))._bound(
            jnp.asarray(z.numpy()))), atol=TOL)
        assert not torch.equal(b[0, :, 2].round(), b[1, :, 2].round())


def test_factory_and_fsq_channel_check():
    assert isinstance(tb.make_bottleneck("tanh"), tb.TanhBottleneck)
    assert isinstance(tb.make_bottleneck("wasserstein"), tb.WassersteinBottleneck)
    fsq = tb.make_bottleneck("fsq", levels=(4, 4))
    assert isinstance(fsq, tb.FSQBottleneck)
    with pytest.raises(ValueError, match="2 channels"):
        fsq.encode(torch.zeros(1, 3, 5))
