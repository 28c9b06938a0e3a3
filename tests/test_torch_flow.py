"""Rectified flow on the CPU against the JAX package: ``FlowSchedule``'s
grid, ``flow_sample`` (Euler and Heun, CFG with rescale) and
``flow_matching_loss`` on MaskDiT, on the weights of
``test_torch_training``'s seeded JAX MaskDiT carried through the weight map.

Limits: the grid equal; the samples within 1e-5 of the output's range (a
few f32 model calls, summed in another order); the loss rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.diffusion import flow as jflow
from ezaudio_tpu_torch.diffusion import flow
from tests.test_torch_training import MODEL, _jax_params, _port

B, L, C, LC, CTX = 2, 40, 8, 6, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    return _jax_params(MODEL, 21)


class TestFlow:
    @pytest.mark.parametrize("shift", [1.0, 3.0])
    def test_grid(self, shift):
        np.testing.assert_array_equal(flow.FlowSchedule(shift=shift).timesteps(7),
                                      jflow.FlowSchedule(shift=shift).timesteps(7))

    @pytest.mark.parametrize("method", ["euler", "heun"])
    def test_sample_with_cfg_matches_jax(self, base, rng, method):
        jmodel, params = base
        dit = _port(MODEL, params).eval()
        text = rng.standard_normal((B, LC, CTX)).astype(np.float32)
        ctx = np.concatenate([text, np.zeros_like(text)])
        noise = rng.standard_normal((B, L, C)).astype(np.float32)
        kw = dict(num_steps=3, guidance_scale=3.0, guidance_rescale=0.5, method=method)

        def jfn(x, t):
            return jmodel.apply({"params": params}, x, jnp.broadcast_to(t, (x.shape[0],)),
                                jnp.asarray(ctx))[0]

        want = np.asarray(jax.jit(lambda n: jflow.flow_sample(
            jfn, jflow.FlowSchedule(shift=3.0), n, **kw))(jnp.asarray(noise)))
        with torch.no_grad():
            got = flow.flow_sample(lambda x, t: dit(x, t, torch.from_numpy(ctx))[0],
                                   flow.FlowSchedule(shift=3.0), torch.from_numpy(noise), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.ptp(want))

    def test_loss_matches_jax(self, base, rng):
        jmodel, params = base
        dit = _port(MODEL, params)
        text = rng.standard_normal((B, LC, CTX)).astype(np.float32)
        x0, noise = (rng.standard_normal((B, L, C)).astype(np.float32) for _ in range(2))
        t = np.array([0.2, 0.9], np.float32)
        mask = (rng.uniform(size=(B, L, C)) < 0.6).astype(np.float32)
        sched = jflow.FlowSchedule(num_train_timesteps=1000)

        def japply(p, xt, ts, rngs=None, **kw):
            return jmodel.apply({"params": p}, xt, ts, jnp.asarray(text))

        want = jax.jit(lambda *a: jflow.flow_matching_loss(japply, params, *a[:3], mask=a[3],
                                                           schedule=sched))(
            jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t), jnp.asarray(mask))
        loss = flow.flow_matching_loss(lambda xt, ts: dit(xt, ts, torch.from_numpy(text)),
                                       torch.from_numpy(x0), torch.from_numpy(noise),
                                       torch.from_numpy(t), mask=torch.from_numpy(mask),
                                       schedule=flow.FlowSchedule(num_train_timesteps=1000))
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        grads = torch.autograd.grad(loss, list(dit.parameters()), allow_unused=True)
        assert sum(g is not None and bool(g.abs().max() > 0) for g in grads) > 10
