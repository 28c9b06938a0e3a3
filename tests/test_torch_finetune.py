"""The port's ControlNet fine-tune on the CPU against the JAX package:
``make_controlnet_train_step`` with the training condition masking
(distillation is ``test_torch_distill.py``, rectified flow
``test_torch_flow.py``).

torch cannot reproduce ``jax.random`` (ROADMAP F1): the JAX draws are
replaced while JAX traces (``test_torch_training.jax_draws``) and the same
numpy draws go to the port's ``draws=``.  Every JAX leaf is drawn from a
seed by shape (``_seeded_init``), the ControlNet's zero blocks and
``conv_out`` included (F6), and the port loads them through the weight map.

Limits, each with its reason:
  * the condition masking's skips: atol 2e-5 (one f32 forward);
  * the ControlNet step's loss and grad norm: rtol 1e-5 (PR 8's
    ``train_step_agreement``); every trainable parameter after two steps
    within 4 lr (Adam moves a parameter by up to lr a step, of either sign
    where its gradient is rounding noise) and within 2e-3 lr where both
    steps' gradients exceed 1e-4 in magnitude (the ratio g / |g| is stable
    there); the base and the frozen ControlNet leaves bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
from ezaudio_tpu.models.controlnet import controlnet_from_config as jax_cn_from_config
from ezaudio_tpu.training.controlnet_trainer import (
    make_controlnet_train_step as jax_make_cn_step)
from ezaudio_tpu_torch.convert.from_jax import controlnet_state_dict_from_jax
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.models.controlnet import controlnet_from_config, trainable_mask
from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step
from tests.test_torch_controlnet import _seeded_init
from tests.test_torch_training import DIFF, MODEL, _jax_params, _port, _torch, jax_draws

B, L, C, LC, CTX = 2, 20, 8, 6, 32
CN_CFG = dict(cond_in=1, cond_blocks=[8, 16], cond_mask=True, cond_mask_prob=0.5,
              cond_mask_ratio=[0.25, 0.5], cond_mask_span=4)
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    return _jax_params(MODEL, 21)


@pytest.fixture(scope="module")
def jax_cn():
    model = jax_cn_from_config(MODEL, CN_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(22)))
        params = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                            jnp.zeros((B, L, 2 * C + 1)), jnp.zeros((B,), jnp.int32),
                            jnp.zeros((B, LC, CTX)), condition=jnp.zeros((B, 2 * L, 1)))["params"]
    assert all(np.any(a) for a in jax.tree.leaves(params))  # zero blocks too (F6)
    return model, params


def _port_cn(params):
    cn = controlnet_from_config(MODEL, CN_CFG)
    cn.load_state_dict(controlnet_state_dict_from_jax(jax.device_get(params), MODEL, CN_CFG))
    return cn


def _cn_batch(rng):
    mask = np.ones((B, LC), bool)
    mask[1, 3:] = False
    return dict(latents=rng.standard_normal((B, L, C)).astype(np.float32),
                condition=rng.uniform(0, 1, (B, 2 * L, 1)).astype(np.float32),
                text=rng.standard_normal((B, LC, CTX)).astype(np.float32), text_mask=mask)


def _cn_draws(rng):
    Lc = 2 * L  # the condition's frames
    return dict(noise=rng.standard_normal((B, L, C)).astype(np.float32),
                t=np.array([40, 730], np.int32),
                ratio=rng.uniform(0.25, 0.5, B).astype(np.float32),
                span_round=rng.uniform(size=B).astype(np.float32),
                span_scores=rng.uniform(size=(B, Lc - CN_CFG["cond_mask_span"])).astype(
                    np.float32),
                select=np.array([0.2, 0.7], np.float32))  # the first sample is masked


def _mask_uniforms(d):
    return [d["ratio"], d["span_round"], d["span_scores"], d["select"]]


def _assert_adam_params(got, want, grads, lr, steps=2):
    """Parameters after ``steps`` Adam steps: within 2 lr a step, and
    within 1e-3 lr a step where every step's gradient exceeds 1e-4."""
    for n, p in got.items():
        diff = np.abs(p.detach().numpy() - np.asarray(want[n]))
        assert diff.max() <= 2 * steps * lr, n
        big = np.all([np.abs(g[n].numpy()) > 1e-4 for g in grads], axis=0)
        assert diff[big].max(initial=0) <= 1e-3 * steps * lr, n


class TestControlNetStep:
    def test_condition_masking_matches_jax(self, jax_cn, rng):
        model, params = jax_cn
        cn = _port_cn(params)
        b, d = _cn_batch(rng), _cn_draws(rng)
        x = rng.standard_normal((B, L, 2 * C + 1)).astype(np.float32)
        t = np.array([5, 600])
        with jax_draws(_mask_uniforms(d)):
            want = jax.jit(lambda *a: model.apply(
                {"params": params}, *a[:3], context_mask=a[3], condition=a[4], train=True,
                rngs={"mask": jax.random.PRNGKey(0)}))(
                    jnp.asarray(x), jnp.asarray(t), jnp.asarray(b["text"]),
                    jnp.asarray(b["text_mask"]), jnp.asarray(b["condition"]))
        tb = _torch(b)
        with torch.no_grad():
            got = cn(torch.from_numpy(x), torch.from_numpy(t), tb["text"],
                     context_mask=tb["text_mask"], condition=tb["condition"], train=True,
                     mask_draws=_torch(d))
            unmasked = cn(torch.from_numpy(x), torch.from_numpy(t), tb["text"],
                          context_mask=tb["text_mask"], condition=tb["condition"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)
        # sample 0 is masked (select < prob), sample 1 is not
        assert not torch.allclose(got[0][0], unmasked[0][0])
        torch.testing.assert_close(got[0][1], unmasked[0][1], rtol=0, atol=0)

    def test_two_steps_match_jax(self, base, jax_cn, rng):
        jdit_model, dit_params = base
        cn_model, cn_params = jax_cn
        b, d = _cn_batch(rng), _cn_draws(rng)
        kw = dict(learning_rate=LR, warmup=0, grad_clip=1.0, snr_gamma=5.0)
        init, jstep = jax_make_cn_step(jdit_model, cn_model, JaxSchedule.from_config(DIFF),
                                       dit_params, **kw)
        state = init(cn_params)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jm = []
        with jax_draws(_mask_uniforms(d), normal=d["noise"], randint=d["t"]):
            for _ in range(2):  # the same draws at both steps: traced once
                state, m = jstep(state, jb, jax.random.PRNGKey(0))
                jm.append(m)

        dit = _port(MODEL, dit_params)
        cn = _port_cn(cn_params)
        base_before = {k: v.clone() for k, v in dit.state_dict().items()}
        cn_before = {k: v.clone() for k, v in cn.state_dict().items()}
        step = make_controlnet_train_step(dit, cn, DDIMSchedule.from_config(DIFF), **kw)
        tb, td = _torch(b), _torch(d)
        out = [step(tb, seed=0, draws=td, return_grads=True) for _ in range(2)]
        for o, m in zip(out, jm):
            np.testing.assert_allclose(o["loss"].item(), float(m["loss"]), rtol=1e-5)
            np.testing.assert_allclose(o["grad_norm"].item(), float(m["grad_norm"]), rtol=1e-5)
        want = controlnet_state_dict_from_jax(jax.device_get(state.cn_params), MODEL, CN_CFG)
        mask = trainable_mask(cn)
        _assert_adam_params({n: p for n, p in cn.named_parameters() if mask[n]}, want,
                            [o["grads"] for o in out], LR)
        for n, p in cn.named_parameters():
            if not mask[n]:
                torch.testing.assert_close(p.detach(), cn_before[n], rtol=0, atol=0, msg=n)
            else:
                assert not torch.equal(p.detach(), cn_before[n]), n  # every one moved (F6)
        for k, v in dit.state_dict().items():
            torch.testing.assert_close(v, base_before[k], rtol=0, atol=0, msg=k)
        # the zero blocks get a gradient (the branch is live)
        for n, g in out[0]["grads"].items():
            if n.startswith("controlnet_zero_blocks."):
                assert g.abs().max() > 0, n

    def test_refusals(self, base, jax_cn):
        dit = _port(MODEL, base[1])
        cn = _port_cn(jax_cn[1])
        with pytest.raises(ValueError, match="mask_draws"):
            cn.controlnet_pre(torch.zeros(1, 8, 1), train=True)
        cn.time_embed.mlp[0].weight = dit.model.time_embed.mlp[0].weight  # an alias
        with pytest.raises(ValueError, match="shares tensors"):
            make_controlnet_train_step(dit, cn, DDIMSchedule.from_config(DIFF))
