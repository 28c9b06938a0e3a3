"""The ControlNet fine-tune and progressive distillation held to the JAX
package over 50 steps, past a warmup of 10: ``ControlNetTrainStep``
against ``make_controlnet_train_step`` and ``DistillStep`` against
``make_distill_step``, each at its mid harness's learning rate (2e-4 and
1e-4) with a global-norm clip that fires on some steps (the harnesses'
1.0; 0.25 for the ControlNet from the seeded start, whose gradients stay
under 1.0 at this size), the min-SNR weight 5 and the condition masking on
for the ControlNet, and 4 batches cycled.

JAX runs unpatched.  The draws of its step ``n`` come from
``fold_in(PRNGKey(seed_n), n)`` split as its step splits it; the test
computes them from the same keys (the condition mask's uniforms through
the JAX ControlNet's own ``make_rng`` path, recorded under jit) and hands them
to the port's ``draws=`` (ROADMAP F1), so every step has its own draws.

Precision: f32 on both sides, JAX's matmuls at 'highest' (conftest).

Limits, each with its reason:
  * the loss at every step: rtol 1e-4; the ControlNet's grad norm at
    every step: rtol 1e-4 (f32 sums in another order, carried through 50
    updates);
  * the trainable parameters after 50 steps by
    ``test_torch_finetune._assert_adam_params(steps=50)``: within 2 lr a
    step everywhere, and within 1e-3 lr a step where every step's gradient
    exceeds 1e-4;
  * the frozen base, the ControlNet's frozen embedders and the teacher:
    bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu.diffusion import distill as jdistill
from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
from ezaudio_tpu.models.controlnet import controlnet_from_config as jax_cn_from_config
from ezaudio_tpu.training.controlnet_trainer import (
    make_controlnet_train_step as jax_make_cn_step)
from ezaudio_tpu.training.optim import make_optimizer as jax_make_optimizer
from ezaudio_tpu.training.trainer import TrainState
from ezaudio_tpu_torch.convert.from_jax import controlnet_state_dict_from_jax
from ezaudio_tpu_torch.diffusion import distill
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.models.controlnet import trainable_mask, zero_projections_
from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step
from ezaudio_tpu_torch.training.optim import global_norm, make_optimizer
from tests.test_torch_controlnet import _seeded_init
from tests.test_torch_distill import _teacher_fns
from tests.test_torch_finetune import CN_CFG, _assert_adam_params, _cn_batch, _port_cn
from tests.test_torch_training import DIFF, MODEL, _jax_params, _mapped, _port, _torch

B, L, C, LC, CTX = 2, 20, 8, 6, 32
STEPS, WARMUP, N_BATCHES = 50, 10, 4
CN_LR, DISTILL_LR = 2e-4, 1e-4  # the mid harnesses' rates
RTOL = 1e-4
DISTILL_SEED0 = 50_000  # the distillation harness's first step seed
# the tiny ControlNet's gradient norms run 0.0-0.55 over these steps, below
# the harness's clip of 1.0 (the distillation's pass it)
CLIP_FIRES = 0.25


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    return _jax_params(MODEL, 21)


def _zero_leaves(params):
    """The JAX ControlNet tree with the leaves its own init zeroes (its
    ``zero_init`` conv, the zero blocks, ``mask_embed``) zeroed."""
    out = jax.tree.map(np.asarray, params)
    pre = dict(out["controlnet_pre"])
    pre["conv_out"] = jax.tree.map(np.zeros_like, pre["conv_out"])
    pre["mask_embed"] = np.zeros_like(pre["mask_embed"])
    out = dict(out, controlnet_pre=pre)
    for k in out:
        if k.startswith("zero_blocks_"):
            out[k] = jax.tree.map(np.zeros_like, out[k])
    return out


@pytest.fixture(scope="module")
def jax_cn():
    model = jax_cn_from_config(MODEL, CN_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(22)))
        params = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                            jnp.zeros((B, L, 2 * C + 1)), jnp.zeros((B,), jnp.int32),
                            jnp.zeros((B, LC, CTX)), condition=jnp.zeros((B, 2 * L, 1)))["params"]
    return model, params


def _cn_draws_fn(model, params):
    """``(seed, step) -> draws``: what JAX's ControlNet step draws at
    ``step`` from ``PRNGKey(seed)`` (``_step``'s ``fold_in`` and
    ``loss_fn``'s split), the condition mask's four uniforms read off the
    JAX ControlNet's own call."""
    real = jax.random.uniform

    @jax.jit
    def fn(seed, step, cond):
        rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        k_noise, k_t, k_mask = jax.random.split(rng, 3)
        rec = []

        def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
            out = real(key, shape, dtype, minval, maxval)
            rec.append(out)
            return out

        jax.random.uniform = uniform
        try:
            model.apply({"params": params}, jnp.zeros((B, L, 2 * C + 1)),
                        jnp.zeros((B,), jnp.int32), jnp.zeros((B, LC, CTX)),
                        condition=cond, train=True, rngs={"mask": k_mask})
        finally:
            jax.random.uniform = real
        # flax checks each parameter's shape against its initializer's by
        # tracing it: those uniforms are of the parameters' shapes
        want = [(B,), (B,), (B, 2 * L - CN_CFG["cond_mask_span"]), (B,)]
        at = [i for i in range(len(rec) - 3)
              if [r.shape for r in rec[i:i + 4]] == want]
        assert len(at) == 1, [r.shape for r in rec]
        ratio, span_round, span_scores, select = rec[at[0]:at[0] + 4]
        return dict(noise=jax.random.normal(k_noise, (B, L, C), jnp.float32),
                    t=jax.random.randint(k_t, (B,), 0, DIFF["num_train_timesteps"]),
                    ratio=ratio, span_round=span_round, span_scores=span_scores,
                    select=select)

    return lambda seed, step, cond: {k: np.asarray(v) for k, v in fn(seed, step, cond).items()}


@pytest.mark.parametrize("start,clip", [("seeded", CLIP_FIRES), ("zero_projections", 1.0)])
def test_controlnet_50_steps_match_jax(base, jax_cn, start, clip):
    """At the seeded start every leaf is non-zero (F6), and the clip is
    set below the largest norms; at the zero start both sides begin where
    the JAX package's init begins (JAX's zero leaves zeroed in its tree, and
    the port's ``zero_projections_`` on the seeded weights, which must land
    on the same tree), at the harness's clip."""
    jdit_model, dit_params = base
    cn_model, cn_params = jax_cn
    if start == "zero_projections":
        cn_params = _zero_leaves(cn_params)
    rng = np.random.default_rng(31)
    batches = [_cn_batch(rng) for _ in range(N_BATCHES)]
    kw = dict(learning_rate=CN_LR, warmup=WARMUP, grad_clip=clip, snr_gamma=5.0)

    init, jstep = jax_make_cn_step(jdit_model, cn_model, JaxSchedule.from_config(DIFF),
                                   dit_params, **kw)
    state = init(jax.tree.map(jnp.asarray, cn_params))
    jm = []
    for i in range(STEPS):
        jb = {k: jnp.asarray(v) for k, v in batches[i % N_BATCHES].items()}
        state, m = jstep(state, jb, jax.random.PRNGKey(i))  # the harness's seed i
        jm.append({k: float(v) for k, v in m.items()})

    dit = _port(MODEL, dit_params)
    cn = _port_cn(jax_cn[1])
    if start == "zero_projections":
        zero_projections_(cn)
        want0 = controlnet_state_dict_from_jax(cn_params, MODEL, CN_CFG)
        for k, v in cn.state_dict().items():
            torch.testing.assert_close(v, want0[k], rtol=0, atol=0, msg=k)
    base_before = {k: v.clone() for k, v in dit.state_dict().items()}
    cn_before = {k: v.clone() for k, v in cn.state_dict().items()}
    draws_at = _cn_draws_fn(cn_model, cn_params)
    step = make_controlnet_train_step(dit, cn, DDIMSchedule.from_config(DIFF), **kw)
    out = []
    for i in range(STEPS):
        b = batches[i % N_BATCHES]
        d = draws_at(i, i, jnp.asarray(b["condition"]))
        o = step(_torch(b), seed=i, draws=_torch(d), return_grads=True)
        out.append(o)
        np.testing.assert_allclose(o["loss"].item(), jm[i]["loss"], rtol=RTOL, err_msg=i)
        np.testing.assert_allclose(o["grad_norm"].item(), jm[i]["grad_norm"], rtol=RTOL,
                                   err_msg=i)

    mask = trainable_mask(cn)
    if clip == CLIP_FIRES:  # it fires on some steps only (over the trainable subset)
        clipped = [float(global_norm([o["grads"][n] for n in o["grads"] if mask[n]])) > clip
                   for o in out]
        assert any(clipped) and not all(clipped), clipped
    want = controlnet_state_dict_from_jax(jax.device_get(state.cn_params), MODEL, CN_CFG)
    _assert_adam_params({n: p for n, p in cn.named_parameters() if mask[n]}, want,
                        [o["grads"] for o in out], CN_LR, steps=STEPS)
    for n, p in cn.named_parameters():
        if not mask[n]:
            torch.testing.assert_close(p.detach(), cn_before[n], rtol=0, atol=0, msg=n)
    for k, v in dit.state_dict().items():
        torch.testing.assert_close(v, base_before[k], rtol=0, atol=0, msg=k)


def test_distillation_50_steps_match_jax(base):
    jmodel, params = base
    jstudent, jbuilder, builder = _teacher_fns(jmodel)
    js, ts = JaxSchedule.from_config(DIFF), DDIMSchedule.from_config(DIFF)
    jt = jdistill.distill_tables(js, 4)
    rng = np.random.default_rng(32)
    batches = [dict(latents=rng.standard_normal((B, L, C)).astype(np.float32),
                    text=rng.standard_normal((B, LC, CTX)).astype(np.float32))
               for _ in range(N_BATCHES)]
    kw = dict(learning_rate=DISTILL_LR, warmup=WARMUP)  # clip 1.0, decay 0.01: the defaults

    tx = jax_make_optimizer(params, **kw)
    jstep = jdistill.make_distill_step(jstudent, jbuilder, js, tx, jt, teacher_params=params)
    state = TrainState.create(jax.tree.map(jnp.array, params), tx)
    jl = []
    for i in range(STEPS):
        jb = {k: jnp.asarray(v) for k, v in batches[i % N_BATCHES].items()}
        state, met = jstep(state, jb, jax.random.PRNGKey(DISTILL_SEED0 + i))
        jl.append(float(met["loss"]))

    @jax.jit
    def draws_at(seed, step):  # make_distill_step's _step and loss_fn
        k_m, k_eps = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))
        return dict(m=jax.random.randint(k_m, (B,), 0, jt.num_steps),
                    eps=jax.random.normal(k_eps, (B, L, C), jnp.float32))

    teacher = _port(MODEL, params)
    student = distill.student_from_teacher(teacher)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}

    def sapply(x, t, batch):
        return student(x, t, batch["text"])[0]

    tstep = distill.make_distill_step(sapply, builder, ts, make_optimizer(student, **kw),
                                      distill.distill_tables(ts, 4), teacher=teacher)
    grads, norms, ms = [], [], set()
    for i in range(STEPS):
        d = {k: np.asarray(v) for k, v in draws_at(DISTILL_SEED0 + i, i).items()}
        ms.update(d["m"].tolist())
        out = tstep(_torch(batches[i % N_BATCHES]), seed=DISTILL_SEED0 + i, draws=_torch(d),
                    return_grads=True)
        np.testing.assert_allclose(out["loss"].item(), jl[i], rtol=RTOL, err_msg=i)
        grads.append(out["grads"])
        norms.append(float(global_norm(out["grads"].values())))
    assert ms == set(range(4))  # every student step was drawn
    assert max(norms) > 1.0 > min(norms), norms  # the clip fires on some steps only
    _assert_adam_params(dict(student.named_parameters()), _mapped(state.params, MODEL),
                        grads, DISTILL_LR, steps=STEPS)
    for k, v in teacher.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
