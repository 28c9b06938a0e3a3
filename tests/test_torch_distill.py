"""Progressive distillation on the CPU against the JAX package: the
teacher's two-step target and ``v*`` (``teacher_two_step_target``,
``v_target_from_endpoint``), two ``make_distill_step`` steps with the CFG
teacher of scripts/distill_validate.py, and the refusal of a student that
shares the teacher's tensors.

Limits: the target and ``v*`` within 1e-5 of their range (two f32 model
calls); one DDIM step with ``v*`` lands on the target likewise; the loss
rtol 1e-5; the student after two steps by
``test_torch_finetune._assert_adam_params``; the teacher bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.diffusion import distill as jdistill
from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
from ezaudio_tpu.training.optim import make_optimizer as jax_make_optimizer
from ezaudio_tpu.training.trainer import TrainState
from ezaudio_tpu_torch.diffusion import distill
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.training.optim import make_optimizer
from tests.test_torch_finetune import LR, _assert_adam_params
from tests.test_torch_training import DIFF, MODEL, _jax_params, _mapped, _port, _torch, jax_draws

B, L, C, LC, CTX = 2, 20, 8, 6, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    return _jax_params(MODEL, 21)


def _teacher_fns(jmodel, w=3.0):
    """The CFG teacher of scripts/distill_validate.py on both sides, and
    the single-batch student."""
    def jstudent(p, x, t, batch):
        t = jnp.broadcast_to(t, (x.shape[0],))
        return jmodel.apply({"params": p}, x, t, batch["text"])[0]

    def jbuilder(batch, tp):
        def fn(x, t):
            t = jnp.broadcast_to(t, (x.shape[0],))
            ctx = jnp.concatenate([batch["text"], jnp.zeros_like(batch["text"])], axis=0)
            out, _ = jmodel.apply({"params": tp}, jnp.concatenate([x, x], 0),
                                  jnp.concatenate([t, t], 0), ctx)
            cond, unc = jnp.split(out, 2, axis=0)
            return unc + w * (cond - unc)
        return fn

    def builder(batch, teacher):
        def fn(x, t):
            ctx = torch.cat([batch["text"], torch.zeros_like(batch["text"])])
            out, _ = teacher(torch.cat([x, x]), torch.cat([t, t]), ctx)
            cond, unc = out.chunk(2)
            return unc + w * (cond - unc)
        return fn

    return jstudent, jbuilder, builder


class TestDistill:
    def test_targets_match_jax(self, base, rng):
        jmodel, params = base
        teacher = _port(MODEL, params).eval()
        _, jbuilder, builder = _teacher_fns(jmodel)
        js, ts = JaxSchedule.from_config(DIFF), DDIMSchedule.from_config(DIFF)
        jt, tt = jdistill.distill_tables(js, 4), distill.distill_tables(ts, 4)
        text = rng.standard_normal((B, LC, CTX)).astype(np.float32)
        x = rng.standard_normal((B, L, C)).astype(np.float32)
        m = np.array([0, 3])
        want = jax.jit(lambda txt, x, m: jdistill.teacher_two_step_target(
            jbuilder({"text": txt}, params), js, x, m, jt))(
                jnp.asarray(text), jnp.asarray(x), jnp.asarray(m))
        a, ap = jt.a_t[m].reshape(B, 1, 1), jt.a_prev[m].reshape(B, 1, 1)
        want_v = jdistill.v_target_from_endpoint(jnp.asarray(x), want, a, ap)
        with torch.no_grad():
            got = distill.teacher_two_step_target(builder({"text": torch.from_numpy(text)},
                                                          teacher),
                                                  ts, torch.from_numpy(x), torch.from_numpy(m), tt)
        got_v = distill.v_target_from_endpoint(torch.from_numpy(x), got,
                                               torch.tensor(np.asarray(a)),
                                               torch.tensor(np.asarray(ap)))
        for g, w in ((got, want), (got_v, want_v)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.ptp(w))
        # one student DDIM step with v* lands on the target
        land = ts.ddim_step(got_v, torch.from_numpy(x), torch.tensor(np.asarray(a)),
                            torch.tensor(np.asarray(ap)))
        np.testing.assert_allclose(land.numpy(), got.numpy(), rtol=0,
                                   atol=1e-5 * np.ptp(got.numpy()))

    def test_two_steps_match_jax(self, base, rng):
        jmodel, params = base
        jstudent, jbuilder, builder = _teacher_fns(jmodel)
        js, ts = JaxSchedule.from_config(DIFF), DDIMSchedule.from_config(DIFF)
        text = rng.standard_normal((B, LC, CTX)).astype(np.float32)
        x0 = rng.standard_normal((B, L, C)).astype(np.float32)
        d = dict(m=np.array([1, 3], np.int32), eps=rng.standard_normal((B, L, C)).astype(
            np.float32))
        kw = dict(learning_rate=LR, warmup=0)
        tx = jax_make_optimizer(params, **kw)
        step = jdistill.make_distill_step(jstudent, jbuilder, js, tx,
                                          jdistill.distill_tables(js, 4), teacher_params=params)
        state = TrainState.create(jax.tree.map(jnp.array, params), tx)
        jb = {"latents": jnp.asarray(x0), "text": jnp.asarray(text)}
        jl = []
        with jax_draws(normal=d["eps"], randint=d["m"]):
            for _ in range(2):
                state, met = step(state, jb, jax.random.PRNGKey(0))
                jl.append(float(met["loss"]))

        teacher = _port(MODEL, params)
        student = distill.student_from_teacher(teacher)
        before = {k: v.clone() for k, v in teacher.state_dict().items()}
        opt = make_optimizer(student, **kw)

        def sapply(x, t, batch):
            return student(x, t, batch["text"])[0]

        grads = []
        tstep = distill.make_distill_step(sapply, builder, ts, opt,
                                          distill.distill_tables(ts, 4), teacher=teacher)
        tb = {"latents": torch.from_numpy(x0), "text": torch.from_numpy(text)}
        for i in range(2):
            out = tstep(tb, seed=0, draws=_torch(d), return_grads=True)
            np.testing.assert_allclose(out["loss"].item(), jl[i], rtol=1e-5)
            grads.append(out["grads"])
        _assert_adam_params(dict(student.named_parameters()), _mapped(state.params, MODEL),
                            grads, LR)
        for k, v in teacher.state_dict().items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)

    def test_an_aliased_student_is_refused(self, base):
        teacher = _port(MODEL, base[1])
        with pytest.raises(ValueError, match="shares tensors"):
            distill.make_distill_step(lambda *a: None, None, DDIMSchedule.from_config(DIFF),
                                      make_optimizer(teacher), distill.distill_tables(
                                          DDIMSchedule.from_config(DIFF), 4), teacher=teacher)
