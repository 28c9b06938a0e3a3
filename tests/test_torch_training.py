"""The port's training path on the CPU against the JAX package: the span
mask, MaskDiT's training branch, the loss, the decay mask, the optimizer
against optax, the train step against ``make_train_step`` (remat off,
full and dots; both stages), checkpoints and ``PreemptionGuard``.

torch cannot reproduce ``jax.random`` (ROADMAP F1), so the JAX side's draws
are replaced while its step is traced (:func:`jax_draws`) and the same
numpy draws go to the port's ``draws=``.  The JAX models take weights drawn
from a seed by shape (``_seeded_init``), every leaf non-zero, ``mask_embed``
included (F6), and the port loads them through the weight map.

Limits, each with its reason:
  * the span mask, MaskDiT's masked input and the decay mask: equal;
  * the loss: rtol 1e-6 (one f32 reduction in another order);
  * the train step's loss and grad norm: rtol 1e-5; each gradient within
    GRAD_RTOL of its tensor's largest entry (the backward sums over the
    batch, the tokens and the heads in another order than XLA);
  * the optimizer against optax on identical gradients: 1e-6;
  * the whole step's parameters: within 2 lr everywhere (Adam's first step
    moves each parameter by lr * g / (|g| + eps), whose sign flips for a
    gradient near 0 with any rounding) and within 1e-3 lr where |g| > 1e-4
    (there the ratio moves by eps * dg / g^2 < 1e-6 for dg < 1e-6).
"""

import contextlib
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
from ezaudio_tpu.models.span_mask import compute_span_mask as jax_span_mask
from ezaudio_tpu.training.losses import masked_diffusion_loss as jax_loss
from ezaudio_tpu.training.optim import decay_mask as jax_decay_mask
from ezaudio_tpu.training.optim import make_optimizer as jax_make_optimizer
from ezaudio_tpu.training.trainer import TrainState, make_train_step as jax_make_train_step
from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from ezaudio_tpu_torch.models.span_mask import span_mask_from_draws
from ezaudio_tpu_torch.ops import quant
from ezaudio_tpu_torch.training.losses import masked_diffusion_loss
from ezaudio_tpu_torch.training.optim import decay_mask, make_optimizer
from ezaudio_tpu_torch.training.trainer import PreemptionGuard, Trainer, make_train_step
from tests.test_torch_controlnet import _seeded_init
from tests.tiny_config import TINY_CONFIG

GRAD_RTOL = 1e-4
B, L, C, LC, CTX = 2, 40, 8, 6, 32
MODEL = dict(TINY_CONFIG["model"], depth=2)
MAE_MODEL = dict(MODEL, context_dim=None)
DIFF = TINY_CONFIG["diff"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_draws(uniforms=(), normal=None, randint=None):
    """``jax.random.uniform`` returns ``uniforms`` in call order, ``normal``
    and ``randint`` their arrays, while inside.  A uniform draw of another
    shape than the next one queued (flax checks a parameter's shape against
    its initializer's) goes to the real function."""
    queue = list(uniforms)
    real = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if not queue or queue[0].shape != tuple(shape):
            return real(key, shape, dtype, minval, maxval)
        return jnp.asarray(queue.pop(0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        if normal is not None:
            mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(normal))
        if randint is not None:
            mp.setattr(jax.random, "randint",
                       lambda key, shape, minval, maxval, dtype=None: jnp.asarray(randint))
        yield
    assert not queue, "not every draw was used"


def _jax_params(model_cfg, seed):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(seed)))
        model = jax_maskdit(model_cfg)
        ctx = None if model_cfg["context_dim"] is None else jnp.zeros((B, LC, CTX))
        params = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                            jnp.zeros((B, L, C)), jnp.zeros((B,), jnp.int32), ctx)["params"]
    assert all(np.any(a) for a in jax.tree.leaves(params))
    return model, params


def _port(model_cfg, jparams):
    dit = maskdit_from_config(model_cfg)
    dit.load_state_dict(maskdit_state_dict_from_jax(jax.device_get(jparams), model_cfg))
    return dit.train()


@pytest.fixture(scope="module")
def pair():
    model, params = _jax_params(MODEL, 7)
    return model, params


def _draws(rng, mae_prob_hit=(True, False)):
    n_pos = L - MODEL["mask_span"]
    d = dict(noise=rng.standard_normal((B, L, C)).astype(np.float32),
             t=np.array([17, 999], np.int32),
             cfg=np.array([0.05, 0.6], np.float32),  # the first sample drops its text
             ratio=rng.uniform(0.25, 1.0, B).astype(np.float32),
             span_round=rng.uniform(size=B).astype(np.float32),
             span_scores=rng.uniform(size=(B, n_pos)).astype(np.float32),
             select=np.where(mae_prob_hit, 0.1, 0.9).astype(np.float32))
    return d


def _batch(rng, text=True):
    b = dict(latents=rng.standard_normal((B, L, C)).astype(np.float32))
    if text:
        mask = np.ones((B, LC), bool)
        mask[1, 4:] = False
        b.update(text=rng.standard_normal((B, LC, CTX)).astype(np.float32), text_mask=mask,
                 uncond=rng.standard_normal((1, LC, CTX)).astype(np.float32),
                 uncond_mask=np.array([[True, True, False, False, False, False]]))
    return b


def _torch(tree):
    return {k: None if v is None else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _uniforms(d, text=True):
    return ([d["cfg"]] if text else []) + [d["ratio"], d["span_round"], d["span_scores"],
                                           d["select"]]


# ---------------------------------------------------------------------------
class TestSpanMask:
    @pytest.mark.parametrize("batch,length,span", [(4, 50, 10), (3, 12, 10), (2, 10, 10),
                                                   (5, 200, 7)])
    def test_bit_equal_given_jax_draws(self, batch, length, span):
        key = jax.random.PRNGKey(batch * 1000 + length)
        probs = jnp.asarray(np.linspace(0.25, 1.0, batch), jnp.float32)
        want = np.asarray(jax_span_mask(key, batch, length, probs, span))
        k_round, k_starts = jax.random.split(key)
        n_pos = max(1, length - span)
        u = np.asarray(jax.random.uniform(k_round, (batch,)))
        scores = np.asarray(jax.random.uniform(k_starts, (batch, n_pos)))
        got = span_mask_from_draws(torch.from_numpy(u), torch.from_numpy(scores), length,
                                   torch.from_numpy(np.asarray(probs)), span)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()


class TestMaskDiTTrainBranch:
    def test_masked_input_and_output_match_jax(self, pair, rng):
        model, params = pair
        dit = _port(MODEL, params)
        d, b = _draws(rng), _batch(rng)
        x, t = rng.standard_normal((B, L, C)).astype(np.float32), np.array([3, 500])
        with jax_draws(_uniforms(d, text=False)):
            want_in, want_mask = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                             jnp.asarray(b["text"]), gt=jnp.asarray(b["latents"]),
                                             forward_model=False, rngs={"mask": jax.random.PRNGKey(0)})
        with jax_draws(_uniforms(d, text=False)):
            want_out, _ = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(b["text"]),
                                      context_mask=jnp.asarray(b["text_mask"]),
                                      gt=jnp.asarray(b["latents"]),
                                      rngs={"mask": jax.random.PRNGKey(0)})
        td, tb = _torch(d), _torch(b)
        with torch.no_grad():
            got_in, got_mask = dit(torch.from_numpy(x), torch.from_numpy(t), tb["text"],
                                   gt=tb["latents"], forward_model=False, mask_draws=td)
            got_out, _ = dit(torch.from_numpy(x), torch.from_numpy(t), tb["text"],
                             context_mask=tb["text_mask"], gt=tb["latents"], mask_draws=td)
        np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        # sample 0 takes the span mask, sample 1 (not selected) is all masked
        assert 0 < got_mask[0, :, 0].sum() < L and bool(got_mask[1].all())
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=2e-5, rtol=1e-5)

    def test_needs_draws(self, pair, rng):
        dit = _port(MODEL, pair[1])
        b = _torch(_batch(rng))
        with pytest.raises(ValueError, match="mask_draws"):
            dit(b["latents"], torch.tensor([1, 2]), b["text"], gt=b["latents"])

    def test_config_keeps_the_mae_keys(self):
        dit = maskdit_from_config(dict(MODEL, mae_prob=0.3, mask_ratio=[0.5, 0.75], mask_span=5))
        assert (dit.mae_prob, dit.mask_ratio, dit.mask_span) == (0.3, (0.5, 0.75), 5)
        gen = torch.Generator().manual_seed(0)
        d = dit.draw_mask(gen, 64, L, "cpu")
        assert d["span_scores"].shape == (64, L - 5)
        assert bool(((d["ratio"] >= 0.5) & (d["ratio"] < 0.75)).all())


class TestLoss:
    @pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
    @pytest.mark.parametrize("snr_gamma", [None, 5.0])
    def test_matches_jax(self, rng, prediction_type, snr_gamma):
        diff = dict(DIFF, prediction_type=prediction_type)
        pred, target = (rng.standard_normal((3, L, C)).astype(np.float32) for _ in range(2))
        mask = (rng.uniform(size=(3, L, 1)) < 0.5).repeat(C, -1).astype(np.float32)
        mask[2] = 0.0  # an empty mask divides by 1
        t = np.array([0, 500, 999])  # 999: the zero-SNR terminal step
        want = jax_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                        JaxSchedule.from_config(diff), jnp.asarray(t), snr_gamma)
        got = masked_diffusion_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                    torch.from_numpy(mask), DDIMSchedule.from_config(diff),
                                    torch.from_numpy(t), snr_gamma)
        assert np.isfinite(got.item())
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)

    def test_targets_match_jax(self, rng):
        x, n = (rng.standard_normal((2, L, C)).astype(np.float32) for _ in range(2))
        t = np.array([5, 999])
        js, ts = JaxSchedule.from_config(DIFF), DDIMSchedule.from_config(DIFF)
        for jf, tf in ((js.add_noise, ts.add_noise), (js.get_velocity, ts.get_velocity)):
            np.testing.assert_allclose(
                tf(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(t)).numpy(),
                np.asarray(jf(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))), rtol=1e-6,
                atol=1e-7)
        np.testing.assert_allclose(ts.snr(torch.from_numpy(t)).numpy(),
                                   np.asarray(js.snr(jnp.asarray(t))), rtol=1e-6)


def _mapped(tree, model_cfg):
    """A JAX-shaped tree of arrays -> the port's names (the weight map is
    linear: it carries gradients and masks as it carries weights)."""
    return maskdit_state_dict_from_jax(jax.device_get(tree), model_cfg)


class TestDecayMask:
    @pytest.mark.parametrize("model_cfg", [MODEL, MAE_MODEL], ids=["t2a", "mae"])
    def test_equal_to_jax_through_the_weight_map(self, model_cfg):
        _, params = _jax_params(model_cfg, 3)
        full = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                            jax_decay_mask(params), params)
        want = {k: bool(v.flatten()[0]) for k, v in _mapped(full, model_cfg).items()}
        got = decay_mask(_port(model_cfg, params))
        assert set(got) == set(want) - {k for k in want if k.endswith("inv_freq")}
        assert got == {k: want[k] for k in got}
        assert any(got.values()) and not all(got.values())


class TestOptimizerAgainstOptax:
    @pytest.mark.parametrize("case", [
        dict(warmup=3, grad_scale=1.0),                  # warmup: step 0 moves nothing
        dict(warmup=0, schedule="cosine", total_steps=4, grad_scale=0.01),
        dict(warmup=0, grad_clip=0.5, grad_scale=1.0),   # the clip fires
        dict(warmup=0, grad_clip=100.0, grad_scale=1.0),  # the clip holds
        dict(warmup=2, accumulation_steps=2, grad_scale=1.0),
    ], ids=["warmup", "cosine", "clip", "no_clip", "accum2"])
    def test_identical_gradients(self, pair, rng, case):
        _, params = pair
        case = dict(case)
        scale = case.pop("grad_scale")
        kw = dict(dict(learning_rate=1e-2, weight_decay=0.1), **case)
        dit = _port(MODEL, params)
        opt = make_optimizer(dit, **kw)
        tx = jax_make_optimizer(params, **kw)
        update = jax.jit(lambda g, s, p: tx.update(g, s, p))
        jp, state = params, tx.init(params)
        start = {n: p.detach().clone() for n, p in dit.named_parameters()}
        moved = []
        for step in range(4):
            g = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                             params)
            updates, state = update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, updates)
            moved.append(opt.update({n: t for n, t in _mapped(g, MODEL).items()
                                     if n in opt.params}))
            want = _mapped(jp, MODEL)
            for n, p in dit.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6,
                                           rtol=0, err_msg=f"{n} after step {step}")
            if step == 0 and case.get("warmup") == 3:  # lr(0) = 0: nothing moves
                for n, p in dit.named_parameters():
                    torch.testing.assert_close(p.detach(), start[n], rtol=0, atol=0)
        if case.get("accumulation_steps"):
            assert moved == [False, True, False, True]
        else:
            assert all(moved)

    def test_global_norm_is_accurate_on_large_tensors(self):
        """The clip's norm sums squares: torch's CPU ``vector_norm`` of a
        16M-element f32 tensor reads 7e-4 off, far outside phase 25's
        card-against-CPU limit."""
        from ezaudio_tpu_torch.training.optim import global_norm

        g = torch.Generator().manual_seed(0)
        ts = [torch.randn(4096 * 4096, generator=g) * 1e-3, torch.randn(1000, generator=g)]
        want = float(np.sqrt(sum(float(t.double().square().sum()) for t in ts)))
        assert abs(global_norm(ts).item() - want) <= 1e-6 * want

    def test_unported_options_raise(self, pair):
        dit = _port(MODEL, pair[1])
        for kw in (dict(optimizer="adafactor"), dict(mu_dtype="bfloat16")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                make_optimizer(dit, **kw)

    def test_int8_cache_never_serves_a_stale_weight(self, pair, rng, monkeypatch):
        """An optimizer update bumps the weights' versions, so an int8
        weight cached by QuantLinear is quantized again."""
        monkeypatch.setattr(quant, "MIN_QUANT_ELEMENTS", 0)
        dit = _port(MODEL, pair[1])
        lin = dit.model.time_ada
        x = torch.from_numpy(rng.standard_normal((3, lin.in_features)).astype(np.float32))
        with quant.quant_context("int8"), torch.no_grad():
            lin(x)
            opt = make_optimizer(dit, learning_rate=0.1, warmup=0)
            opt.update({n: torch.ones_like(p) for n, p in opt.params.items()})
            got = lin(x)
            want = quant.int8_linear(x, *quant.quantize_symmetric(lin.weight.float(), -1)) \
                + lin.bias
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
def _capture_tx():
    """A GradientTransformation that keeps the gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(model, params, tx, batch, d, text=True, snr_gamma=5.0):
    step = jax_make_train_step(model, JaxSchedule.from_config(DIFF), tx, snr_gamma=snr_gamma)
    state = TrainState.create(jax.tree.map(jnp.array, params), tx)
    jb = {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}
    with jax_draws(_uniforms(d, text), normal=d["noise"], randint=d["t"]):
        state, m = step(state, jb, jax.random.PRNGKey(0))
    return state, float(m["loss"]), float(m["grad_norm"])


def _port_step(model_cfg, params, batch, d, opt_kw, snr_gamma=5.0, **cfg):
    dit = _port(dict(model_cfg, **cfg), params)
    trainer = Trainer.create(dit, DDIMSchedule.from_config(DIFF),
                             dict(opt_kw, snr_gamma=snr_gamma))
    m = trainer.step_fn(_torch(batch), seed=0, draws=_torch(d), return_grads=True)
    return dit, m


class TestTrainStepAgainstJax:
    @pytest.mark.parametrize("stage", ["t2a", "mae"])
    def test_loss_and_gradients(self, rng, stage):
        model_cfg = MODEL if stage == "t2a" else MAE_MODEL
        model, params = _jax_params(model_cfg, 5)
        batch, d = _batch(rng, text=stage == "t2a"), _draws(rng)
        state, loss, gnorm = _jax_step(model, params, _capture_tx(), batch, d,
                                       text=stage == "t2a")
        want = _mapped(state.opt_state, model_cfg)
        for remat in ("off", "full", "dots"):
            cfg = (dict(use_checkpoint=False) if remat == "off"
                   else dict(use_checkpoint=True, remat_policy=remat))
            _, m = _port_step(model_cfg, params, batch, d, dict(warmup=0), **cfg)
            np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"].item(), gnorm, rtol=1e-5)
            assert set(m["grads"]) == {k for k in want if not k.endswith("inv_freq")}
            for n, g in m["grads"].items():
                w = want[n].numpy()
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=GRAD_RTOL * max(np.abs(w).max(), 1e-6),
                                           err_msg=f"{n} ({remat})")
            # every attention's q, k and v projections get a gradient
            for n, g in m["grads"].items():
                if any(f"attn.to_{x}." in n for x in "qkv"):
                    assert g.abs().max() > 0, n

    def test_whole_step_parameters(self, pair, rng):
        model, params = pair
        batch, d = _batch(rng), _draws(rng)
        kw = dict(learning_rate=1e-3, warmup=0, weight_decay=0.01)
        state, loss, _ = _jax_step(model, params, jax_make_optimizer(params, **kw), batch, d)
        gstate = _jax_step(model, params, _capture_tx(), batch, d)[0]
        dit, m = _port_step(MODEL, params, batch, d, kw)
        want, grads = _mapped(state.params, MODEL), _mapped(gstate.opt_state, MODEL)
        lr = kw["learning_rate"]
        for n, p in dit.named_parameters():
            diff = np.abs(p.detach().numpy() - want[n].numpy())
            assert diff.max() <= 2 * lr, n
            big = np.abs(grads[n].numpy()) > 1e-4
            assert diff[big].max(initial=0) <= 1e-3 * lr, n
        np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)

    def test_quant_is_off_inside_the_step(self, pair, rng, monkeypatch):
        """``EZAUDIO_QUANT=int8`` does not reach the step: int8 round()
        has no gradient."""
        monkeypatch.setenv("EZAUDIO_QUANT", "int8")
        monkeypatch.setattr(quant, "MIN_QUANT_ELEMENTS", 0)
        batch, d = _batch(rng), _draws(rng)
        _, m = _port_step(MODEL, pair[1], batch, d, dict(warmup=0))
        monkeypatch.delenv("EZAUDIO_QUANT")
        _, ref = _port_step(MODEL, pair[1], batch, d, dict(warmup=0))
        assert m["loss"].item() == ref["loss"].item()


# ---------------------------------------------------------------------------
class TestCheckpoints:
    def _trainer(self, params, seed=None):
        dit = _port(MODEL, params)
        if seed is not None:  # other weights, which the restore must replace
            with torch.no_grad():
                for p in dit.parameters():
                    p.add_(0.5)
        return Trainer.create(dit, DDIMSchedule.from_config(DIFF),
                              dict(learning_rate=1e-3, warmup=2, accumulation_steps=1))

    def test_save_restore_step_equals_uninterrupted(self, pair, rng, tmp_path):
        batch = _torch(_batch(rng))
        run = self._trainer(pair[1])
        losses = [run.train_step(batch, seed=11)["loss"].item() for _ in range(2)]
        run.save_checkpoint(str(tmp_path), block=False)
        run.close()
        losses.append(run.train_step(batch, seed=11)["loss"].item())
        resumed = self._trainer(pair[1], seed=1).restore_checkpoint(str(tmp_path))
        assert resumed.step == 2
        assert resumed.train_step(batch, seed=11)["loss"].item() == losses[2]
        for (n, a), b in zip(run.model.state_dict().items(), resumed.model.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
        assert resumed.optimizer.count == run.optimizer.count == 3

    def test_a_failed_async_write_raises_at_close(self, pair, tmp_path, monkeypatch):
        import ezaudio_tpu_torch.training.trainer as tr_mod

        def fail(*a, **kw):
            raise OSError("disk full")

        tr = self._trainer(pair[1])
        monkeypatch.setattr(tr_mod.torch, "save", fail)
        tr.save_checkpoint(str(tmp_path), 1, block=False)
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            tr.close()
        tr.close()  # reported once
        assert tr_mod.all_steps(str(tmp_path)) == []

    def test_keeps_the_newest_and_refuses_a_duplicate(self, pair, tmp_path):
        tr = self._trainer(pair[1])
        for step in range(1, 8):
            tr.save_checkpoint(str(tmp_path), step)
        assert sorted(os.listdir(tmp_path)) == [str(s) for s in range(3, 8)]
        with pytest.raises(FileExistsError):
            tr.save_checkpoint(str(tmp_path), 7)
        tr.save_checkpoint(str(tmp_path), 7, skip_existing=True)


def test_preemption_guard_turns_a_signal_into_a_flag():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
        assert signal.getsignal(signal.SIGTERM) == prev  # a second signal acts as usual
    assert signal.getsignal(signal.SIGTERM) == prev


def test_make_train_step_draws_from_seed_and_step(pair, rng):
    """A step's draws depend on (seed, step) alone: at lr 0 the weights stay,
    so a step that starts at step 1 gives the loss of another run's second
    step, and not that of its first."""
    batch = _torch(_batch(rng))

    def step_fn():
        dit = _port(MODEL, pair[1])
        return make_train_step(dit, DDIMSchedule.from_config(DIFF),
                               make_optimizer(dit, learning_rate=0.0, warmup=0))

    a, b = step_fn(), step_fn()
    la = [a(batch, 3)["loss"].item() for _ in range(2)]
    b.step = 1
    assert b(batch, 3)["loss"].item() == la[1] != la[0]
