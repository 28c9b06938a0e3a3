"""bf16 mixed-precision training on the CPU against the JAX package's bf16
trainer (the optimizers beyond f32 AdamW are ``test_torch_optimizers.py``).

  * ``utils.mixed_precision``: the model inside computes what the model
    cast once by ``cast_params_`` computes (bit for bit), its gradients
    reach the f32 parameters, and nothing stays swapped after;
  * the bf16 step against JAX's bf16 step (``EzAudio(dtype=bf16)``'s DiT,
    f32 parameters) on the same weights, batch and draws, by the
    statistical rule of ``test_torch_bf16.py``: the gradients (all of them,
    as one vector) no farther from JAX bf16's than twice JAX bf16's
    distance from the f32 step's (the port's f32 step, which matches JAX's
    f32 step within 1e-4 of each gradient's scale, test_torch_training),
    correlated above 0.99; the loss (one scalar
    mean, where XLA's excess precision inside a fusion weighs more than
    the statistics) within 2^-8 of JAX bf16's, relative; the parameters
    and the optimizer state stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.training.trainer import Trainer
from tests.test_torch_bf16 import assert_bf16_close
from tests.test_torch_training import (DIFF, MODEL, _batch, _capture_tx, _draws, _jax_params,
                                       _jax_step, _mapped, _port, _torch)

pytestmark = pytest.mark.filterwarnings("ignore:The given NumPy array is not writable")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _jax_params(MODEL, 31)


# ---------------------------------------------------------------------------
class TestMixedPrecision:
    def test_computes_the_cast_model(self, pair, rng):
        _, params = pair
        mixed, cast = _port(MODEL, params), _port(MODEL, params)
        utils.cast_params_(cast, torch.bfloat16)
        b = _torch(_batch(rng))
        x = torch.randn(2, 40, 8)
        t = torch.tensor([3, 700])
        masters = [mixed.model.time_ada.weight, mixed.model.final_block.norm.weight]
        with utils.mixed_precision(mixed, torch.bfloat16):
            got, _ = mixed(x, t, b["text"].bfloat16(), context_mask=b["text_mask"])
            assert mixed.model.time_ada.weight.dtype == torch.bfloat16
            assert mixed.model.in_blocks[0].norm1.weight.dtype == torch.float32
            g = torch.autograd.grad(got.float().square().sum(), masters)
        with torch.no_grad():
            want, _ = cast(x.bfloat16(), t, b["text"].bfloat16(), context_mask=b["text_mask"])
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert all(gi.dtype == torch.float32 and gi.abs().max() > 0 for gi in g)
        assert all(p.dtype == torch.float32 and isinstance(p, torch.nn.Parameter)
                   for p in mixed.parameters())

    def test_bf16_step_matches_jax_bf16(self, rng):
        """JAX's bf16 trainer (MaskDiT ``dtype=bf16``, f32 parameters) and
        the port's mixed-precision step on the same weights, bf16 latents
        and text, and draws (the noise rounded to bf16 as the port rounds
        its f32 draw)."""
        model_cfg = MODEL
        _, params = _jax_params(model_cfg, 33)
        j16 = jax_maskdit(model_cfg, dtype=jnp.bfloat16)
        b, d = _batch(rng), _draws(rng)
        d["noise"] = np.asarray(jnp.asarray(d["noise"], jnp.bfloat16).astype(jnp.float32))
        for k in ("latents", "text", "uncond"):
            b[k] = np.asarray(jnp.asarray(b[k], jnp.bfloat16).astype(jnp.float32))
        jb = {k: v for k, v in b.items()}
        s16, loss16, _ = _jax_step(j16, params, _capture_tx(), _as_bf16(jb), d)
        f32 = Trainer.create(_port(model_cfg, params), DDIMSchedule.from_config(DIFF),
                             dict(warmup=0, snr_gamma=5.0))
        ref = f32.step_fn(_torch(b), seed=0, draws=_torch(d), return_grads=True)["grads"]
        dit = _port(model_cfg, params)
        trainer = Trainer.create(dit, DDIMSchedule.from_config(DIFF),
                                 dict(warmup=0, snr_gamma=5.0, mu_dtype=None),
                                 dtype=torch.bfloat16)
        tb = {k: (v.bfloat16() if v.is_floating_point() else v) for k, v in _torch(b).items()}
        m = trainer.step_fn(tb, seed=0, draws=_torch(d), return_grads=True)
        want = _mapped(s16.opt_state, model_cfg)
        names = sorted(m["grads"])
        vec = lambda gs: np.concatenate([np.asarray(gs[n], np.float32).ravel() for n in names])
        assert_bf16_close(vec({n: m["grads"][n].numpy() for n in names}), vec(want),
                          vec({n: ref[n].numpy() for n in names}), 0.99)
        # a scalar mean: XLA's fusions keep f32 inside, torch rounds every op,
        # so the loss is held to bf16's resolution, 2^-8 relative
        assert abs(m["loss"].item() - loss16) <= 2.0 ** -8 * abs(loss16)
        assert all(p.dtype == torch.float32 for p in dit.parameters())
        assert all(g.dtype == torch.float32 for g in m["grads"].values())
        assert all(v["exp_avg"].dtype == torch.float32
                   for v in trainer.optimizer.rule.adamw.state.values())


def _as_bf16(batch):
    return {k: (jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32 else jnp.asarray(v))
            for k, v in batch.items()}
