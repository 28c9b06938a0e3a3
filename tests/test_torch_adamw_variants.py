"""AdamW beyond the f32 trainer on the CPU against optax 0.2.6: a bf16 first
moment (``mu_dtype='bfloat16'``, with and without accumulation) and the
ControlNet trainer's plain ``optax.adamw`` behind the clip (``make_adamw``).
The limits are ``test_torch_optimizers._run_against_optax``'s.
"""

import optax
import pytest
import torch

from ezaudio_tpu.training.optim import make_optimizer as jax_make_optimizer
from ezaudio_tpu.training.optim import warmup_lr_schedule as jax_warmup
from ezaudio_tpu_torch.training import optim
from tests.test_torch_optimizers import _run_against_optax
from tests.test_torch_training import MODEL, _jax_params, _port


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _jax_params(MODEL, 31)


class TestAdamWAgainstOptax:
    @pytest.mark.parametrize("case", [
        dict(mu_dtype="bfloat16"),
        dict(mu_dtype="bfloat16", accumulation_steps=2, warmup=2),
    ], ids=["adamw_mu_bf16", "adamw_mu_bf16_accum2"])
    def test_identical_gradients(self, pair, rng, case):
        _, params = pair
        kw = dict(dict(learning_rate=1e-2, weight_decay=0.1, warmup=0), **case)
        dit = _port(MODEL, params)
        opt = optim.make_optimizer(dit, **kw)
        steps = 4 if case.get("accumulation_steps") else 2
        _run_against_optax(params, opt, jax_make_optimizer(params, **kw), rng, steps,
                           bf16_moment=True)
        assert all(m.dtype == torch.bfloat16 for m in opt.rule.mu)

    def test_controlnet_adamw(self, pair, rng):
        """``make_adamw``: the clip then ``optax.adamw`` at its defaults,
        every tensor decayed (the ControlNet trainer's chain)."""
        _, params = pair
        dit = _port(MODEL, params)
        lr = jax_warmup(1e-2, 2)
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(lr))
        opt = optim.make_adamw(dict(dit.named_parameters()), optim.warmup_lr_schedule(1e-2, 2),
                               0.5)
        _run_against_optax(params, opt, tx, rng, 2)
