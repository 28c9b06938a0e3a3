"""The optimizers beyond f32 AdamW on the CPU against optax 0.2.6, the
JAX package's chains: Adafactor (factored and unfactored tensors, with and
without momentum, with a bf16 momentum and the clip), and the checkpoint
state (AdamW with a bf16 first moment and the ControlNet trainer's plain
``optax.adamw`` are ``test_torch_adamw_variants.py``).

On identical gradients every parameter after each update within 1e-6 (f32
math in another order); with a bf16 moment, a boundary flip of its
rounding is allowed too (``_run_against_optax``).  The JAX tree's leaves
map to the port's parameters through the weight map: a transposed kernel
factors over the same two axes, and the factored estimate is symmetric in
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ezaudio_tpu.training.optim import make_optimizer as jax_make_optimizer
from ezaudio_tpu.training.optim import warmup_lr_schedule as jax_warmup
from ezaudio_tpu_torch.training import optim
from tests.test_torch_training import MODEL, _jax_params, _mapped, _port

BF16_FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _jax_params(MODEL, 31)


def _run_against_optax(params, opt, tx, rng, steps, scale=1.0, bf16_moment=False, lr=1e-2):
    """Feed both the same gradients ``steps`` times; compare every
    parameter after each update: within 1e-6; with ``bf16_moment``, a
    moment stored in bf16 that rounds the other way (an f32 sum in another
    order at a rounding boundary) moves its parameter by one bf16 ulp of
    the moment, at most 2^-8 lr an update, in at most BF16_FLIP_SHARE of
    the elements."""
    dit_params = {n: p for n, p in opt.params.items()}
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    jp, state = params, tx.init(params)
    for step in range(steps):
        g = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                         params)
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update({n: t for n, t in _mapped(g, MODEL).items() if n in dit_params})
        want = _mapped(jp, MODEL)
        flips, total = 0, 0
        for n, p in dit_params.items():
            diff = np.abs(p.detach().numpy() - want[n].numpy())
            limit = 1e-6 + (2.0 ** -8 * lr * (step + 1) if bf16_moment else 0.0)
            assert diff.max() <= limit, f"{n} after step {step}: {diff.max()}"
            flips, total = flips + int((diff > 1e-6).sum()), total + diff.size
        assert flips <= BF16_FLIP_SHARE * total, (flips, total)
    return state


class TestOptimizersAgainstOptax:
    @pytest.mark.parametrize("case", [
        dict(optimizer="adafactor", factor_min_dim=8),     # factored and unfactored
        dict(optimizer="adafactor", mu_dtype="bfloat16", factor_min_dim=8, grad_clip=0.5),
        dict(optimizer="adafactor", beta1=0.0, factor_min_dim=1000),  # no momentum
    ], ids=["adafactor", "adafactor_mu_bf16_clip", "adafactor_no_momentum"])
    def test_identical_gradients(self, pair, rng, case):
        _, params = pair
        kw = dict(dict(learning_rate=1e-2, weight_decay=0.1, warmup=0), **case)
        dit = _port(MODEL, params)
        opt = optim.make_optimizer(dit, **kw)
        steps = 4 if case.get("accumulation_steps") else 2
        _run_against_optax(params, opt, jax_make_optimizer(params, **kw), rng, steps,
                           bf16_moment=bool(case.get("mu_dtype")))
        rule = opt.rule
        if case.get("mu_dtype"):
            moments = rule.ema if isinstance(rule, optim.Adafactor) else rule.mu
            assert all(m.dtype == torch.bfloat16 for m in moments)
        if case.get("factor_min_dim") == 8:  # some tensors factored, some not
            assert any(d is not None for d in rule.dims) and any(d is None for d in rule.dims)

    def test_state_round_trip(self, pair, rng):
        """An Adafactor and a bf16-moment AdamW restored from their state
        dicts continue as the uninterrupted optimizer."""
        _, params = pair
        for kw in (dict(optimizer="adafactor", factor_min_dim=8, mu_dtype="bfloat16"),
                   dict(mu_dtype="bfloat16")):
            a, b = _port(MODEL, params), _port(MODEL, params)
            oa = optim.make_optimizer(a, learning_rate=1e-2, warmup=0, **kw)
            ob = optim.make_optimizer(b, learning_rate=1e-2, warmup=0, **kw)
            g = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
                 for i, (n, p) in enumerate(oa.params.items())}
            oa.update(g)
            ob.update(g)
            ob.load_state_dict(oa.state_dict())
            oa.update(g)
            ob.update(g)
            for (n, p), q in zip(a.named_parameters(), b.parameters()):
                torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
            with pytest.raises(ValueError, match="rule"):
                optim.make_optimizer(_port(MODEL, params)).load_state_dict(oa.state_dict())

    def test_unknown_options_raise(self, pair):
        dit = _port(MODEL, pair[1])
        with pytest.raises(NotImplementedError, match="optimizer"):
            optim.make_optimizer(dit, optimizer="lion")
        with pytest.raises(NotImplementedError, match="mu_dtype"):
            optim.make_optimizer(dit, mu_dtype="float16")
