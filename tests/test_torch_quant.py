"""The port's dynamic int8 (W8A8) quantization (``ezaudio_tpu_torch/ops/quant.py``)
on the CPU: the tests of ``tests/test_quant.py`` on the port, the port's
``int8_dot`` against the JAX package's, the quantized tiny MaskDiT against
the JAX one, and the rule that only the DiT takes the int8 route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ezaudio_tpu_torch.ops.quant as qm
from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax
from ezaudio_tpu_torch.ops.quant import (QuantLinear, current_quant_mode, int8_dot,
                                         int8_matmul, quant_context, quantize_symmetric)
from tests.test_torch_modules import _np_tree


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestQuantOps:
    def test_quantize_roundtrip_error(self):
        x = torch.from_numpy(_randn(0, 64, 128))
        q, s = quantize_symmetric(x, -1)
        assert q.dtype == torch.int8
        err = (q.float() * s - x).abs()
        # at most half an LSB of the per-row scale
        assert bool((err <= 0.5 * s + 1e-7).all())

    def test_int8_dot_close_to_float(self):
        x = torch.from_numpy(_randn(1, 32, 256))
        w = torch.from_numpy(_randn(2, 256, 512, scale=0.05))
        rel = _rel(int8_dot(x, w).numpy(), (x @ w).numpy())
        assert rel < 0.02, rel  # ~1 % for W8A8 on gaussian data

    def test_int8_dot_batched_rank3(self):
        x = torch.from_numpy(_randn(3, 2, 16, 128))
        w = torch.from_numpy(_randn(4, 128, 64))
        q = int8_dot(x, w)
        assert q.shape == (2, 16, 64)
        assert _rel(q.numpy(), (x @ w).numpy()) < 0.02

    def test_scale_invariance_per_row(self):
        """A huge outlier row must not degrade another row (per-token scales)."""
        x = _randn(5, 4, 128)
        x[0] *= 1000.0
        x = torch.from_numpy(x)
        w = torch.from_numpy(_randn(6, 128, 64, scale=0.1))
        q, exact = int8_dot(x, w).numpy(), (x @ w).numpy()
        assert _rel(q[3], exact[3]) < 0.02

    def test_int8_matmul_is_the_exact_integer_product(self):
        """The plain int32 product equals an integer matmul, at the extreme
        values (+-127 everywhere, K = 4096: sums of 66 million)."""
        rng = np.random.default_rng(7)
        a = rng.integers(-127, 128, (5, 4096)).astype(np.int8)
        b = rng.integers(-127, 128, (9, 4096)).astype(np.int8)
        a[0], b[0] = 127, -127
        got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)

    def test_context_nesting(self, monkeypatch):
        monkeypatch.delenv("EZAUDIO_QUANT", raising=False)
        assert current_quant_mode() is None
        with quant_context("int8"):
            assert current_quant_mode() == "int8"
            with quant_context(None):
                assert current_quant_mode() is None
            assert current_quant_mode() == "int8"
        assert current_quant_mode() is None
        with pytest.raises(ValueError):
            with quant_context("int4"):
                pass

    def test_off_overrides_env(self, monkeypatch):
        monkeypatch.setenv("EZAUDIO_QUANT", "int8")
        assert current_quant_mode() == "int8"
        with quant_context("off"):
            assert current_quant_mode() is None
            with quant_context("int8"):  # an explicit opt-in still wins
                assert current_quant_mode() == "int8"
        assert current_quant_mode() == "int8"


class TestAgainstJax:
    @pytest.mark.parametrize("shape", [(2, 1024, 6144), (1000, 1024, 1024), (3, 7, 40, 24),
                                       (33, 256, 1024)],
                             ids=["time_ada_M2", "tokens", "rank3", "timestep_mlp"])
    def test_int8_dot_equals_jax(self, shape):
        """The same seeded inputs through both ``int8_dot``s.  Against JAX's
        op-by-op (eager) evaluation: bit-equal (the same quantization ops,
        an exact int32 product, the same rescale order).  Under ``jax.jit``
        XLA's fusion evaluates ``x / scale`` and the rescale in its own way:
        most elements then move by an f32 ulp (1.2e-7 of the range), and a
        few activations round to the neighbouring int8 value, so at most
        0.1 % of the elements are off by more than 1e-6 of the range."""
        from ezaudio_tpu.ops.quant import int8_dot as jax_int8_dot

        *lead, K, N = shape
        x = _randn(11, *lead, K)
        w = _randn(12, K, N, scale=K ** -0.5)
        want = np.asarray(jax_int8_dot(jnp.asarray(x), jnp.asarray(w)))
        got = int8_dot(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want)
        jitted = np.asarray(jax.jit(jax_int8_dot)(jnp.asarray(x), jnp.asarray(w)))
        off = np.abs(got - jitted) > 1e-6 * np.abs(jitted).max()
        assert off.mean() <= 1e-3, off.mean()

    def test_quantized_maskdit_matches_jax(self, monkeypatch):
        """The tiny MaskDiT with every linear on the int8 route
        (MIN_QUANT_ELEMENTS = 0 on both sides), on carried weights.

        (a) Each linear computes the JAX package's int8 function of its own
        input: with JAX's ``int8_dot`` in place of the port's in every
        QuantLinear, the output is bit-equal.  (b) Against JAX MaskDiT under
        its own ``quant_context('int8')``: corr > 0.9999 and atol 0.05.  The
        float forwards agree to 1e-4, but an int8 forward is discontinuous:
        an f32 sum taken in another order now and then puts an activation on
        the other side of a rounding boundary, one LSB of its row's scale,
        and the next layers carry that on.  A relative change of 1e-6 in the
        port's own input moves its int8 output by up to 0.049 on these
        weights; JAX and the port differ by 0.027."""
        import ezaudio_tpu.ops.quant as jax_qm
        from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
        from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
        from tests.test_dit import TINY_MODEL

        monkeypatch.setattr(jax_qm, "MIN_QUANT_ELEMENTS", 0)
        monkeypatch.setattr(qm, "MIN_QUANT_ELEMENTS", 0)
        jmodel = jax_maskdit(TINY_MODEL)
        params = jmodel.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                             jnp.zeros((1, 32, 8)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 5, 24)))
        params = {"params": _np_tree(params["params"], np.random.default_rng(7))}
        model = maskdit_from_config(TINY_MODEL).eval()
        model.load_state_dict(maskdit_state_dict_from_jax(params["params"], TINY_MODEL))
        x, ctx = _randn(1, 2, 32, 8), _randn(2, 2, 5, 24)
        cmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
        t = np.array([10, 500])

        def port():
            with torch.no_grad(), quant_context("int8"):
                return model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                             context_mask=torch.from_numpy(cmask))[0].numpy()

        def jax_forward(self, h):  # eager, as in test_int8_dot_equals_jax
            y = jax_qm.int8_dot(jnp.asarray(h.numpy()), jnp.asarray(self.weight.numpy().T))
            y = torch.from_numpy(np.array(y))
            return y if self.bias is None else y + self.bias

        calls = _count_int8(monkeypatch)
        got = port()
        assert calls[0] == sum(isinstance(m, QuantLinear) for m in model.modules())
        monkeypatch.setattr(QuantLinear, "forward", jax_forward)
        np.testing.assert_array_equal(port(), got)

        with jax_qm.quant_context("int8"):  # read while tracing
            want, _ = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                            jnp.asarray(ctx), context_mask=jnp.asarray(cmask))
        want = np.asarray(want)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
        np.testing.assert_allclose(got, want, atol=0.05)


def _count_int8(monkeypatch):
    """Count the calls of ``int8_linear`` (the int8 route of QuantLinear)."""
    calls = [0]
    orig = qm.int8_linear

    def counted(*a):
        calls[0] += 1
        return orig(*a)

    monkeypatch.setattr(qm, "int8_linear", counted)
    return calls


class TestQuantLinear:
    def test_large_linear_quantizes(self):
        torch.manual_seed(0)
        lin = QuantLinear(256, 256)
        x = torch.from_numpy(_randn(7, 8, 256))
        with torch.no_grad():
            y_f = lin(x)
            with quant_context("int8"):
                y_q = lin(x)
                want = int8_dot(x, lin.weight.t()) + lin.bias
        d = (y_q - y_f).numpy()
        assert np.abs(d).max() > 0  # the path changed
        assert _rel(y_q.numpy(), y_f.numpy()) < 0.03
        np.testing.assert_array_equal(y_q.numpy(), want.numpy())

    def test_small_linear_stays_float(self):
        lin = QuantLinear(16, 16)
        x = torch.from_numpy(_randn(9, 4, 16))
        with torch.no_grad():
            y_f = lin(x)
            with quant_context("int8"):
                y_q = lin(x)
        np.testing.assert_array_equal(y_q.numpy(), y_f.numpy())

    def test_requantizes_after_a_weight_change(self):
        lin = QuantLinear(256, 256)
        x = torch.from_numpy(_randn(8, 2, 256))
        with torch.no_grad(), quant_context("int8"):
            a = lin(x)
            lin.weight.mul_(2.0)
            b = lin(x)
        bias = lin.bias.detach().numpy()
        np.testing.assert_allclose(b.numpy() - bias, 2 * (a.numpy() - bias), rtol=1e-5,
                                   atol=1e-6)

    def test_t5_and_vae_never_take_the_int8_route(self, monkeypatch):
        """With every layer above the threshold (MIN_QUANT_ELEMENTS = 0) and
        int8 on, T5 and the VAE run no int8 product; the DiT does."""
        from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

        from ezaudio_tpu_torch.api.ezaudio import EzAudio
        from ezaudio_tpu_torch.text.t5 import T5EncoderConfig

        monkeypatch.setattr(qm, "MIN_QUANT_ELEMENTS", 0)
        ez = EzAudio(config=TINY_CONFIG, vae_config=TINY_VAE_CONFIG,
                     t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)), device="cpu")
        assert not any(isinstance(m, QuantLinear) for m in ez.t5.modules())
        assert not any(isinstance(m, QuantLinear) for m in ez.autoencoder.model.modules())
        calls = _count_int8(monkeypatch)
        with torch.no_grad(), quant_context("int8"):
            ez.embed_text(["a dog barking"])
            z = ez.autoencoder.encode(np.zeros((1, 160, 1), np.float32), sample=False)
            ez.autoencoder.decode(z)
            assert calls[0] == 0
            ez.dit(torch.zeros(1, 10, 8), torch.tensor(5), torch.zeros(1, 3, 32))
        assert calls[0] > 0


class TestAPIQuant:
    def test_generate_int8_close_to_float(self, monkeypatch):
        """The tiny pipeline under quant='int8' (threshold lowered so its
        64-wide linears quantize): finite, changed, corr > 0.99 with float."""
        from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

        from ezaudio_tpu_torch.api.ezaudio import EzAudio
        from ezaudio_tpu_torch.text.t5 import T5EncoderConfig

        monkeypatch.setattr(qm, "MIN_QUANT_ELEMENTS", 64 * 64)
        ez = EzAudio(config=TINY_CONFIG, vae_config=TINY_VAE_CONFIG,
                     t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)), device="cpu")
        kw = dict(length=2, ddim_steps=5, random_seed=11)
        _, w_f = ez.generate_audio("rain", **kw)
        _, w_q = ez.generate_audio("rain", quant="int8", **kw)
        assert np.isfinite(w_q).all()
        assert np.abs(w_q - w_f).max() > 0
        assert np.corrcoef(w_f, w_q)[0, 1] > 0.99
