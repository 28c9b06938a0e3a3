"""Port kernels: the plain PyTorch versions against the JAX package's
functions (on the CPU), and the CUDA kernels against their plain versions
(on a GPU only).

Inputs come from a seeded numpy RNG and go to both sides as numpy arrays.
Tolerances: atol 2e-5 for the f32 plain versions against JAX, as
``tests/test_pallas.py`` holds the Pallas kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.ops.attention import dot_product_attention as jax_dpa
from ezaudio_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from ezaudio_tpu.ops.pallas.resunit import (fused_residual_unit as jax_fru,
                                            residual_unit_reference as jax_ru_ref)
from ezaudio_tpu_torch.ops.attention import dot_product_attention
from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention
from ezaudio_tpu_torch.ops.kernels.resunit import (fused_residual_unit,
                                                   residual_unit_plain)
from tests.test_torch_kernels_gpu import _qkv, _resunit_inputs, _tail_mask

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test (xdist runs six workers); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestAttentionPlain:
    @pytest.mark.parametrize("B,H,Lq,Lk,D", [
        (2, 3, 40, 24, 8),
        (1, 2, 37, 19, 9),      # odd head dim
        (1, 2, 20, 36, 72),     # s3_xl head dim at small L
    ])
    def test_matches_jax_einsum(self, rng, B, H, Lq, Lk, D):
        q, k, v = _qkv(rng, B, H, Lq, Lk, D)
        mask = _tail_mask(B, Lk, [Lk - 5, Lk][:B])
        want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=jnp.asarray(mask)[:, None, None, :])
        tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
        got_plain = attention_plain(tq, tk, tv, key_mask=tm)
        got_ref = dot_product_attention(tq, tk, tv, mask=tm[:, None, None, :])
        np.testing.assert_allclose(got_plain.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(got_ref.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("B,H,Lq,Lk,D,scale,masked", [
        (1, 2, 16, 16, 8, None, False),
        (2, 2, 24, 40, 9, 0.5, True),
        (1, 1, 12, 20, 72, None, True),
    ])
    def test_matches_pallas_interpret(self, rng, B, H, Lq, Lk, D, scale, masked):
        q, k, v = _qkv(rng, B, H, Lq, Lk, D)
        mask = _tail_mask(B, Lk, [Lk - 3, Lk - 11][:B]) if masked else None
        want = jax_fused_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            key_mask=None if mask is None else jnp.asarray(mask),
            scale=scale, interpret=True)
        got = fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              key_mask=None if mask is None else torch.from_numpy(mask),
                              scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_cpu_tensor_takes_plain_version(self, rng):
        q, k, v = map(torch.from_numpy, _qkv(rng, 1, 1, 8, 8, 8))
        before = fused_attention.launches
        fused_attention(q, k, v)
        assert fused_attention.launches == before


class TestResidualUnitPlain:
    @pytest.mark.parametrize("dilation", [1, 3, 9])
    def test_matches_jax_reference_and_interpret(self, rng, dilation):
        # L longer than the CUDA kernel's 32-row tile: seams and both ends
        args = _resunit_inputs(rng, 2, 75, 16)
        want_ref = jax_ru_ref(*map(jnp.asarray, args), dilation)
        want_kernel = jax_fru(*map(jnp.asarray, args), dilation, True)
        got = residual_unit_plain(*map(torch.from_numpy, args), dilation)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)

    def test_wrapper_cpu_is_plain(self, rng):
        args = list(map(torch.from_numpy, _resunit_inputs(rng, 1, 40, 8)))
        before = fused_residual_unit.launches
        got = fused_residual_unit(*args, 3)
        assert fused_residual_unit.launches == before
        torch.testing.assert_close(got, residual_unit_plain(*args, 3), rtol=0, atol=0)
