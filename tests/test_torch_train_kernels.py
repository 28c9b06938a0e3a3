"""The kernels' autograd Functions on the CPU: gradients of both wrappers
against ``jax.vjp`` of the JAX package's differentiable kernels
(``fused_attention(..., interpret=True)``, ``fused_residual_unit``), the
saved tensors, the launch counts of forward, backward and recompute, and
the ``grad_fn`` of every output computed with grad enabled.

Tolerances: f32 gradients within atol 2e-5 + rtol 1e-5 of JAX's (the
forward's 2e-5 of ``tests/test_torch_kernels.py``; a gradient sums over
one more axis).  bf16 is held against the autograd of the plain twin in
bf16, the kernel's function (F9), within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint as tc

import ezaudio_tpu_torch.ops.kernels.attention as ka
import ezaudio_tpu_torch.ops.kernels.resunit as kr
from ezaudio_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from ezaudio_tpu.ops.pallas.resunit import fused_residual_unit as jax_fru
from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention
from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit, residual_unit_plain
from tests.test_torch_kernels_gpu import _qkv, _resunit_inputs, _tail_mask

ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


class TestAttentionGrad:
    @pytest.mark.parametrize("B,H,Lq,Lk,D,scale,masked", [
        (2, 2, 24, 24, 8, None, False),   # self-attention
        (2, 2, 24, 13, 9, 0.5, True),     # cross-attention, padded keys
        (1, 2, 12, 20, 72, None, True),   # s3_xl head dim
    ])
    def test_vjp_matches_jax(self, rng, B, H, Lq, Lk, D, scale, masked):
        q, k, v = _qkv(rng, B, H, Lq, Lk, D)
        g = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
        mask = _tail_mask(B, Lk, [Lk - 4, Lk][:B]) if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        out, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(
            a, b, c, key_mask=jm, scale=scale, interpret=True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
        tq, tk, tv = _leaves((q, k, v))
        o = fused_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                            scale=scale)
        assert o.grad_fn is not None and type(o.grad_fn).__name__ == "FusedAttentionBackward"
        _close(o, out)
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
        for a, b in zip(got, want):
            _close(a, b)

    def test_bf16_is_the_twins_vjp(self, rng):
        q, k, v = _qkv(rng, 2, 2, 20, 11, 16)
        mask = torch.from_numpy(_tail_mask(2, 11, [7, 11]))
        g = torch.from_numpy(rng.standard_normal((2, 2, 20, 16)).astype(np.float32))
        leaves = _leaves((q, k, v), torch.bfloat16)
        got = torch.autograd.grad(fused_attention(*leaves, mask), leaves, g.bfloat16())
        ref = _leaves((q, k, v), torch.bfloat16)
        want = torch.autograd.grad(attention_plain(*ref, mask), ref, g.bfloat16())
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_backward_saves_inputs_and_launches_no_kernel(self, rng, monkeypatch):
        """The Function saves q, k, v and the mask, not the scores, and its
        backward recomputes through the plain twin, not the wrapper's
        forward: one counted launch per forward."""
        calls = []

        def counted(*a, **kw):
            calls.append(a[0].shape)
            return ka._plain(*a, **kw)

        monkeypatch.setattr(ka, "attention_plain", counted)
        q, k, v = _leaves(_qkv(rng, 1, 2, 16, 16, 8))
        mask = torch.ones(1, 16, dtype=torch.bool)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                      lambda t: t):
            o = fused_attention(q, k, v, mask)
        assert sorted(saved) == sorted([q.shape, k.shape, v.shape, mask.shape])
        o.sum().backward()
        assert len(calls) == 1 and q.grad is not None

    def test_checkpoint_recomputes_the_forward(self, rng, monkeypatch):
        """Under non-reentrant checkpointing the forward runs again in the
        backward (two launches), and the gradients are unchanged."""
        n = [0]
        plain = ka.attention_plain

        def counted(*a, **kw):
            n[0] += 1
            return plain(*a, **kw)

        monkeypatch.setattr(ka, "attention_plain", counted)
        arrays = _qkv(rng, 1, 2, 16, 16, 8)
        leaves = _leaves(arrays)
        tc.checkpoint(fused_attention, *leaves, use_reentrant=False).square().sum().backward()
        assert n[0] == 2
        ref = _leaves(arrays)
        fused_attention(*ref).square().sum().backward()
        for a, b in zip(leaves, ref):
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)

    def test_no_grad_and_frozen_inputs_skip_the_function(self, rng):
        q, k, v = map(torch.from_numpy, _qkv(rng, 1, 1, 8, 8, 8))
        assert fused_attention(q, k, v).grad_fn is None
        with torch.no_grad():
            assert fused_attention(*_leaves((q.numpy(), k.numpy(), v.numpy()))).grad_fn is None
        k_only = fused_attention(q, k.clone().requires_grad_(), v)
        assert k_only.grad_fn is not None


class TestResidualUnitGrad:
    @pytest.mark.parametrize("dilation", [1, 3, 9])
    def test_vjp_matches_jax(self, rng, dilation):
        args = _resunit_inputs(rng, 2, 45, 16)
        g = rng.standard_normal((2, 45, 16)).astype(np.float32)
        out, vjp = jax.vjp(lambda *a: jax_fru(*a, dilation), *map(jnp.asarray, args))
        want = vjp(jnp.asarray(g))
        leaves = _leaves(args)
        y = fused_residual_unit(*leaves, dilation)
        assert type(y.grad_fn).__name__ == "FusedResidualUnitBackward"
        _close(y, out)
        got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
        assert len(got) == 9
        for i, (a, b) in enumerate(zip(got, want)):
            scale = float(np.abs(np.asarray(b)).max())
            _close(a, b, atol=ATOL * max(1.0, scale))

    def test_bf16_is_the_twins_vjp(self, rng):
        args = _resunit_inputs(rng, 1, 40, 16)
        g = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(np.float32)).bfloat16()

        def leaves():
            # x and weights bf16, snake parameters f32, as the bf16 VAE runs
            return (_leaves(args[:5], torch.bfloat16) + _leaves(args[5:]))

        a = leaves()
        got = torch.autograd.grad(fused_residual_unit(*a, 3), a, g)
        b = leaves()
        want = torch.autograd.grad(residual_unit_plain(*b, 3), b, g)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)

    def test_one_forward_launch_per_call(self, rng, monkeypatch):
        n = [0]

        def counted(*a, **kw):
            n[0] += 1
            return kr._plain(*a, **kw)

        monkeypatch.setattr(kr, "residual_unit_plain", counted)
        leaves = _leaves(_resunit_inputs(rng, 1, 30, 8))
        fused_residual_unit(*leaves, 1).sum().backward()
        assert n[0] == 1 and all(t.grad is not None for t in leaves)
        with torch.no_grad():
            assert fused_residual_unit(*leaves, 1).grad_fn is None
