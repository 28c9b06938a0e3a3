"""The hand-written CUDA kernels against their plain versions, on a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU host without them; there the repository's conftest (which pins JAX to
the CPU) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py

Without a GPU every test skips.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import attention_agreement
from ezaudio_tpu_torch.ops.activations import snake_beta_vae
from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention
from ezaudio_tpu_torch.ops.kernels.resunit import (fused_residual_unit,
                                                   residual_unit_plain)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _qkv(rng, B, H, Lq, Lk, D):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D))]


def _tail_mask(B, Lk, valid):
    """Key masks with a masked tail that does not fill a whole tile."""
    m = np.zeros((B, Lk), bool)
    for b, n in enumerate(valid):
        m[b, :n] = True
    return m


def _resunit_inputs(rng, B, L, C):
    """Non-symmetric weights: w7 taps and w1 differ from their transposes."""
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w7 = (rng.standard_normal((7, C, C)) * 0.1).astype(np.float32)
    w7[:, 0, 1] += 0.5
    b7 = rng.standard_normal(C).astype(np.float32)
    w1 = (rng.standard_normal((C, C)) * 0.1).astype(np.float32)
    w1[0, 1] += 0.5
    b1 = rng.standard_normal(C).astype(np.float32)
    snk = [np.exp(rng.standard_normal(C) * 0.1).astype(np.float32) for _ in range(4)]
    return [x, w7, b7, w1, b1, *snk]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnGPU:
    """The hand-written kernels against their plain versions on the card
    (attention: ``chip_smoke.attention_agreement``, f32 atol 1e-4 and the
    bf16 limit stated there; ResidualUnit atol 1e-3)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", [9, 32, 64, 72, 128])
    @pytest.mark.parametrize("Lk", [500, 100, 37, 4])
    @pytest.mark.parametrize("Lq", [500, 37])
    def test_attention(self, rng, dtype, Lq, Lk, D):
        """Ragged query and key tiles (500 = 7 * 64 + 52, 37 < 64; the quality
        harnesses' 4 text tokens, one ragged key tile), head dims padded (9,
        32: the toy harness's), exact (64, 128) and between (72) the kernel's
        tile widths."""
        dev = _cuda()
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _qkv(rng, 2, 4, Lq, Lk, D))
        mask = torch.from_numpy(_tail_mask(2, Lk, [Lk - 7, Lk])).to(dev)
        before = fused_attention.launches
        got = fused_attention(q, k, v, key_mask=mask)
        assert fused_attention.launches == before + 1
        want = attention_plain(q, k, v, key_mask=mask)
        ok, err, share = attention_agreement(got, want, v)
        assert ok, f"max error {err}, {share} of the elements beyond one ulp"

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_attention_fully_masked_row(self, rng, dtype):
        """A batch whose keys are all masked stays uniform over them, as in
        the plain version."""
        dev = _cuda()
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _qkv(rng, 2, 2, 70, 90, 64))
        mask = torch.from_numpy(_tail_mask(2, 90, [0, 90])).to(dev)
        got = fused_attention(q, k, v, key_mask=mask)
        want = attention_plain(q, k, v, key_mask=mask)
        ok, err, share = attention_agreement(got, want, v)
        assert ok, f"max error {err}, {share} of the elements beyond one ulp"

    @pytest.mark.parametrize("C", [128, 256, 512])
    @pytest.mark.parametrize("dilation", [1, 3, 9])
    def test_resunit(self, rng, dilation, C):
        """C = 128, 256, 512 run as clusters of 1, 2 and 4 blocks; L = 300
        leaves a ragged last 64-row tile."""
        dev = _cuda()
        args = [torch.from_numpy(a).to(dev) for a in _resunit_inputs(rng, 2, 300, C)]
        before = fused_residual_unit.launches
        got = fused_residual_unit(*args, dilation)
        assert fused_residual_unit.launches == before + 1
        want = residual_unit_plain(*args, dilation)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)

    @pytest.mark.parametrize("C", [128, 512])
    def test_resunit_bf16(self, rng, C):
        """The bf16 MMA path against its function in f32: snake1 and snake2
        rounded to bf16 as the operand type does, sums in f32.  Sums in
        another order move a rounded G by one bf16 ulp now and then, and y
        is rounded to bf16, so the limit is 2 % of max |y|: a wrong fragment
        or operand layout is off by the order of |y| itself."""
        dev = _cuda()
        args = [torch.from_numpy(a).to(dev, torch.bfloat16)
                for a in _resunit_inputs(rng, 2, 300, C)]
        got = fused_residual_unit(*args, 9).float()
        x, w7, b7, w1, b1, a1, be1, a2, be2 = (a.float() for a in args)
        bf = lambda t: t.bfloat16().float()  # noqa: E731
        h = bf(snake_beta_vae(x, a1, be1))
        h = F.conv1d(h.transpose(1, 2), w7.permute(2, 1, 0), b7, padding=27,
                     dilation=9).transpose(1, 2)
        want = x + (bf(snake_beta_vae(h, a2, be2)) @ w1 + b1)
        err = (got - want).abs().max().item()
        assert err <= 0.02 * want.abs().max().item(), err

    def test_resunit_refuses_what_the_kernel_cannot_take(self, rng):
        dev = _cuda()
        args = [torch.from_numpy(a).to(dev) for a in _resunit_inputs(rng, 1, 100, 96)]
        with pytest.raises(RuntimeError, match=r"\(1, 100, 96\)"):
            fused_residual_unit(*args, 1)


@pytest.mark.cuda
class TestInt8AndGraphsOnGPU:
    """The int8 product and the CUDA-graph program of the fused path on
    the card."""

    @pytest.mark.parametrize("M,K,N", [(2, 1024, 6144), (16, 256, 1024), (17, 1024, 2048),
                                       (1000, 4096, 1024)])
    def test_int8_matmul_equals_plain(self, rng, M, K, N):
        """``torch._int_mm`` (rows padded to 17 below that) against the
        exact float64 product: bit-equal."""
        from ezaudio_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain

        dev = _cuda()
        a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8)).to(dev)
        got = int8_matmul(a, b)
        assert got.shape == (M, N) and got.dtype == torch.int32
        assert torch.equal(got, int8_matmul_plain(a, b))

    def test_int8_matmul_raises_where_int_mm_refuses(self, rng):
        from ezaudio_tpu_torch.ops.quant import int8_matmul

        dev = _cuda()
        a = torch.ones(32, 12, dtype=torch.int8, device=dev)
        with pytest.raises(RuntimeError):
            int8_matmul(a, torch.ones(8, 12, dtype=torch.int8, device=dev))

    def test_graph_program_replays_both_kernels(self, rng):
        """Both kernels launched inside a captured graph: a replay on new
        inputs equals the eager run, one launch of each per replay."""
        from ezaudio_tpu_torch.api.graphs import GraphProgram

        dev = _cuda()
        args = [torch.from_numpy(a).to(dev) for a in _resunit_inputs(rng, 1, 300, 128)]
        q, k, v = (torch.from_numpy(a).to(dev) for a in _qkv(rng, 2, 4, 70, 70, 64))

        def fn(x, q):
            return fused_residual_unit(x, *args[1:], 3).sum() + fused_attention(q, k, v).sum()

        prog = GraphProgram(fn, dev, torch.cuda.graph_pool_handle())
        prog(args[0], q)
        assert prog.launches == {"attention": 1, "resunit": 1}
        x2, q2 = args[0] * 0.5, q.flip(2).contiguous()
        got = prog(x2, q2).clone()
        assert prog.replays == 2
        torch.testing.assert_close(got, fn(x2, q2), rtol=0, atol=0)


@pytest.mark.cuda
class TestKernelGradientsOnGPU:
    """The kernels' autograd Functions on the card: every output computed
    with grad enabled has the kernel's ``grad_fn`` (ROADMAP F11), one
    counted launch per forward, and the gradients of the plain twin
    (the backward is its vjp in both: within 1e-6 of each gradient's
    largest entry)."""

    @pytest.mark.parametrize("Lk,masked", [(500, False), (100, True)])
    def test_attention_gradients(self, rng, Lk, masked):
        dev = _cuda()
        arrays = _qkv(rng, 2, 4, 500, Lk, 64)
        leaves = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
        mask = torch.from_numpy(_tail_mask(2, Lk, [23, Lk])).to(dev) if masked else None
        g = torch.from_numpy(rng.standard_normal((2, 4, 500, 64)).astype(np.float32)).to(dev)
        before = fused_attention.launches
        o = fused_attention(*leaves, key_mask=mask)
        assert type(o.grad_fn).__name__ == "FusedAttentionBackward"
        got = torch.autograd.grad(o, leaves, g)
        assert fused_attention.launches == before + 1
        want = torch.autograd.grad(attention_plain(*leaves, key_mask=mask), leaves, g)
        for a, b in zip(got, want):
            assert a.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * b.abs().max().item())

    def test_resunit_gradients(self, rng):
        dev = _cuda()
        leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in _resunit_inputs(rng, 2, 300, 256)]
        g = torch.from_numpy(rng.standard_normal((2, 300, 256)).astype(np.float32)).to(dev)
        before = fused_residual_unit.launches
        y = fused_residual_unit(*leaves, 3)
        assert type(y.grad_fn).__name__ == "FusedResidualUnitBackward"
        got = torch.autograd.grad(y, leaves, g)
        assert fused_residual_unit.launches == before + 1
        want = torch.autograd.grad(residual_unit_plain(*leaves, 3), leaves, g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * b.abs().max().item())
