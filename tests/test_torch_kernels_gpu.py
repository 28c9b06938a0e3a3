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

from chip_smoke import attention_agreement
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
    @pytest.mark.parametrize("Lk,D", [(500, 64), (100, 72), (37, 9)])
    def test_attention(self, rng, dtype, Lk, D):
        dev = _cuda()
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _qkv(rng, 2, 4, 500, Lk, D))
        mask = torch.from_numpy(_tail_mask(2, Lk, [Lk - 7, Lk])).to(dev)
        before = fused_attention.launches
        got = fused_attention(q, k, v, key_mask=mask)
        assert fused_attention.launches == before + 1
        want = attention_plain(q, k, v, key_mask=mask)
        ok, err, share = attention_agreement(got, want, v)
        assert ok, f"max error {err}, {share} of the elements beyond one ulp"

    @pytest.mark.parametrize("dilation", [1, 3, 9])
    def test_resunit(self, rng, dilation):
        dev = _cuda()
        args = [torch.from_numpy(a).to(dev) for a in _resunit_inputs(rng, 2, 300, 128)]
        got = fused_residual_unit(*args, dilation)
        want = residual_unit_plain(*args, dilation)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
