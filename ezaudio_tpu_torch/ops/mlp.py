"""FiLM modulation and the GEGLU feed-forward block
(counterpart of ``ezaudio_tpu/ops/mlp.py``)."""

from __future__ import annotations

from torch import nn

from ezaudio_tpu_torch.ops import activations as act
from ezaudio_tpu_torch.ops.quant import QuantLinear


def film_modulate(x, shift, scale):
    """``x * (1 + scale) + shift`` with (B, 1, D) broadcast conditioning."""
    return x * (1 + scale) + shift


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QuantLinear(dim, inner * 2)

    def forward(self, x):
        return act.geglu(self.proj(x))


class FeedForward(nn.Module):
    """Transformer MLP; ``net.0.proj`` / ``net.2`` as the reference's
    diffusers-style FeedForward (modules.py:328-374)."""

    def __init__(self, dim: int, mult: float = 4.0, activation_fn: str = "geglu"):
        super().__init__()
        if activation_fn != "geglu":
            raise NotImplementedError(f"act_layer={activation_fn!r}")
        inner = int(dim * mult)
        self.net = nn.Sequential(_GEGLUProj(dim, inner), nn.Identity(),
                                 QuantLinear(inner, dim))

    def forward(self, x):
        return self.net(x)
