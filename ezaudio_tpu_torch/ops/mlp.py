"""FiLM modulation and the transformer feed-forward block
(counterpart of ``ezaudio_tpu/ops/mlp.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ezaudio_tpu_torch.ops import activations as act
from ezaudio_tpu_torch.ops.quant import QuantLinear
from ezaudio_tpu_torch.utils import cast_params_

# act_layer -> (projection width in units of inner, activation); snake and
# gesnake also carry per-channel alpha/beta (f32, shape (1, 1, inner))
ACTIVATIONS = {
    "gelu": (1, act.gelu),
    "gelu-approximate": (1, act.gelu_tanh),
    "geglu": (2, act.geglu),
    "geglu-approximate": (1, act.approximate_gelu),
    "snake": (1, None),
    "gesnake": (2, None),
}


def film_modulate(x, shift, scale):
    """``x * (1 + scale) + shift`` with (B, 1, D) broadcast conditioning."""
    return x * (1 + scale) + shift


class ActProj(nn.Module):
    """``net.0`` of the reference FeedForward: the input projection
    ``proj`` and its activation.  The snakes' ``alpha`` and ``beta`` stay
    f32 in a bf16 model and are cast to the activations' dtype at use, as
    the JAX package does (``cast_``)."""

    def __init__(self, dim: int, inner: int, activation_fn: str):
        super().__init__()
        mult, self.fn = ACTIVATIONS[activation_fn]
        self.gated_snake = activation_fn == "gesnake"
        self.proj = QuantLinear(dim, inner * mult)
        if self.fn is None:
            self.alpha = nn.Parameter(torch.ones(1, 1, inner))
            self.beta = nn.Parameter(torch.ones(1, 1, inner))

    def cast_(self, dtype, cast=None):
        cast_params_(self.proj, dtype, cast)

    def forward(self, x):
        h = self.proj(x)
        if self.fn is not None:
            return self.fn(h)
        alpha, beta = self.alpha.to(h.dtype), self.beta.to(h.dtype)
        if self.gated_snake:
            a, gate = h.chunk(2, dim=-1)
            return a * act.snake_beta(gate, alpha, beta)
        return act.snake_beta(h, alpha, beta)


class FeedForward(nn.Module):
    """Transformer MLP; ``net.0.proj`` / ``net.2`` as the reference's
    diffusers-style FeedForward (modules.py:328-374), with the activations
    of :data:`ACTIVATIONS` (an unknown one raises)."""

    def __init__(self, dim: int, mult: float = 4.0, activation_fn: str = "geglu"):
        super().__init__()
        if activation_fn not in ACTIVATIONS:
            raise NotImplementedError(f"act_layer={activation_fn!r}")
        inner = int(dim * mult)
        self.net = nn.Sequential(ActProj(dim, inner, activation_fn), nn.Identity(),
                                 QuantLinear(inner, dim))

    def forward(self, x):
        return self.net(x)
