"""Activation functions (counterpart of ``ezaudio_tpu/ops/activations.py``).

  * ``gelu`` exact (erf) form — torch ``F.gelu`` default;
  * ``gelu_tanh`` — tanh approximation (HF ``gelu_new``), written out in
    the JAX package's op order;
  * ``geglu(x) = a * gelu(b)`` over a packed ``[a | b]`` projection;
  * ``snake_beta_vae``: ``x + (1/(beta+1e-9)) * sin(alpha x)^2`` with
    already exp'd per-channel alpha/beta (Oobleck VAE SnakeBeta).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x):
    return F.gelu(x)


def gelu_tanh(x):
    x3 = x * x * x
    return 0.5 * x * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * x3)))


def geglu(x_packed):
    a, b = x_packed.chunk(2, dim=-1)
    return a * gelu(b)


def snake_beta_vae(x, alpha, beta):
    """``alpha``/``beta`` broadcast against ``x`` (per channel, last axis)."""
    return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha).square()
