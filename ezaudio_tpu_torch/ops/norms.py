"""LayerNorm and RMSNorm over the trailing axis, normalized in float32
(counterpart of ``ezaudio_tpu/ops/norms.py``).  Their parameters stay
float32 in a bf16 model, as the JAX package's do: ``cast_`` leaves them."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """``torch.nn.LayerNorm`` semantics (eps 1e-5, affine), f32 compute."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)

    def cast_(self, dtype):
        """Weight and bias stay f32 (``utils.cast_params_``)."""


class RMSNorm(nn.Module):
    """Reference RMSNorm: normalize in f32, cast back, then scale by the
    f32 weight and cast to x's dtype (JAX ``y.astype(x.dtype) * w``, then
    ``.astype(dtype)``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y.to(x.dtype) * self.weight).to(x.dtype)

    def cast_(self, dtype):
        """The weight stays f32 (``utils.cast_params_``)."""


def make_norm(kind: str, dim: int) -> nn.Module:
    if kind in ("layernorm", "layer_norm"):
        return LayerNorm(dim)
    if kind in ("rmsnorm", "rms_norm"):
        return RMSNorm(dim)
    raise NotImplementedError(f"unknown norm: {kind}")
