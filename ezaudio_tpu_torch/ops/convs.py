"""Conv1d, Conv2d and ConvTranspose1d that sum in f32 whatever their input's dtype
(in float64 for a float64 input)
(counterpart of the convolutions of ``ezaudio_tpu/ops/convs.py`` and
``codecs/oobleck_fast.py``, and of the CLAP patch embedding), with optional
live weight norm.

In a bf16 model the JAX package convolves bf16 inputs with bf16 copies of
its weights; the products are exact in f32, the sums f32, the output
rounded to bf16 once.  These modules compute that function on every
device: a non-f32 input and the weights are widened to f32, convolved, and
the output cast back.  (torch's own bf16 CPU convolution is not that
function: a strided bf16 Conv1d with 8 input channels, 16 output
channels, kernel 8 and stride 4 returns values off by their own magnitude
in torch 2.13's CPU build.)  An f32 input is the parent's forward.
Parameter names and layouts are ``torch.nn``'s, so reference state dicts
load as they are.

``weight_norm=True`` is ``torch.nn.utils.weight_norm`` with its default
``dim=0``, under its names: the parameters are ``weight_g`` and
``weight_v``, and ``.weight`` is computed from them at every read,
``g / ||v|| * v`` with the norm over every axis but the first.  The first
axis is the output channel of Conv1d and Conv2d, (out, in, k[, k]), and
the INPUT channel of ConvTranspose1d, (in, out, k), as torch defines it
(the JAX package's v/g, ``ezaudio_tpu/ops/convs.py:118-121``).  Whoever
reads ``.weight`` (the forward, ``codecs/oobleck_fast.py``'s kernel
routing) gets a tensor whose gradient reaches ``weight_g`` and
``weight_v``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype a conv sums in: f32, or float64 for a float64 input."""
    return torch.promote_types(t.dtype, torch.float32)


def _to(t, dtype):
    return None if t is None else t.to(dtype)


def weight_norm_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g / max(||v||, 1e-12) * v``, the norm over every axis of ``v`` but
    the first."""
    norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return (g / norm.clamp_min(1e-12)) * v


class _WeightNorm:
    """``.weight``: the parameter, or with weight norm ``weight_g`` and
    ``weight_v`` combined."""

    def _init_weight_norm(self, weight_norm: bool) -> None:
        if not weight_norm:
            return
        w = self._parameters.pop("weight").detach()
        self.weight_g = nn.Parameter(w.square().sum(dim=tuple(range(1, w.ndim)),
                                                    keepdim=True).sqrt())
        self.weight_v = nn.Parameter(w)

    @property
    def weight(self):
        w = self._parameters.get("weight")
        if w is not None:
            return w
        # nn.Module.__getattr__ raises AttributeError while neither exists
        return weight_norm_weight(self.weight_g, self.weight_v)


class Conv1d(_WeightNorm, nn.Conv1d):
    def __init__(self, *args, weight_norm: bool = False, **kw):
        super().__init__(*args, **kw)
        self._init_weight_norm(weight_norm)

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        acc = _acc(x)
        return self._conv_forward(x.to(acc), self.weight.to(acc), _to(self.bias, acc)).to(x.dtype)


class Conv2d(_WeightNorm, nn.Conv2d):
    def __init__(self, *args, weight_norm: bool = False, **kw):
        super().__init__(*args, **kw)
        self._init_weight_norm(weight_norm)

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        acc = _acc(x)
        return self._conv_forward(x.to(acc), self.weight.to(acc), _to(self.bias, acc)).to(x.dtype)


class ConvTranspose1d(_WeightNorm, nn.ConvTranspose1d):
    def __init__(self, *args, weight_norm: bool = False, **kw):
        super().__init__(*args, **kw)
        self._init_weight_norm(weight_norm)

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        acc = _acc(x)
        y = F.conv_transpose1d(x.to(acc), self.weight.to(acc), _to(self.bias, acc), self.stride,
                               self.padding, self.output_padding, self.groups, self.dilation)
        return y.to(x.dtype)
