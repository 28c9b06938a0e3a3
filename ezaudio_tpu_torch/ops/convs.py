"""Conv1d, Conv2d and ConvTranspose1d that sum in f32 whatever their input's dtype
(counterpart of the convolutions of ``ezaudio_tpu/ops/convs.py`` and
``codecs/oobleck_fast.py``, and of the CLAP patch embedding).

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _f32(t):
    return None if t is None else t.float()


class Conv1d(nn.Conv1d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return self._conv_forward(x.float(), self.weight.float(), _f32(self.bias)).to(x.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return self._conv_forward(x.float(), self.weight.float(), _f32(self.bias)).to(x.dtype)


class ConvTranspose1d(nn.ConvTranspose1d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        y = F.conv_transpose1d(x.float(), self.weight.float(), _f32(self.bias), self.stride,
                               self.padding, self.output_padding, self.groups, self.dilation)
        return y.to(x.dtype)
