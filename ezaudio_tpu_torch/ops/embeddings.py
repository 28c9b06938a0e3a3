"""Timestep and positional embeddings and patch projection, channel-last
(counterpart of ``ezaudio_tpu/ops/embeddings.py``).

Module names follow the reference torch modules (``time_embed.mlp.0``,
``context_embed.0``, ``patch_embed.proj``, ``x_pe.abs_pe``,
``context_pe.sinu_pe.pe``, ``x_pe.conv_pe.conv.weight_g``) so reference
state dicts load as they are.  The positional embeddings keep their
tables and parameters in f32 in a bf16 model and cast them to the
activations' dtype at use, as the JAX package does (``PEWrapper.cast_``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.ops.convs import Conv1d
from ezaudio_tpu_torch.ops.quant import QuantLinear

PE_METHODS = ("abs", "conv", "sinu", "none")


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """``[cos(t f) | sin(t f)]`` — cos first, as reference modules.py:19-37."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            QuantLinear(frequency_embedding_size, hidden_size), nn.SiLU(),
            QuantLinear(hidden_size, hidden_size))

    def forward(self, t):
        h = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(h.to(self.mlp[0].weight.dtype))


class MLPEmbedder(nn.Sequential):
    """Linear/SiLU/Linear projector (``context_embed`` and ``cls_embed`` in
    udit.py); ``zero_out`` zero-initialises the second linear, as the JAX
    package does for ``cls_embed`` under AdaLN."""

    def __init__(self, in_dim: int, dim: int, zero_out: bool = False):
        super().__init__(QuantLinear(in_dim, dim), nn.SiLU(), QuantLinear(dim, dim))
        if zero_out:
            nn.init.zeros_(self[2].weight)
            nn.init.zeros_(self[2].bias)


class PatchEmbed1D(nn.Module):
    """Strided Conv1d patch projection on channel-last input:
    (B, T, C) -> (B, T // p, D).  ``proj.weight`` keeps the torch Conv1d
    shape (D, C, p); the product runs as one matmul over the patches."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv1d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        B, T, C = x.shape
        p = self.patch_size
        if T % p:
            raise ValueError(f"sequence length {T} not divisible by patch {p}")
        w = self.proj.weight.permute(2, 1, 0).reshape(p * C, -1)
        return x.reshape(B, T // p, p * C).to(w.dtype) @ w + self.proj.bias


def sinusoidal_table(length: int, dim: int) -> torch.Tensor:
    """(1, length, dim) f32: sin at the even channels, cos at the odd ones
    (reference modules.py:138-158)."""
    position = torch.arange(length, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe[None]


class SinusoidalPE(nn.Module):
    """Adds the interleaved sin/cos table ``pe`` (a buffer, made once)."""

    def __init__(self, dim: int, length: int):
        super().__init__()
        self.register_buffer("pe", sinusoidal_table(length, dim))

    def forward(self, x):
        return x + self.pe[:, :x.shape[1]].to(x.dtype)


class PositionalConvEmbedding(nn.Module):
    """HuBERT-style PE: a weight-normalised grouped Conv1d (k = 128, 16
    groups, padding 64), its last frame dropped, then exact GELU.  The
    weight is computed in f32 from ``weight_g``/``weight_v`` and rounded to
    the input's dtype, as the JAX package casts its kernel at use."""

    def __init__(self, dim: int, kernel_size: int = 128, groups: int = 16):
        super().__init__()
        self.conv = Conv1d(dim, dim, kernel_size, padding=kernel_size // 2, groups=groups,
                           weight_norm=True)

    def forward(self, x):
        c = self.conv
        acc = torch.promote_types(x.dtype, torch.float32)
        h = F.conv1d(x.transpose(1, 2).to(acc), c.weight.to(x.dtype).to(acc),
                     c.bias.to(x.dtype).to(acc), c.stride, c.padding, c.dilation, c.groups)
        return F.gelu(h[:, :, :-1].to(x.dtype)).transpose(1, 2)


class PEWrapper(nn.Module):
    """Positional-embedding switch (reference modules.py:161-193):
    ``abs`` (a learned (1, length, dim) ``abs_pe``), ``conv``
    (:class:`PositionalConvEmbedding`), ``sinu`` (:class:`SinusoidalPE`)
    or ``none``; another method raises."""

    def __init__(self, method: str = "none", dim: Optional[int] = None,
                 length: Optional[int] = None):
        super().__init__()
        if method not in PE_METHODS:
            raise NotImplementedError(f"pe_method={method!r}")
        if method in ("abs", "sinu") and length is None:
            raise ValueError(f"pe_method={method!r} needs its length")
        self.method = method
        if method == "abs":
            self.abs_pe = nn.Parameter(torch.zeros(1, length, dim))
            nn.init.trunc_normal_(self.abs_pe, std=0.02, a=-2.0, b=2.0)
        elif method == "conv":
            self.conv_pe = PositionalConvEmbedding(dim)
        elif method == "sinu":
            self.sinu_pe = SinusoidalPE(dim, length)

    def cast_(self, dtype, cast=None):
        """Everything here stays f32 (``utils.cast_params_``)."""

    def forward(self, x):
        if self.method == "abs":
            return x + self.abs_pe[:, :x.shape[1]].to(x.dtype)
        if self.method == "conv":
            return x + self.conv_pe(x)
        if self.method == "sinu":
            return self.sinu_pe(x)
        return x


def patchify_2d(x, patch_size: int):
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C), each patch packed (row, col, C)."""
    B, H, W, C = x.shape
    p = patch_size
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify_2d(x, channels: int, img_size):
    """(B, h*w, p*p*C) -> (B, H, W, C)."""
    B, L, PPC = x.shape
    p = int(round((PPC // channels) ** 0.5))
    H, W = img_size
    x = x.reshape(B, H // p, W // p, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, channels)


class PatchEmbed2D(nn.Module):
    """Strided Conv2d patch projection on channel-last input: (B, H, W, C)
    -> (B, H/p * W/p, D); ``proj.weight`` keeps the torch Conv2d shape
    (D, C, p, p), the product runs as one matmul over the patches."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        p = self.patch_size
        if x.shape[1] % p or x.shape[2] % p:
            raise ValueError(f"image {tuple(x.shape[1:3])} not divisible by patch {p}")
        w = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * x.shape[-1], -1)
        return patchify_2d(x, p).to(w.dtype) @ w + self.proj.bias


def unpatchify_1d(x, channels: int):
    """(B, L, p*C) -> (B, L*p, C)."""
    B, L, PC = x.shape
    return x.reshape(B, L * (PC // channels), channels)
