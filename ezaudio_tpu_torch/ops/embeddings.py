"""Timestep embeddings and patch projection, channel-last
(counterpart of ``ezaudio_tpu/ops/embeddings.py``).

Module names follow the reference torch modules (``time_embed.mlp.0``,
``context_embed.0``, ``patch_embed.proj``) so reference state dicts load
as they are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ezaudio_tpu_torch.ops.quant import QuantLinear


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
    """Linear/SiLU/Linear projector (``context_embed`` in udit.py)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__(QuantLinear(in_dim, dim), nn.SiLU(), QuantLinear(dim, dim))


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
        return x.reshape(B, T // p, p * C) @ w + self.proj.bias


class PEWrapper(nn.Module):
    """Positional-embedding switch; this slice carries ``none`` only (the
    setting of every EzAudio config)."""

    def __init__(self, method: str = "none"):
        super().__init__()
        if method != "none":
            raise NotImplementedError(f"pe_method={method!r}")

    def forward(self, x):
        return x


def unpatchify_1d(x, channels: int):
    """(B, L, p*C) -> (B, L*p, C)."""
    B, L, PC = x.shape
    return x.reshape(B, L * (PC // channels), channels)
