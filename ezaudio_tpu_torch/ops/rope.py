"""Rotary position embeddings, GPT-NeoX half-split convention
(counterpart of ``ezaudio_tpu/ops/rope.py``)."""

from __future__ import annotations

import torch


def inv_freq(head_dim: int, base: float = 10000.0) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))


def rope_tables(seq_len: int, head_dim: int, base: float = 10000.0,
                freqs: torch.Tensor | None = None):
    """(cos, sin) tables of shape (seq_len, head_dim), float32.  ``freqs``
    overrides the inverse frequencies (the module's ``inv_freq`` buffer)."""
    f = inv_freq(head_dim, base) if freqs is None else freqs.float()
    t = torch.arange(seq_len, dtype=torch.float32, device=f.device)
    emb = torch.outer(t, f)
    emb = torch.cat([emb, emb], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, cos, sin):
    """Rotate ``x`` (..., L, D) in float32, cast back to ``x.dtype``."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_rope_skip_prefix(x, cos, sin, extras: int):
    """Rotate only positions ``extras:``; the prefix passes unrotated."""
    if extras == 0:
        return apply_rope(x, cos, sin)
    prefix, rest = x[..., :extras, :], x[..., extras:, :]
    n = rest.shape[-2]
    return torch.cat([prefix, apply_rope(rest, cos[:n], sin[:n])], dim=-2)
