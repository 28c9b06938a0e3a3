"""The stable-VAE family's other bottlenecks (counterpart of
``ezaudio_tpu/codecs/bottlenecks.py``; reference
``src/modules/stable_vae/models/bottleneck.py`` :10-346).  EzAudio's own is
``vae`` (``codecs/oobleck.py``):

  * ``TanhBottleneck`` (:35-48), ``L2Bottleneck`` (l2-normalized codes);
  * ``WassersteinBottleneck`` (:93-135), with the MMD regularizer against
    N(0, I) drawn from a generator or given;
  * ``RVQBottleneck``: residual VQ (DAC's);
  * ``FSQBottleneck``: finite scalar quantization (arXiv 2309.15505).

Channel-last: ``encode`` (B, L, C) -> ``(latent (B, L, C), info)``;
``decode`` is the identity (a code lookup for the discrete ones).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ezaudio_tpu_torch.codecs.dac import ResidualVectorQuantize


class TanhBottleneck(nn.Module):
    def encode(self, x, **kw):
        return torch.tanh(x), {}

    def decode(self, x):
        return x


def _l2(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


class L2Bottleneck(nn.Module):
    def encode(self, x, **kw):
        return _l2(x), {}

    def decode(self, x):
        return _l2(x)


def _mmd(latents, generator: Optional[torch.Generator] = None,
         noise: Optional[torch.Tensor] = None):
    """Maximum mean discrepancy against N(0, I) with an RBF kernel
    (bottleneck.py ``compute_mmd``); ``noise`` (N, C) or a draw."""
    z = latents.reshape(-1, latents.shape[-1])
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)

    def mean_kernel(a, b):
        d = (a[:, None] - b[None]).square().mean(2) / a.shape[-1]
        return torch.exp(-d).mean()

    return mean_kernel(z, z) + mean_kernel(noise, noise) - 2 * mean_kernel(z, noise)


class WassersteinBottleneck(nn.Module):
    def __init__(self, noise_augment_dim: int = 0):
        super().__init__()
        self.noise_augment_dim = noise_augment_dim

    def encode(self, x, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, return_info: bool = False):
        info = {}
        if return_info and (generator is not None or noise is not None):
            info["mmd"] = _mmd(x, generator, noise)
        return x, info

    def decode(self, x):
        return x


class RVQBottleneck(nn.Module):
    """Residual VQ over the encoder's output channels."""

    def __init__(self, input_dim: int, n_codebooks: int = 8, codebook_size: int = 1024,
                 codebook_dim: int = 8):
        super().__init__()
        self.rvq = ResidualVectorQuantize(input_dim, n_codebooks, codebook_size, codebook_dim)

    def encode(self, x, **kw):
        z_q, codes, _, commit, cb = self.rvq(x)
        return z_q, {"codes": codes, "commitment_loss": commit, "codebook_loss": cb}

    def decode(self, x):
        return x

    def decode_tokens(self, codes):
        return self.rvq.from_codes(codes)[0]


class FSQBottleneck(nn.Module):
    """Finite scalar quantization: each channel rounded to an ``l``-point
    grid, straight-through.  Even levels take the half-offset bound, so
    rounding gives exactly ``l`` integers; the shift is a tan() of the
    offset (google-research's fsq) — an arctanh() shift is NaN on a binary
    channel (l = 2) and pins it to one code."""

    def __init__(self, levels: Sequence[int] = (8, 5, 5, 5)):
        super().__init__()
        self.levels = tuple(levels)

    def _bound(self, z):
        lv = torch.tensor(self.levels, dtype=z.dtype, device=z.device)
        half_l = (lv - 1.0) * (1.0 - 1e-3) / 2.0
        offset = torch.tensor([0.5 if l % 2 == 0 else 0.0 for l in self.levels],
                              dtype=z.dtype, device=z.device)
        return torch.tanh(z + torch.tan(offset / half_l)) * half_l - offset

    def _basis(self, device):
        return torch.cumprod(torch.tensor((1,) + self.levels[:-1], device=device), 0)

    def encode(self, x, **kw):
        if x.shape[-1] != len(self.levels):
            raise ValueError(f"FSQ expects {len(self.levels)} channels, got {x.shape[-1]}")
        b = self._bound(x)
        q = b + (torch.round(b) - b).detach()
        lv = torch.tensor(self.levels, device=x.device)
        width = (lv // 2).to(x.dtype)
        digits = torch.round(q.detach()).long() + lv // 2
        tokens = (digits * self._basis(x.device)).sum(-1)
        return q / width, {"codes": tokens}

    def decode(self, x):
        return x

    def decode_tokens(self, tokens):
        lv = torch.tensor(self.levels, device=tokens.device)
        digits = (tokens[..., None] // self._basis(tokens.device)) % lv
        width = lv // 2
        return (digits - width).float() / width


def make_bottleneck(kind: str, **kw):
    """The reference's bottleneck config switch."""
    return {"tanh": TanhBottleneck, "l2": L2Bottleneck, "wasserstein": WassersteinBottleneck,
            "rvq": RVQBottleneck, "fsq": FSQBottleneck}[kind](**kw)
