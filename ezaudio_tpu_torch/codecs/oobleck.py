"""Oobleck VAE (counterpart of ``ezaudio_tpu/codecs/oobleck.py``).

Reference ``src/modules/stable_vae/models/autoencoders.py``:

  * encoder: WNConv stem (k7) -> per-stride EncoderBlock [3 dilated
    ResidualUnits (1, 3, 9) at the block's input width + snake + strided
    Conv(k=2s, p=ceil(s/2))] -> snake -> Conv(k3) to 2*latent (mean || scale);
  * decoder: WNConv stem (k7) -> per-stride DecoderBlock [snake +
    ConvTranspose(k=2s, p=ceil(s/2)) + 3 dilated ResidualUnits (1, 3, 9)]
    -> snake -> Conv(k7, no bias) -> optional tanh;

SnakeBeta with log-scale per-channel alpha/beta (f32 in a bf16 model, as
the JAX package exps its f32 parameters and casts).  Modules keep the
reference's ``layers`` Sequential indices, so a reference state dict loads
after its weight norm is folded (``convert/from_jax.py::fold_weight_norm``).
Inside, tensors are torch's (B, C, T); encoder and decoder take and return
channel-last (B, L, C) like the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.ops.activations import snake_beta_vae
from ezaudio_tpu_torch.ops.convs import Conv1d, ConvTranspose1d


class SnakeBeta(nn.Module):
    """x + 1/b sin^2(a x) on (B, C, T), with a = exp(alpha), b = exp(beta)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def cast_(self, dtype):
        """alpha and beta stay f32: exp'd in f32, then cast to x's dtype
        (``utils.cast_params_``)."""

    def forward(self, x):
        a = self.alpha.exp().to(x.dtype)[None, :, None]
        b = self.beta.exp().to(x.dtype)[None, :, None]
        return snake_beta_vae(x, a, b)


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.layers = nn.Sequential(
            SnakeBeta(channels),
            Conv1d(channels, channels, 7, dilation=dilation, padding=3 * dilation),
            SnakeBeta(channels),
            Conv1d(channels, channels, 1))

    def forward(self, x):
        return x + self.layers(x)


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.layers = nn.Sequential(
            *(ResidualUnit(in_channels, d) for d in (1, 3, 9)),
            SnakeBeta(in_channels),
            Conv1d(in_channels, out_channels, 2 * stride, stride=stride,
                   padding=math.ceil(stride / 2)))

    def forward(self, x):
        return self.layers(x)


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.layers = nn.Sequential(
            SnakeBeta(in_channels),
            ConvTranspose1d(in_channels, out_channels, 2 * stride, stride=stride,
                            padding=math.ceil(stride / 2)),
            *(ResidualUnit(out_channels, d) for d in (1, 3, 9)))

    def forward(self, x):
        return self.layers(x)


class OobleckEncoder(nn.Module):
    def __init__(self, in_channels: int = 1, channels: int = 128, latent_dim: int = 256,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 6, 10)):
        super().__init__()
        mults = (1,) + tuple(c_mults)
        layers = [Conv1d(in_channels, mults[0] * channels, 7, padding=3)]
        for i, s in enumerate(strides):
            layers.append(EncoderBlock(mults[i] * channels, mults[i + 1] * channels, s))
        layers += [SnakeBeta(mults[-1] * channels),
                   Conv1d(mults[-1] * channels, latent_dim, 3, padding=1)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        """(B, T, in_channels) -> (B, T/prod(strides), latent_dim)."""
        return self.layers(x.transpose(1, 2)).transpose(1, 2)


class OobleckDecoder(nn.Module):
    def __init__(self, out_channels: int = 1, channels: int = 128, latent_dim: int = 128,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 6, 10),
                 final_tanh: bool = False):
        super().__init__()
        mults = (1,) + tuple(c_mults)
        n = len(strides)
        layers = [Conv1d(latent_dim, mults[-1] * channels, 7, padding=3)]
        for i in range(n, 0, -1):
            layers.append(DecoderBlock(mults[i] * channels, mults[i - 1] * channels,
                                       strides[i - 1]))
        layers += [SnakeBeta(mults[0] * channels),
                   Conv1d(mults[0] * channels, out_channels, 7, padding=3, bias=False)]
        if final_tanh:
            layers.append(nn.Tanh())
        self.layers = nn.Sequential(*layers)

    def forward(self, z):
        """(B, L, latent_dim) -> (B, L*prod(strides), out_channels)."""
        return self.layers(z.transpose(1, 2)).transpose(1, 2)


class AudioVAE(nn.Module):
    """The reference ``AudioAutoencoder`` for the Oobleck/vae configuration:
    encoder (to mean || scale), VAE bottleneck, decoder."""

    def __init__(self, io_channels: int = 1, channels: int = 128, latent_dim: int = 128,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 6, 10),
                 final_tanh: bool = False):
        super().__init__()
        self.latent_dim = latent_dim
        self.downsampling_ratio = math.prod(strides)
        self.encoder = OobleckEncoder(io_channels, channels, 2 * latent_dim, c_mults, strides)
        self.decoder = OobleckDecoder(io_channels, channels, latent_dim, c_mults,
                                      strides, final_tanh)

    def encode(self, audio, sample: bool = True,
               generator: Optional[torch.Generator] = None):
        """audio (B, T, 1) -> latent (B, T/prod(strides), latent_dim)."""
        return vae_sample(self.encoder(audio), sample, generator)

    def decode(self, z):
        return self.decoder(z)


def vae_sample(mean_scale, sample: bool = True,
               generator: Optional[torch.Generator] = None):
    """VAEBottleneck.encode (bottleneck.py:54-90): split mean||scale on the
    channel axis, stdev = softplus(scale) + 1e-4, reparameterize."""
    mean, scale = mean_scale.chunk(2, dim=-1)
    if not sample:
        return mean
    stdev = F.softplus(scale) + 1e-4
    return mean + stdev * utils.randn(mean.shape, generator, mean.device, mean.dtype)


def vae_from_config(cfg: dict) -> AudioVAE:
    """Build from a reference-format vae config.json dict (the encoder
    mirrors the decoder's geometry)."""
    m = cfg["model"]
    dec = m["decoder"]["config"]
    if m["bottleneck"]["type"] != "vae":
        raise NotImplementedError(f"bottleneck {m['bottleneck']['type']!r}")
    return AudioVAE(io_channels=m.get("io_channels", 1), channels=dec["channels"],
                    latent_dim=m["latent_dim"], c_mults=tuple(dec["c_mults"]),
                    strides=tuple(dec["strides"]),
                    final_tanh=dec.get("final_tanh", False))
