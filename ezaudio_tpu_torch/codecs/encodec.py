"""EnCodec: SEANet encoder and decoder with a plain residual VQ (counterpart
of ``ezaudio_tpu/codecs/encodec.py``, the facade's ``model_type='encodec'``
slot; Défossez et al., arXiv 2210.13438).

  * SEANet encoder: conv stem, per ratio (reversed) a residual block (ELU
    convs) and a strided conv doubling the channels, a 2-layer LSTM with a
    skip, ELU, conv to ``dimension``; ratios 8/5/4/2: a 320 hop, 75 Hz at
    24 kHz;
  * the decoder mirrors it with transposed convs, each trimmed to exactly
    ratio x its input (``ceil(r/2)`` on the left, upstream encodec's
    unpad);
  * the quantizer: full-dimension codebooks, nearest neighbour by L2,
    straight-through, commitment and codebook losses;
  * live weight norm on every conv (``weight_g``/``weight_v``).

The LSTM is ``torch.nn.LSTM`` (gates i, f, g, o; ``bias_ih`` 0 where the
JAX package's ``OptimizedLSTMCell`` has its bias on the hidden side only;
``convert/from_jax.py::encodec_state_dict_from_jax``).  Names follow
upstream encodec's ``model`` Sequentials (``encoder.model.0.weight_v``,
``encoder.model.13.lstm.weight_ih_l0``, ``decoder.model.3.convtr``), the
codebooks are ``quantizer.layers.{i}.codebook``.  Inside, tensors are
(B, C, T); the public methods take and return channel-last tensors as the
JAX package's do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ezaudio_tpu_torch.ops.convs import Conv1d, ConvTranspose1d


class SEANetResnetBlock(nn.Module):
    def __init__(self, dim: int, compress: int = 2, use_weight_norm: bool = True):
        super().__init__()
        hidden = dim // compress
        self.block = nn.Sequential(
            nn.ELU(), Conv1d(dim, hidden, 3, padding=1, weight_norm=use_weight_norm),
            nn.ELU(), Conv1d(hidden, dim, 1, weight_norm=use_weight_norm))

    def forward(self, x):
        return x + self.block(x)


class LSTMStack(nn.Module):
    """A ``num_layers`` LSTM over time with a skip (SEANet's ``lstm``), on
    (B, C, T)."""

    def __init__(self, features: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(features, features, num_layers, batch_first=True)

    def forward(self, x):
        h = x.transpose(1, 2)
        return x + self.lstm(h)[0].transpose(1, 2)


class SConvTranspose1d(nn.Module):
    """A transposed conv of kernel 2r and stride r, trimmed to r x its input:
    ``ceil(r/2)`` samples off the left, the rest off the right."""

    def __init__(self, in_channels: int, out_channels: int, ratio: int,
                 use_weight_norm: bool = True):
        super().__init__()
        self.ratio = ratio
        self.convtr = ConvTranspose1d(in_channels, out_channels, 2 * ratio, stride=ratio,
                                      weight_norm=use_weight_norm)

    def forward(self, x):
        left = self.ratio - self.ratio // 2
        return self.convtr(x)[..., left: left + self.ratio * x.shape[-1]]


class SEANetEncoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 use_lstm: bool = True, use_weight_norm: bool = True):
        super().__init__()
        wn, mult = use_weight_norm, 1
        layers: List[nn.Module] = [Conv1d(channels, n_filters, 7, padding=3, weight_norm=wn)]
        for ratio in reversed(ratios):
            layers += [SEANetResnetBlock(mult * n_filters, use_weight_norm=wn)
                       for _ in range(n_residual_layers)]
            layers += [nn.ELU(), Conv1d(mult * n_filters, mult * n_filters * 2, 2 * ratio,
                                        stride=ratio, padding=math.ceil(ratio / 2),
                                        weight_norm=wn)]
            mult *= 2
        if use_lstm:
            layers.append(LSTMStack(mult * n_filters))
        layers += [nn.ELU(), Conv1d(mult * n_filters, dimension, 7, padding=3, weight_norm=wn)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """(B, T, channels) -> (B, T / prod(ratios), dimension)."""
        return self.model(x.transpose(1, 2)).transpose(1, 2)


class SEANetDecoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 use_lstm: bool = True, use_weight_norm: bool = True):
        super().__init__()
        wn, mult = use_weight_norm, 2 ** len(ratios)
        layers: List[nn.Module] = [Conv1d(dimension, mult * n_filters, 7, padding=3,
                                          weight_norm=wn)]
        if use_lstm:
            layers.append(LSTMStack(mult * n_filters))
        for ratio in ratios:
            layers += [nn.ELU(), SConvTranspose1d(mult * n_filters, mult * n_filters // 2,
                                                  ratio, wn)]
            layers += [SEANetResnetBlock(mult * n_filters // 2, use_weight_norm=wn)
                       for _ in range(n_residual_layers)]
            mult //= 2
        layers += [nn.ELU(), Conv1d(n_filters, channels, 7, padding=3, weight_norm=wn)]
        self.model = nn.Sequential(*layers)

    def forward(self, z):
        """(B, L, dimension) -> (B, L * prod(ratios), channels)."""
        return self.model(z.transpose(1, 2)).transpose(1, 2)


class EncodecVQ(nn.Module):
    """A plain (not factorized) codebook at the full latent dimension, on
    channel-last (B, T, D)."""

    def __init__(self, dim: int, codebook_size: int = 1024):
        super().__init__()
        self.codebook = nn.Parameter(torch.randn(codebook_size, dim))

    def distances(self, z):
        """(B, T, D) -> (B*T, codebook_size) squared L2 distances, in f32."""
        flat = z.reshape(-1, z.shape[-1]).float()
        cb = self.codebook.float()
        return (flat.square().sum(1, keepdim=True) - 2 * flat @ cb.t()
                + cb.square().sum(1)[None])

    def forward(self, z):
        idx = self.distances(z).argmin(1).reshape(z.shape[:2])
        z_q = self.decode(idx).to(z.dtype)
        commit = (z - z_q.detach()).square().mean()
        # the VQ-VAE form: the selected codes pulled toward the frozen
        # encoder output (upstream's EMA update does not fit a gradient step)
        codebook = (z.detach() - z_q).square().mean()
        return z + (z_q - z).detach(), idx, commit, codebook

    def decode(self, idx):
        return self.codebook[idx]


class EncodecRVQ(nn.Module):
    def __init__(self, dim: int, n_q: int = 8, codebook_size: int = 1024):
        super().__init__()
        self.n_q = n_q
        self.layers = nn.ModuleList(EncodecVQ(dim, codebook_size) for _ in range(n_q))

    def _check_n_q(self, n_q: Optional[int]) -> int:
        n = self.n_q if n_q is None else int(n_q)
        if not 1 <= n <= self.n_q:
            raise ValueError(f"n_q must be in [1, {self.n_q}], got {n_q}")
        return n

    def encode(self, z, n_q: Optional[int] = None):
        """(B, T, D) -> codes (B, N, T)."""
        residual, codes = z, []
        for i in range(self._check_n_q(n_q)):
            z_q, idx, _, _ = self.layers[i](residual)
            residual = residual - z_q
            codes.append(idx)
        return torch.stack(codes, 1)

    def decode(self, codes):
        """(B, N, T) -> (B, T, D)."""
        return sum(self.layers[i].decode(codes[:, i]) for i in range(codes.shape[1]))

    def forward(self, z, n_q: Optional[int] = None):
        residual, z_q = z, torch.zeros_like(z)
        commit = codebook = 0.0
        codes = []
        for i in range(self._check_n_q(n_q)):
            q_i, idx, c_i, cb_i = self.layers[i](residual)
            residual = residual - q_i
            z_q = z_q + q_i
            commit = commit + c_i
            codebook = codebook + cb_i
            codes.append(idx)
        return z_q, torch.stack(codes, 1), commit, codebook


class Encodec(nn.Module):
    """The whole EnCodec behind the facade's ``'encodec'`` slot."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_q: int = 8, codebook_size: int = 1024,
                 sample_rate: int = 24000, use_lstm: bool = True):
        super().__init__()
        self.dimension = dimension
        self.sample_rate = sample_rate
        self.hop_length = math.prod(ratios)
        self.encoder = SEANetEncoder(channels, dimension, n_filters, ratios, use_lstm=use_lstm)
        self.decoder = SEANetDecoder(channels, dimension, n_filters, ratios, use_lstm=use_lstm)
        self.quantizer = EncodecRVQ(dimension, n_q, codebook_size)

    def encode(self, audio, n_q: Optional[int] = None):
        """(B, T, 1) -> codes (B, N, T / hop)."""
        return self.quantizer.encode(self.encoder(audio), n_q)

    def decode(self, codes):
        return self.decoder(self.quantizer.decode(codes))

    def forward(self, audio, n_q: Optional[int] = None) -> dict:
        z_q, codes, commit, codebook = self.quantizer(self.encoder(audio), n_q)
        return {"audio": self.decoder(z_q)[:, :audio.shape[1]], "codes": codes, "z": z_q,
                "commitment_loss": commit,
                # the codec trainer's VQ branch reads the namespaced keys
                "vq/commitment_loss": commit, "vq/codebook_loss": codebook}
