"""DAC, the Descript Audio Codec (counterpart of ``ezaudio_tpu/codecs/dac.py``;
reference ``src/modules/dac/``).

  * ``model/dac.py``: a conv encoder (Snake1d ResidualUnits, channel-doubling
    strided blocks) and decoder (the mirror with transposed convs, tanh out);
  * ``nn/quantize.py``: ``VectorQuantize`` (factorized codes through 1x1
    projections, L2-normalized lookup, straight-through estimator) and
    ``ResidualVectorQuantize`` with per-sample quantizer dropout;
  * ``nn/layers.py``: the plain snake ``x + sin^2(alpha x) / (alpha + 1e-9)``.

Module and parameter names are descript's (``encoder.block.0``,
``quantizer.quantizers.0.in_proj``, ``decoder.model.1.block.1``, the snake's
``alpha`` of shape (1, C, 1), the codebook an ``nn.Embedding``), so a
descript state dict loads strictly: as it is with ``use_weight_norm=True``
(``weight_g``/``weight_v``), after ``convert/from_jax.py::fold_weight_norm``
without.  The units are plain torch, as the JAX package's are.

Inside, tensors are torch's (B, C, T); the public methods take and return
channel-last tensors as the JAX package's do: audio (B, T, 1), latents
(B, T', D), codes (B, N, T').  Training draws (the quantizer dropout's
per-sample codebook counts) come from a generator or are given
(``draws=``, ROADMAP F1).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.ops.convs import Conv1d, ConvTranspose1d


class Snake1d(nn.Module):
    """``x + (1 / (alpha + 1e-9)) sin^2(alpha x)`` on (B, C, T), alpha
    per channel, initialised to one."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x):
        a = self.alpha.to(x.dtype)
        return x + (1.0 / (a + 1e-9)) * torch.sin(a * x).square()


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int, use_weight_norm: bool = False):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.Sequential(
            Snake1d(dim),
            Conv1d(dim, dim, 7, dilation=dilation, padding=pad, weight_norm=use_weight_norm),
            Snake1d(dim),
            Conv1d(dim, dim, 1, weight_norm=use_weight_norm))

    def forward(self, x):
        y = self.block(x)
        crop = (x.shape[-1] - y.shape[-1]) // 2
        if crop > 0:
            x = x[..., crop:-crop]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, use_weight_norm: bool = False):
        super().__init__()
        half, wn = dim // 2, use_weight_norm
        self.block = nn.Sequential(
            *(ResidualUnit(half, d, wn) for d in (1, 3, 9)),
            Snake1d(half),
            Conv1d(half, dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2),
                   weight_norm=wn))

    def forward(self, x):
        return self.block(x)


class DACEncoder(nn.Module):
    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 8, 8),
                 d_latent: int = 64, use_weight_norm: bool = False):
        super().__init__()
        wn = use_weight_norm
        layers: List[nn.Module] = [Conv1d(1, d_model, 7, padding=3, weight_norm=wn)]
        for s in strides:
            d_model *= 2
            layers.append(EncoderBlock(d_model, s, wn))
        layers += [Snake1d(d_model), Conv1d(d_model, d_latent, 3, padding=1, weight_norm=wn)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        """(B, 1, T) -> (B, d_latent, T / prod(strides))."""
        return self.block(x)


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int,
                 use_weight_norm: bool = False):
        super().__init__()
        wn = use_weight_norm
        self.block = nn.Sequential(
            Snake1d(input_dim),
            ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                            padding=math.ceil(stride / 2), weight_norm=wn),
            *(ResidualUnit(output_dim, d, wn) for d in (1, 3, 9)))

    def forward(self, x):
        return self.block(x)


class DACDecoder(nn.Module):
    def __init__(self, input_channel: int, channels: int, rates: Sequence[int],
                 d_out: int = 1, use_weight_norm: bool = False):
        super().__init__()
        wn = use_weight_norm
        layers: List[nn.Module] = [Conv1d(input_channel, channels, 7, padding=3,
                                          weight_norm=wn)]
        out_dim = channels
        for i, s in enumerate(rates):
            in_dim, out_dim = channels // 2 ** i, channels // 2 ** (i + 1)
            layers.append(DecoderBlock(in_dim, out_dim, s, wn))
        layers += [Snake1d(out_dim), Conv1d(out_dim, d_out, 7, padding=3, weight_norm=wn),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """(B, input_channel, T') -> (B, d_out, T' * prod(rates))."""
        return self.model(x)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class VectorQuantize(nn.Module):
    """Factorized, L2-normalized VQ with straight-through gradients
    (nn/quantize.py:13-99), on (B, D, T)."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 use_weight_norm: bool = False):
        super().__init__()
        self.codebook_dim = codebook_dim
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, weight_norm=use_weight_norm)
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, weight_norm=use_weight_norm)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def similarity(self, z_e):
        """(B, D, T) projected latents -> (B*T, codebook_size) cosine
        similarities, in f32: the distance on normalized vectors is 2 - 2 cos,
        so its argmin is this matrix's argmax."""
        enc = _l2n(z_e.transpose(1, 2).reshape(-1, z_e.shape[1]).float())
        return enc @ _l2n(self.codebook.weight.float()).t()

    def decode_latents(self, z_e):
        """(B, D, T) -> (quantized (B, D, T), indices (B, T))."""
        B, _, T = z_e.shape
        indices = self.similarity(z_e).argmax(-1).reshape(B, T)
        return self.decode_code(indices).to(z_e.dtype), indices

    def decode_code(self, indices):
        """(B, T) indices -> (B, D, T) codebook vectors."""
        return F.embedding(indices, self.codebook.weight).transpose(1, 2)

    def forward(self, z):
        z_e = self.in_proj(z)
        z_q, indices = self.decode_latents(z_e)
        commitment = (z_e - z_q.detach()).square().mean((1, 2))
        codebook = (z_q - z_e.detach()).square().mean((1, 2))
        z_q = z_e + (z_q - z_e).detach()  # straight-through
        return self.out_proj(z_q), commitment, codebook, indices, z_e


class ResidualVectorQuantize(nn.Module):
    """SoundStream RVQ with quantizer dropout (nn/quantize.py:102-255)."""

    def __init__(self, input_dim: int = 512, n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: Union[int, Sequence[int]] = 8, quantizer_dropout: float = 0.0,
                 use_weight_norm: bool = False):
        super().__init__()
        dims = ([codebook_dim] * n_codebooks if isinstance(codebook_dim, int)
                else list(codebook_dim))
        self.n_codebooks = n_codebooks
        self.dims = dims
        self.quantizer_dropout = quantizer_dropout
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, d, use_weight_norm) for d in dims)

    def draw(self, generator: Optional[torch.Generator], batch: int, device) -> torch.Tensor:
        """Quantizer dropout's draw: each sample's number of active
        codebooks, uniform in [1, n_codebooks] (only the first
        ``int(batch * quantizer_dropout)`` are used)."""
        return torch.randint(1, self.n_codebooks + 1, (batch,), generator=generator,
                             device=device)

    def forward(self, z, n_quantizers: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[torch.Tensor] = None):
        """z (B, T, D) -> (z_q (B, T, D), codes (B, N, T), latents
        (B, T, sum D), commitment_loss, codebook_loss).  Training runs and
        supervises every codebook whatever ``n_quantizers`` says (reference
        quantize.py:165-177), less the dropped ones."""
        B = z.shape[0]
        residual = z.transpose(1, 2)
        z_q = torch.zeros_like(residual)
        commitment = codebook = 0.0
        codes, latents = [], []
        if train:
            nq = torch.full((B,), self.n_codebooks + 1.0, device=z.device)
            if self.quantizer_dropout > 0:
                drop = self.draw(generator, B, z.device) if draws is None else draws
                n_dropout = int(B * self.quantizer_dropout)
                nq[:n_dropout] = drop[:n_dropout].to(z.device, nq.dtype)
        else:
            nq = torch.full((B,), float(n_quantizers or self.n_codebooks), device=z.device)
        for i, quantizer in enumerate(self.quantizers):
            if not train and n_quantizers is not None and i >= n_quantizers:
                break
            z_q_i, commit_i, cb_i, idx_i, z_e_i = quantizer(residual)
            mask = (i < nq).to(z.dtype)
            z_q = z_q + z_q_i * mask[:, None, None]
            residual = residual - z_q_i
            commitment = commitment + (commit_i * mask).mean()
            codebook = codebook + (cb_i * mask).mean()
            codes.append(idx_i)
            latents.append(z_e_i)
        return (z_q.transpose(1, 2), torch.stack(codes, 1),
                torch.cat(latents, 1).transpose(1, 2), commitment, codebook)

    def from_codes(self, codes):
        """(B, N, T) indices -> (z_q (B, T, D), z_p (B, T, sum D), codes)."""
        z_q, z_p = 0.0, []
        for i in range(codes.shape[1]):
            z_p_i = self.quantizers[i].decode_code(codes[:, i])
            z_p.append(z_p_i)
            z_q = z_q + self.quantizers[i].out_proj(z_p_i)
        return z_q.transpose(1, 2), torch.cat(z_p, 1).transpose(1, 2), codes

    def from_latents(self, latents):
        """(B, T, width) projected latents -> re-quantized ``(z_q, z_p,
        codes)``: only the codebooks the width fully covers (reference
        quantize.py ``from_latents``)."""
        bounds = [0]
        for d in self.dims:
            bounds.append(bounds[-1] + d)
        n = max(i for i, b in enumerate(bounds) if b <= latents.shape[-1])
        x = latents.transpose(1, 2)
        z_q, z_p, codes = 0.0, [], []
        for i in range(n):
            z_p_i, codes_i = self.quantizers[i].decode_latents(x[:, bounds[i]:bounds[i + 1]])
            z_p.append(z_p_i)
            codes.append(codes_i)
            z_q = z_q + self.quantizers[i].out_proj(z_p_i)
        return z_q.transpose(1, 2), torch.cat(z_p, 1).transpose(1, 2), torch.stack(codes, 1)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class DAC(nn.Module):
    """The JAX package's ``DAC()`` defaults are descript's 44.1 kHz model:
    encoder_dim 64, rates 2/4/8/8, latent 1024, decoder_dim 1536, 9
    codebooks x 1024 x 8."""

    def __init__(self, encoder_dim: int = 64, encoder_rates: Sequence[int] = (2, 4, 8, 8),
                 latent_dim: Optional[int] = None, decoder_dim: int = 1536,
                 decoder_rates: Sequence[int] = (8, 8, 4, 2), n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: Union[int, Sequence[int]] = 8,
                 quantizer_dropout: float = 0.0, sample_rate: int = 44100,
                 use_weight_norm: bool = False):
        super().__init__()
        latent_dim = latent_dim or encoder_dim * 2 ** len(encoder_rates)
        self.latent_dim = latent_dim
        self.n_codebooks = n_codebooks
        self.sample_rate = sample_rate
        self.use_weight_norm = use_weight_norm
        self.hop_length = math.prod(encoder_rates)
        self.encoder = DACEncoder(encoder_dim, encoder_rates, latent_dim, use_weight_norm)
        self.quantizer = ResidualVectorQuantize(latent_dim, n_codebooks, codebook_size,
                                                codebook_dim, quantizer_dropout,
                                                use_weight_norm)
        self.decoder = DACDecoder(latent_dim, decoder_dim, decoder_rates,
                                  use_weight_norm=use_weight_norm)

    def preprocess(self, audio):
        """Right-pad (B, T, 1) to a multiple of the hop."""
        pad = math.ceil(audio.shape[1] / self.hop_length) * self.hop_length - audio.shape[1]
        return F.pad(audio, (0, 0, 0, pad))

    def encode_latent(self, audio):
        """The encoder alone: (B, T, 1) -> (B, T / hop, latent_dim)."""
        return self.encoder(audio.transpose(1, 2)).transpose(1, 2)

    def encode(self, audio, n_quantizers: Optional[int] = None, train: bool = False,
               generator: Optional[torch.Generator] = None, draws=None):
        """(B, T, 1) -> the quantizer's ``(z_q, codes, latents, commitment,
        codebook)``."""
        return self.quantizer(self.encode_latent(audio), n_quantizers, train, generator, draws)

    def decode(self, z):
        """(B, T', latent_dim) -> (B, T' * hop, 1)."""
        return self.decoder(z.transpose(1, 2)).transpose(1, 2)

    def forward(self, audio, n_quantizers: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, draws=None) -> dict:
        """audio (B, T, 1) -> the reconstruction, its codes and the VQ losses."""
        length = audio.shape[1]
        z, codes, latents, commitment, codebook = self.encode(
            self.preprocess(audio), n_quantizers, train, generator, draws)
        return {"audio": self.decode(z)[:, :length], "z": z, "codes": codes,
                "latents": latents, "vq/commitment_loss": commitment,
                "vq/codebook_loss": codebook}
