"""The codec's GAN discriminators and losses (counterpart of
``ezaudio_tpu/codecs/discriminator.py``; reference
``src/modules/dac/model/discriminator.py`` and ``dac/nn/loss.py:330-368``):

  * MPD, multi-period: 2D convs over the waveform folded by its period;
  * MSD, multi-scale: grouped 1D convs (a rate > 1 takes every r-th sample,
    as the JAX package does);
  * MRD, multi-resolution: 2D convs over bands of the complex STFT (real and
    imaginary as two channels; ``audio/stft.py``);
  * ``Discriminator``: DC removed and peak-normalized to 0.8, then every
    sub-discriminator;
  * least-squares adversarial losses and L1 feature matching over every map
    but the last.

Every conv is weight-normed (``weight_g``/``weight_v``) and followed by a
LeakyReLU(0.1) but the last; names are descript's (``discriminators.0
.convs.0.0.weight_v``, ``conv_post``, MRD's ``band_convs``).  Feature maps
are torch's (B, C, H, W): for MPD H is time / period and W the period, for
MRD H is the frame and W the frequency.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ezaudio_tpu_torch.audio.stft import reflect_pad, stft
from ezaudio_tpu_torch.ops.convs import Conv1d, Conv2d

BANDS = [(0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0)]


def _act(conv: nn.Module) -> nn.Sequential:
    return nn.Sequential(conv, nn.LeakyReLU(0.1))


def _run(convs, post, h) -> List[torch.Tensor]:
    fmap = []
    for layer in convs:
        h = layer(h)
        fmap.append(h)
    fmap.append(post(h))
    return fmap


class MPD(nn.Module):
    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024)]
        self.convs = nn.ModuleList(
            [_act(Conv2d(ci, co, (5, 1), (3, 1), padding=(2, 0), weight_norm=True))
             for ci, co in chans]
            + [_act(Conv2d(1024, 1024, (5, 1), (1, 1), padding=(2, 0), weight_norm=True))])
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), padding=(1, 0), weight_norm=True)

    def forward(self, x):
        """x (B, T, 1) -> feature maps."""
        x = x.transpose(1, 2)
        pad = (self.period - x.shape[-1] % self.period) % self.period
        if pad:
            x = reflect_pad(x, 0, pad)
        h = x.reshape(x.shape[0], 1, x.shape[-1] // self.period, self.period)
        return _run(self.convs, self.conv_post, h)


class MSD(nn.Module):
    SPECS = [(1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20), (64, 256, 41, 4, 16, 20),
             (256, 1024, 41, 4, 64, 20), (1024, 1024, 41, 4, 256, 20), (1024, 1024, 5, 1, 1, 2)]

    def __init__(self, rate: int = 1, sample_rate: int = 44100):
        super().__init__()
        self.rate = rate
        self.convs = nn.ModuleList(
            _act(Conv1d(ci, co, k, stride=s, groups=g, padding=p, weight_norm=True))
            for ci, co, k, s, g, p in self.SPECS)
        self.conv_post = Conv1d(1024, 1, 3, padding=1, weight_norm=True)

    def forward(self, x):
        """x (B, T, 1), already taken at every ``rate``-th sample."""
        return _run(self.convs, self.conv_post, x.transpose(1, 2))


class MRD(nn.Module):
    def __init__(self, window_length: int, hop_factor: float = 0.25, sample_rate: int = 44100,
                 bands: Sequence[Tuple[float, float]] = tuple(BANDS)):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        n_fft = window_length // 2 + 1
        self.bands = [(int(lo * n_fft), int(hi * n_fft)) for lo, hi in bands]
        ch = 32

        def band():
            specs = ([(2, ch, (3, 9), (1, 1), (1, 4))] + [(ch, ch, (3, 9), (1, 2), (1, 4))] * 3
                     + [(ch, ch, (3, 3), (1, 1), (1, 1))])
            return nn.ModuleList(_act(Conv2d(ci, co, k, s, padding=p, weight_norm=True))
                                 for ci, co, k, s, p in specs)

        self.band_convs = nn.ModuleList(band() for _ in self.bands)
        self.conv_post = Conv2d(ch, 1, (3, 3), (1, 1), padding=(1, 1), weight_norm=True)

    def forward(self, x):
        """x (B, T, 1)."""
        spec = stft(x[..., 0], self.window_length, self.hop)        # (B, F, T')
        h_all = torch.view_as_real(spec).permute(0, 3, 2, 1)        # (B, 2, T', F)
        fmap, outs = [], []
        for (lo, hi), convs in zip(self.bands, self.band_convs):
            h = h_all[..., lo:hi]
            for layer in convs:
                h = layer(h)
                fmap.append(h)
            outs.append(h)
        fmap.append(self.conv_post(torch.cat(outs, dim=-1)))
        return fmap


class Discriminator(nn.Module):
    def __init__(self, rates: Sequence[int] = (), periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512), sample_rate: int = 44100,
                 bands: Sequence[Tuple[float, float]] = tuple(BANDS)):
        super().__init__()
        self.rates = tuple(rates)
        self.discriminators = nn.ModuleList(
            [MPD(p) for p in periods] + [MSD(r, sample_rate) for r in rates]
            + [MRD(f, sample_rate=sample_rate, bands=bands) for f in fft_sizes])

    def forward(self, x):
        """x (B, T, 1) -> one list of feature maps per sub-discriminator."""
        x = x - x.mean(1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(1, keepdim=True) + 1e-9)
        outs = []
        for d in self.discriminators:
            # a rate > 1 takes every r-th sample (no resampler)
            outs.append(d(x[:, ::d.rate] if isinstance(d, MSD) and d.rate > 1 else x))
        return outs


def discriminator_loss(d_fake, d_real):
    loss = 0.0
    for f, r in zip(d_fake, d_real):
        loss = loss + f[-1].square().mean()
        loss = loss + (1.0 - r[-1]).square().mean()
    return loss


def generator_loss(d_fake, d_real):
    """(adversarial, feature matching); the real maps carry no gradient."""
    loss_g = 0.0
    for f in d_fake:
        loss_g = loss_g + (1.0 - f[-1]).square().mean()
    loss_feat = 0.0
    for f, r in zip(d_fake, d_real):
        for j in range(len(f) - 1):
            loss_feat = loss_feat + (f[j] - r[j].detach()).abs().mean()
    return loss_g, loss_feat
