"""Adversarial training of the codecs, the VAE and DAC (counterpart of
``ezaudio_tpu/training/codec_trainer.py``; the recipe of the reference's
``ckpts/vae/config.json`` ``training:`` block and ``dac/nn/loss.py``).

One step, as the JAX package's, alternates:

  * the generator against the current discriminator: the multi-scale STFT
    loss (windows 2048 ... 32), ``lambda_kl`` x KL (VAE) or the commitment
    and codebook losses (DAC), ``lambda_adv`` x the least-squares
    adversarial loss and ``lambda_fm`` x feature matching; its gradients
    are those of the codec's parameters alone, and the codec is updated;
  * the discriminator on the reconstruction, detached, and the real clip:
    the least-squares loss, then its update.

Both optimizers are optax's default ``adamw`` (b1 0.8, b2 0.99, eps 1e-8,
weight decay on every parameter) under :func:`inverse_lr`, through
``training/optim.py`` (no clip).  The VAE runs every ResidualUnit on
kernel 2 (``AudioVAE.forward``: the kernel forward, the plain twin's vjp
backward through ``FusedResidualUnit``), with live weight norm when built
so.  The draws of step ``n`` (the VAE's posterior noise, DAC's quantizer
dropout) come from a generator seeded from ``(seed, n)``, or are given
(``draws=``: ``noise`` (B, L, latent) or ``dropout`` (B,) ints, ROADMAP F1).
Quantization is off inside the step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ezaudio_tpu_torch.audio.metrics import multiscale_stft_loss
from ezaudio_tpu_torch.codecs.discriminator import (Discriminator, discriminator_loss,
                                                    generator_loss)
from ezaudio_tpu_torch.ops.quant import quant_context
from ezaudio_tpu_torch.training.optim import Optimizer, TorchAdamW, named_grads
from ezaudio_tpu_torch.training.trainer import step_seed
from ezaudio_tpu_torch.utils import deterministic_cudnn


def inverse_lr(base_lr: float, inv_gamma: float, power: float,
               warmup: float = 0.0) -> Callable[[int], float]:
    """InverseLR (the vae config's ``training.scheduler``) in f32, as the
    JAX package evaluates it: ``base_lr (1 + step / inv_gamma)^-power``,
    times ``1 - warmup^(step + 1)``."""
    f = np.float32

    def fn(step: int) -> float:
        s = f(step)
        lr = f(base_lr) * (f(1.0) + s / f(inv_gamma)) ** f(-power)
        if warmup > 0:
            lr = lr * (f(1.0) - f(warmup) ** (s + f(1.0)))
        return float(lr)

    return fn


def _adamw(module: nn.Module, lr: Callable[[int], float], weight_decay: float) -> Optimizer:
    named = dict(module.named_parameters())
    rule = TorchAdamW(named, 0.8, 0.99, 1e-8, weight_decay, {n: True for n in named})
    return Optimizer(named.items(), lr, rule, None, 1)


class CodecTrainStep:
    """``step(audio, seed, draws=None, return_grads=False) -> metrics``:
    one generator and one discriminator update under cuDNN's deterministic
    algorithms (``utils.deterministic_cudnn``: a restart retakes its steps
    exactly).  ``audio`` (B, T, 1)."""

    def __init__(self, codec: nn.Module, disc: Discriminator, codec_kind: str = "vae",
                 sample_rate: int = 24000, lambda_mrstft: float = 1.0,
                 lambda_kl: float = 1e-4, lambda_adv: float = 0.1, lambda_fm: float = 5.0,
                 lambda_commit: float = 0.25, lambda_codebook: float = 1.0,
                 gen_lr: float = 1.5e-4, disc_lr: float = 3e-4, weight_decay: float = 1e-3,
                 inv_gamma: float = 200000.0, power: float = 0.5, warmup: float = 0.999,
                 stft_windows: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64, 32)):
        if codec_kind not in ("vae", "dac"):
            raise ValueError(f"codec_kind {codec_kind!r}: 'vae' or 'dac'")
        self.codec = codec.train().requires_grad_(True)
        self.disc = disc.train().requires_grad_(True)
        self.kind = codec_kind
        self.sample_rate = sample_rate
        self.lambdas = dict(mrstft=lambda_mrstft, kl=lambda_kl, adv=lambda_adv, fm=lambda_fm,
                            commit=lambda_commit, codebook=lambda_codebook)
        self.stft_windows = tuple(stft_windows)
        self.gen_opt = _adamw(self.codec, inverse_lr(gen_lr, inv_gamma, power, warmup),
                              weight_decay)
        self.disc_opt = _adamw(self.disc, inverse_lr(disc_lr, inv_gamma, power, warmup),
                               weight_decay)
        self.step = 0

    def reconstruct(self, audio, generator: Optional[torch.Generator], draws: dict):
        """``(recon, the codec's own loss terms, their metrics)``."""
        lam = self.lambdas
        if self.kind == "vae":
            recon, kl = self.codec(audio, generator=generator, draws=draws.get("noise"))
            return recon, lam["kl"] * kl, {"kl": kl}
        out = self.codec(audio, train=True, generator=generator, draws=draws.get("dropout"))
        commit, cb = out["vq/commitment_loss"], out["vq/codebook_loss"]
        return (out["audio"], lam["commit"] * commit + lam["codebook"] * cb,
                {"commitment": commit, "codebook": cb})

    def __call__(self, audio, seed: int, draws: Optional[dict] = None,
                 return_grads: bool = False) -> Dict[str, torch.Tensor]:
        gen = None
        if draws is None:
            gen = torch.Generator(device=audio.device).manual_seed(step_seed(seed, self.step))
        lam = self.lambdas
        with quant_context("off"), deterministic_cudnn():
            recon, extra, aux = self.reconstruct(audio, gen, draws or {})
            n = min(recon.shape[1], audio.shape[1])
            recon, ref = recon[:, :n], audio[:, :n]
            mrstft = multiscale_stft_loss(recon[..., 0], ref[..., 0], self.stft_windows)
            adv, fm = generator_loss(self.disc(recon), self.disc(ref))
            g_loss = lam["mrstft"] * mrstft + extra + lam["adv"] * adv + lam["fm"] * fm
            g_grads = named_grads(self.gen_opt.params.items(), g_loss)
            self.gen_opt.update(g_grads)
            d_loss = discriminator_loss(self.disc(recon.detach()), self.disc(ref))
            d_grads = named_grads(self.disc_opt.params.items(), d_loss)
            self.disc_opt.update(d_grads)
        self.step += 1
        metrics = {"gen/loss": g_loss, "gen/mrstft": mrstft, "gen/adv": adv, "gen/fm": fm,
                   **{f"gen/{k}": v for k, v in aux.items()}, "disc/loss": d_loss}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if return_grads:
            metrics["gen_grads"], metrics["disc_grads"] = g_grads, d_grads
        return metrics


@torch.no_grad()
def init_codec_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for a codec or discriminator: each conv's
    weight (``weight_v`` with weight norm) and bias U(+-1/sqrt(fan_in)),
    torch's default, ``weight_g`` the norm of ``v`` times 1 + N(0, 0.1);
    the VAE's log-scale snakes N(0, 0.1), DAC's snakes |1 + N(0, 0.1)|;
    codebooks N(0, 1); LSTMs U(+-1/sqrt(hidden)).  Nothing is left zero
    (ROADMAP F6)."""
    from ezaudio_tpu_torch.codecs.dac import Snake1d
    from ezaudio_tpu_torch.codecs.oobleck import SnakeBeta

    for m in module.modules():
        params = m._parameters
        if isinstance(m, nn.modules.conv._ConvNd):
            v = params.get("weight_v", params.get("weight"))
            bound = 1.0 / math.sqrt(v[0].numel())
            v.uniform_(-bound, bound, generator=generator)
            if params.get("bias") is not None:
                params["bias"].uniform_(-bound, bound, generator=generator)
            if "weight_g" in params:
                g = params["weight_g"]
                g.copy_(v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt())
                g.mul_(1.0 + 0.1 * torch.randn(g.shape, generator=generator, device=g.device))
        elif isinstance(m, SnakeBeta):
            for p in (m.alpha, m.beta):
                p.normal_(0.0, 0.1, generator=generator)
        elif isinstance(m, Snake1d):
            m.alpha.normal_(1.0, 0.1, generator=generator).abs_()
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding) or "codebook" in params:
            (m.weight if isinstance(m, nn.Embedding) else params["codebook"]).normal_(
                0.0, 1.0, generator=generator)
    return module


def init_codec_train_state(codec: nn.Module, disc: Discriminator, generator: torch.Generator,
                           gen_state_dict: Optional[dict] = None) -> Tuple[nn.Module, nn.Module]:
    """Seeded weights for both networks (:func:`init_codec_`);
    ``gen_state_dict`` warm-starts the codec from existing weights (a
    converted checkpoint, a facade's model), loaded strictly."""
    init_codec_(codec, generator)
    init_codec_(disc, generator)
    if gen_state_dict is not None:
        codec.load_state_dict(gen_state_dict, strict=True)
    return codec, disc


def make_codec_train_steps(codec: nn.Module, disc: Discriminator, codec_kind: str = "vae",
                           **kw) -> CodecTrainStep:
    """The alternating step at the JAX package's defaults (see
    :class:`CodecTrainStep`); its ``gen_opt`` and ``disc_opt`` are the two
    optimizers."""
    return CodecTrainStep(codec, disc, codec_kind, **kw)
