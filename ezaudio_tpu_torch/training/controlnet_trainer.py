"""ControlNet fine-tuning: a frozen base MaskDiT and the ControlNet's
trainable subset (counterpart of
``ezaudio_tpu/training/controlnet_trainer.py::make_controlnet_train_step``).

One step, as the JAX package's:

  * latents into model space, noise and a uniform timestep, the v (or
    epsilon) target;
  * the base's MAE concat with the full-mask gt (``forward_model=False``,
    no gradient: the base is frozen), the ControlNet's skips with the
    training condition masking (``train=True``), then the base's backbone
    with the skips: the gradient reaches the ControlNet only through the
    frozen backbone (recomputed block by block under ``use_checkpoint``);
  * the masked (min-SNR) MSE;
  * the optimizer over the trainable subset alone (``trainable_mask``:
    ``controlnet_pre``, the in-blocks, the zero projections):
    ``clip_by_global_norm`` over those gradients only, then ``optax.adamw``
    at its defaults (weight decay 1e-4 on every trainable tensor, no
    mask; ``optim.make_adamw``).  The embedders copied from the base get
    no update.

The metrics are the loss and the global norm of the gradients of every
ControlNet parameter, the frozen embedders' included, as the JAX package
reports.  Every draw of step ``n`` comes from a generator seeded from
``(seed, n)``; ``draws=`` takes the JAX package's instead (ROADMAP F1).
Quantization is off inside the step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.models.controlnet import DiTControlNet, trainable_mask
from ezaudio_tpu_torch.training.losses import masked_diffusion_loss
from ezaudio_tpu_torch.training.optim import global_norm, make_adamw, warmup_lr_schedule
from ezaudio_tpu_torch.training.trainer import StepLoop, noised
from ezaudio_tpu_torch.utils import scale_shift


class ControlNetTrainStep(StepLoop):
    """``step(batch, seed, draws=None) -> {"loss", "grad_norm"}``.

    batch: ``latents`` (B, L, C) before ``scale_shift``; ``condition``
    (B, Lcond, cond_in); ``text`` (B, Lc, D) and ``text_mask`` (B, Lc).
    draws: ``noise`` (B, L, C), ``t`` (B,) int, and with the condition
    masking on, those of ``ControlNetEmbed.draw_mask``.
    """

    def __init__(self, dit: nn.Module, cn: DiTControlNet, schedule: DDIMSchedule,
                 learning_rate: float = 5e-5, warmup: int = 5000, grad_clip: float = 1.0,
                 scale: float = 1.0, shift: float = 0.0, snr_gamma: Optional[float] = None,
                 conditioning_scale: float = 1.0):
        if schedule.prediction_type not in ("epsilon", "v_prediction"):
            raise NotImplementedError(schedule.prediction_type)
        self.dit = dit.eval().requires_grad_(False)
        self.cn = cn.train().requires_grad_(True)
        base = {p.data_ptr() for p in self.dit.parameters()}
        if any(p.data_ptr() in base for p in self.cn.parameters()):
            raise ValueError("the ControlNet shares tensors with the base: copy them "
                             "(models/controlnet.py::init_from_base_)")
        self.params = dict(self.cn.named_parameters())
        mask = trainable_mask(self.cn)
        self.optimizer = make_adamw({n: p for n, p in self.params.items() if mask[n]},
                                    warmup_lr_schedule(learning_rate, warmup), grad_clip)
        self.schedule = schedule
        self.scale, self.shift, self.snr_gamma = scale, shift, snr_gamma
        self.conditioning_scale = conditioning_scale
        self.step = 0

    def draw(self, generator: torch.Generator, batch: dict) -> dict:
        latents, cond = batch["latents"], batch["condition"]
        B, dev = latents.shape[0], latents.device
        d = dict(noise=torch.randn(latents.shape, generator=generator, device=dev),
                 t=torch.randint(0, self.schedule.num_train_timesteps, (B,),
                                 generator=generator, device=dev))
        pre = self.cn.controlnet_pre
        if pre.cond_mask:
            d.update(pre.draw_mask(generator, B, cond.shape[1], dev))
        return d

    def loss(self, batch: dict, draws: dict) -> torch.Tensor:
        latents = scale_shift(batch["latents"].float(), self.scale, self.shift)
        t = draws["t"]
        noisy, target = noised(self.schedule, latents, draws["noise"], t)
        text, text_mask = batch.get("text"), batch.get("text_mask")
        with torch.no_grad():
            concat, mae_mask = self.dit(noisy, t, text, context_mask=text_mask,
                                        forward_model=False)
        skips = self.cn(concat, t, text, context_mask=text_mask, condition=batch["condition"],
                        conditioning_scale=self.conditioning_scale, train=True,
                        mask_draws=draws)
        pred = self.dit.forward_backbone(concat, t, text, context_mask=text_mask,
                                         controlnet_skips=skips)
        return masked_diffusion_loss(pred, target, mae_mask, self.schedule, t, self.snr_gamma)

    def update(self, grads: dict) -> dict:
        """The trainable subset's update; the norm over every leaf."""
        gnorm = global_norm(grads.values())
        self.optimizer.update({n: grads[n] for n in self.optimizer.params})
        return {"grad_norm": gnorm}


def make_controlnet_train_step(dit, cn, schedule, learning_rate=5e-5, warmup=5000,
                               grad_clip=1.0, scale=1.0, shift=0.0, snr_gamma=None,
                               conditioning_scale=1.0) -> ControlNetTrainStep:
    return ControlNetTrainStep(dit, cn, schedule, learning_rate, warmup, grad_clip, scale,
                               shift, snr_gamma, conditioning_scale)
