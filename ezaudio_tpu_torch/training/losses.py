"""Diffusion training loss (counterpart of
``ezaudio_tpu/training/losses.py::masked_diffusion_loss``).

Masked MSE normalised per sample by the mask's area, optional min-SNR-gamma
weighting (arXiv 2303.09556; for v-prediction the weight is
``min(snr, gamma) / (snr + 1)``), mean over the batch; in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule


def masked_diffusion_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                          schedule: DDIMSchedule, timesteps: torch.Tensor,
                          snr_gamma: Optional[float] = None) -> torch.Tensor:
    err = (pred.float() - target.float()).square() * mask.float()
    per_sample = err.sum(dim=(1, 2)) / mask.float().sum(dim=(1, 2)).clamp(min=1.0)
    if snr_gamma is not None:
        snr = schedule.snr(timesteps).to(per_sample.device)
        w = snr.clamp(max=snr_gamma)
        if schedule.prediction_type == "epsilon":
            # zero-terminal-SNR schedules make snr(T-1) exactly 0: clamp so
            # the terminal step cannot turn the batch loss into NaN
            w = w / snr.clamp(min=1e-8)
        elif schedule.prediction_type == "v_prediction":
            w = w / (snr + 1.0)
        else:
            raise NotImplementedError(schedule.prediction_type)
        per_sample = per_sample * w
    return per_sample.mean()
