"""DDIM noise schedule, step and training targets (counterpart of
``ezaudio_tpu/diffusion/ddim.py::DDIMSchedule``).

diffusers ``DDIMScheduler`` math as the EzAudio config sets it:
scaled-linear betas, zero-terminal-SNR rescale (arXiv 2305.08891),
trailing timestep spacing, v-prediction, eta-variance DDIM step
(arXiv 2010.02502 eq. 12), ``final_alpha_cumprod = 1``.  The tables are
built in float64 numpy and kept as float32, exactly as the JAX package;
the step computes in f32 whatever the latents' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def make_betas(num_train_timesteps: int = 1000, beta_schedule: str = "scaled_linear",
               beta_start: float = 0.00085, beta_end: float = 0.012) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    raise NotImplementedError(beta_schedule)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (alg. 1)."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = abar_sqrt[0].copy(), abar_sqrt[-1].copy()
    abar_sqrt = (abar_sqrt - aT) * a0 / (a0 - aT)
    abar = abar_sqrt**2
    alphas = np.concatenate([abar[0:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    num_train_timesteps: int
    alphas_cumprod: np.ndarray  # (N,) float32
    final_alpha_cumprod: float
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    clip_sample: bool = False

    @classmethod
    def from_config(cls, diff_cfg: dict) -> "DDIMSchedule":
        n = int(diff_cfg.get("num_train_timesteps", 1000))
        betas = make_betas(n, diff_cfg.get("beta_schedule", "scaled_linear"),
                           float(diff_cfg.get("beta_start", 0.00085)),
                           float(diff_cfg.get("beta_end", 0.012)))
        if diff_cfg.get("rescale_betas_zero_snr", False):
            betas = rescale_zero_terminal_snr(betas)
        return cls(
            num_train_timesteps=n,
            alphas_cumprod=np.cumprod(1.0 - betas).astype(np.float32),
            final_alpha_cumprod=1.0,
            prediction_type=diff_cfg.get("prediction_type", "v_prediction"),
            timestep_spacing=diff_cfg.get("timestep_spacing", "trailing"),
            clip_sample=bool(diff_cfg.get("clip_sample", False)),
        )

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps (diffusers set_timesteps)."""
        n, s = self.num_train_timesteps, num_inference_steps
        if self.timestep_spacing == "trailing":
            return np.round(np.arange(n, 0, -n / s)).astype(np.int64) - 1
        if self.timestep_spacing == "leading":
            return (np.arange(0, s) * (n // s)).round()[::-1].astype(np.int64)
        if self.timestep_spacing == "linspace":
            return np.linspace(0, n - 1, s).round()[::-1].astype(np.int64)
        raise NotImplementedError(self.timestep_spacing)

    def step_tables(self, num_inference_steps: int) -> Tuple[np.ndarray, ...]:
        """Per-step (alpha_prod_t, alpha_prod_prev, timestep)."""
        ts = self.timesteps(num_inference_steps)
        prev = ts - self.num_train_timesteps // num_inference_steps
        a_t = self.alphas_cumprod[ts]
        a_prev = np.where(prev >= 0, self.alphas_cumprod[np.clip(prev, 0, None)],
                          np.float32(self.final_alpha_cumprod)).astype(np.float32)
        return a_t.astype(np.float32), a_prev, ts

    def convert_output(self, model_output, sample, alpha_prod_t):
        """(pred_x0, pred_epsilon) for the configured prediction type, in
        f32: the JAX package's f32 tables promote bf16 operands."""
        model_output, sample = model_output.float(), sample.float()
        a = torch.as_tensor(alpha_prod_t, dtype=torch.float32)
        sqrt_a, sqrt_b = a.sqrt(), (1.0 - a).sqrt()
        if self.prediction_type == "v_prediction":
            return (sqrt_a * sample - sqrt_b * model_output,
                    sqrt_a * model_output + sqrt_b * sample)
        if self.prediction_type == "epsilon":
            return (sample - sqrt_b * model_output) / sqrt_a, model_output
        raise NotImplementedError(self.prediction_type)

    def ddim_step(self, model_output, sample, alpha_prod_t, alpha_prod_prev,
                  eta: float = 0.0, noise: Optional[torch.Tensor] = None):
        """One DDIM update x_t -> x_{t-1}, in f32 (the caller casts the
        result back to the carry's dtype)."""
        x0, eps = self.convert_output(model_output, sample, alpha_prod_t)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        a_t = torch.as_tensor(alpha_prod_t, dtype=torch.float32)
        a_prev = torch.as_tensor(alpha_prod_prev, dtype=torch.float32)
        variance = ((1.0 - a_prev) / (1.0 - a_t)) * (1.0 - a_t / a_prev)
        std = eta * variance.sqrt()
        direction = (1.0 - a_prev - std**2).clamp(min=0.0).sqrt() * eps
        prev = a_prev.sqrt() * x0 + direction
        if eta > 0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            prev = prev + std * noise.float()
        return prev

    def _abar(self, timesteps, like):
        """alphas_cumprod[timesteps] in f32 on ``like``'s device, shaped to
        broadcast against ``like``."""
        t = torch.as_tensor(timesteps, device=like.device).long()
        a = torch.from_numpy(self.alphas_cumprod).to(like.device)[t]
        return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))

    def add_noise(self, sample, noise, timesteps):
        """q(x_t | x_0): ``sqrt(abar) x0 + sqrt(1-abar) eps``."""
        a = self._abar(timesteps, sample)
        return a.sqrt() * sample + (1.0 - a).sqrt() * noise

    def get_velocity(self, sample, noise, timesteps):
        """v target: ``sqrt(abar) eps - sqrt(1-abar) x0``."""
        a = self._abar(timesteps, sample)
        return a.sqrt() * noise - (1.0 - a).sqrt() * sample

    def snr(self, timesteps):
        """SNR(t) = abar / (1 - abar) (reference src/utils/utils.py:61-86)."""
        t = torch.as_tensor(timesteps)
        a = torch.from_numpy(self.alphas_cumprod).to(t.device)[t.long()]
        return a / (1.0 - a)
