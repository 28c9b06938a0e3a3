"""The DDIM sampling loop with classifier-free guidance (counterpart of
``ezaudio_tpu/diffusion/sampling.py::sample_latents``).

  * CFG by a doubled batch ``[cond; uncond]`` -> one backbone call;
  * guidance ``uncond + s * (cond - uncond)``;
  * optional CFG rescale (arXiv 2305.08891 §3.4), Bessel std like torch.std;
  * eta-noised DDIM step.  The per-step noise comes from a
    ``torch.Generator``, or from ``step_noise`` when the caller injects it
    (the JAX sampler's ``fold_in`` draws cannot be reproduced in torch,
    so parity tests pass the same noise to both sides).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """Std-matching CFG rescale (reference src/inference.py:12-23)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def sample_latents(model_fn: Callable, schedule: DDIMSchedule, noise: torch.Tensor,
                   num_steps: int, guidance_scale: Optional[float] = None,
                   guidance_rescale: float = 0.0, eta: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   step_noise: Optional[Callable[[int], torch.Tensor]] = None):
    """Run the DDIM loop from ``noise`` (B, L, C).

    With ``guidance_scale`` set, ``model_fn`` receives the CFG pair batch
    ``cat([latents, latents])`` and returns ``[cond; uncond]`` outputs.
    ``step_noise(i)`` overrides the generator's draw for step ``i``.
    """
    a_t, a_prev, ts = schedule.step_tables(num_steps)
    latents = noise
    for i in range(num_steps):
        t = int(ts[i])
        if guidance_scale is not None:
            out = model_fn(torch.cat([latents, latents], dim=0), t)
            cond, uncond = out.chunk(2, dim=0)
            pred = uncond + guidance_scale * (cond - uncond)
            if guidance_rescale > 0.0:
                pred = rescale_noise_cfg(pred, cond, guidance_rescale)
        else:
            pred = model_fn(latents, t)
        noise_i = None
        if eta > 0:
            if step_noise is not None:
                noise_i = step_noise(i).to(latents)
            else:
                noise_i = torch.randn(latents.shape, generator=generator,
                                      device=latents.device, dtype=latents.dtype)
        latents = schedule.ddim_step(pred, latents, float(a_t[i]), float(a_prev[i]),
                                     eta=eta, noise=noise_i).to(latents.dtype)
    return latents
