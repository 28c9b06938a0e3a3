"""Rectified flow / flow matching: schedule, sampler and training loss
(counterpart of ``ezaudio_tpu/diffusion/flow.py``).

  * the path ``x_t = (1 - t) x0 + t eps``, t in [0, 1], t = 1 pure noise;
  * the target: the constant velocity ``v = eps - x0`` (Lipman et al.
    arXiv 2210.02747; Liu et al. arXiv 2209.03003);
  * samplers: Euler and Heun (2nd order) over a descending grid with an
    optional SD3-style ``shift``, CFG as the DDIM sampler does it (the
    doubled batch, ``rescale_noise_cfg``).

The model sees ``t * num_train_timesteps``, the DiT's timestep range:
``model_fn(x, t_scaled)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ezaudio_tpu_torch.diffusion.sampling import rescale_noise_cfg


@dataclasses.dataclass(frozen=True)
class FlowSchedule:
    num_train_timesteps: int = 1000
    shift: float = 1.0  # SD3-style timestep shift; 1 = uniform

    def timesteps(self, num_steps: int) -> np.ndarray:
        """Descending grid in (0, 1]: t_0 = 1 (noise) -> t_N = 0, f32."""
        t = np.linspace(1.0, 0.0, num_steps + 1)
        if self.shift != 1.0:
            s = self.shift
            t = s * t / (1 + (s - 1) * t)
        return t.astype(np.float32)

    def interpolate(self, x0, noise, t):
        """``(1 - t) x0 + t noise``, t (B,) broadcast."""
        t = t.reshape(t.shape + (1,) * (x0.ndim - t.ndim))
        return (1.0 - t) * x0 + t * noise

    def velocity_target(self, x0, noise):
        return noise - x0

    def loss_weight(self, t):
        """Uniform; the hook for lognorm weightings."""
        return torch.ones_like(t)


def flow_sample(model_fn: Callable, schedule: FlowSchedule, noise: torch.Tensor,
                num_steps: int, guidance_scale: Optional[float] = None,
                guidance_rescale: float = 0.0, method: str = "euler") -> torch.Tensor:
    """Integrate ``dx/dt = v(x, t)`` from t = 1 (noise) to t = 0.  With
    guidance ``model_fn`` gets the doubled batch ``[x; x]`` (its context
    cond-first) and the two halves combine as the DDIM sampler's."""
    if method not in ("euler", "heun"):
        raise NotImplementedError(method)
    ts = schedule.timesteps(num_steps)
    scale_t = np.float32(schedule.num_train_timesteps)

    def predict(x, t):
        t_model = torch.full((), float(np.float32(t) * scale_t), device=x.device)
        if guidance_scale is not None:
            cond, uncond = model_fn(torch.cat([x, x], dim=0), t_model).chunk(2, dim=0)
            v = uncond + guidance_scale * (cond - uncond)
            if guidance_rescale > 0.0:
                v = rescale_noise_cfg(v, cond, guidance_rescale)
            return v
        return model_fn(x, t_model)

    x = noise
    for i in range(num_steps):
        dt = float(np.float32(ts[i + 1]) - np.float32(ts[i]))  # negative
        v = predict(x, ts[i])
        if method == "euler":
            x_next = x + dt * v
        else:
            v2 = predict(x + dt * v, ts[i + 1])
            x_next = x + dt * 0.5 * (v + v2)
        x = x_next.to(noise.dtype)
    return x


def flow_matching_loss(model_apply: Callable, x0: torch.Tensor, noise: torch.Tensor,
                       t: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       schedule: Optional[FlowSchedule] = None, **model_kwargs) -> torch.Tensor:
    """Masked flow-matching MSE: ``model_apply(x_t, t_scaled, **kw) ->
    (pred, mae_mask)`` predicts v at x_t, the target is ``noise - x0``;
    each sample's squared error over its mask (``mask``, else the model's)
    divided by the mask's area, times ``schedule.loss_weight(t)``, mean.
    ``schedule`` must be the sampler's (default ``FlowSchedule()``)."""
    sched = schedule or FlowSchedule()
    xt = sched.interpolate(x0, noise, t)
    target = sched.velocity_target(x0, noise)
    pred, mae_mask = model_apply(xt, t * sched.num_train_timesteps, **model_kwargs)
    m = (mae_mask if mask is None else mask).float()
    err = (pred.float() - target.float()).square() * m
    dims = tuple(range(1, err.ndim))
    per = err.sum(dim=dims) / m.sum(dim=tuple(range(1, m.ndim))).clamp(min=1.0)
    return (sched.loss_weight(t) * per).mean()
