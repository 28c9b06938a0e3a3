"""The DDIM sampling loops with classifier-free guidance (counterpart of
``ezaudio_tpu/diffusion/sampling.py``).

  * CFG by a doubled batch ``[cond; uncond]`` -> one backbone call;
  * guidance ``uncond + s * (cond - uncond)``;
  * optional CFG rescale (arXiv 2305.08891 §3.4), Bessel std like torch.std;
  * optional guidance band (arXiv 2404.07724): CFG only for timesteps in
    ``[t_lo, t_hi]``, the conditional model alone elsewhere;
  * eta-noised DDIM step.  The per-step noise comes from a
    ``torch.Generator``, or from ``step_noise`` when the caller injects it
    (the JAX sampler's ``fold_in`` draws cannot be reproduced in torch,
    so parity tests pass the same noise to both sides);
  * :func:`sample_latents_layer_cached`: cross-step DiT layer caching, one
    full-depth call per cache group and shallow calls around its deep
    activation for the rest of the group.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """Std-matching CFG rescale (reference src/inference.py:12-23)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def guidance_band(ts_np, num_steps: int, cfg_on: bool, guidance_interval) -> np.ndarray:
    """Per-step CFG flags for a ``(t_lo, t_hi)`` guidance band; constant
    when there is no band or CFG is off.  A reversed band raises (it would
    turn CFG off everywhere)."""
    if cfg_on and guidance_interval is not None:
        t_lo, t_hi = guidance_interval
        if t_lo > t_hi:
            raise ValueError("guidance_interval must be (t_lo, t_hi) with t_lo <= t_hi, "
                             f"got {guidance_interval!r}")
        return (np.asarray(ts_np) >= t_lo) & (np.asarray(ts_np) <= t_hi)
    return np.full(num_steps, cfg_on, dtype=bool)


def equal_flag_runs(flags):
    """Yield ``(start, end, flag)`` for the maximal runs of equal values."""
    n = len(flags)
    start = 0
    while start < n:
        end = start
        while end < n and flags[end] == flags[start]:
            end += 1
        yield start, end, bool(flags[start])
        start = end


def group_band(in_band: np.ndarray, cache_interval: int, groups: int) -> np.ndarray:
    """Group-level CFG flags under layer caching: any in-band step turns
    its whole cache group on (outward rounding: the full and cached calls
    of a group share a batch size, since the deep cache is collected at
    the group head)."""
    return np.array([in_band[g * cache_interval:(g + 1) * cache_interval].any()
                     for g in range(groups)], dtype=bool)


def guided(out, guidance_scale: float, guidance_rescale: float):
    """The guided prediction from a ``[cond; uncond]`` model output."""
    cond, uncond = out.chunk(2, dim=0)
    pred = uncond + guidance_scale * (cond - uncond)
    if guidance_rescale > 0.0:
        pred = rescale_noise_cfg(pred, cond, guidance_rescale)
    return pred


def _ddim_update(schedule, pred, latents, a_t, a_prev, i, eta, generator, step_noise):
    noise_i = None
    if eta > 0:
        if step_noise is not None:
            noise_i = step_noise(i).to(latents)
        else:
            noise_i = utils.randn(latents.shape, generator, latents.device, latents.dtype)
    return schedule.ddim_step(pred, latents, float(a_t[i]), float(a_prev[i]),
                              eta=eta, noise=noise_i).to(latents.dtype)


def sample_latents(model_fn: Callable, schedule: DDIMSchedule, noise: torch.Tensor,
                   num_steps: int, guidance_scale: Optional[float] = None,
                   guidance_rescale: float = 0.0, eta: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   step_noise: Optional[Callable[[int], torch.Tensor]] = None,
                   guidance_interval: Optional[Tuple[float, float]] = None):
    """Run the DDIM loop from ``noise`` (B, L, C).

    With ``guidance_scale`` set, ``model_fn`` receives the CFG pair batch
    ``cat([latents, latents])`` and returns ``[cond; uncond]`` outputs; on
    steps outside ``guidance_interval`` it receives the single batch.
    ``step_noise(i)`` overrides the generator's draw for step ``i``.
    """
    a_t, a_prev, ts = schedule.step_tables(num_steps)
    in_band = guidance_band(ts, num_steps, guidance_scale is not None, guidance_interval)
    latents = noise
    for i in range(num_steps):
        t = int(ts[i])
        if in_band[i]:
            pred = guided(model_fn(torch.cat([latents, latents], dim=0), t),
                          guidance_scale, guidance_rescale)
        else:
            pred = model_fn(latents, t)
        latents = _ddim_update(schedule, pred, latents, a_t, a_prev, i, eta, generator,
                               step_noise)
    return latents


def sample_latents_layer_cached(model_full: Callable, model_cached: Callable,
                                schedule: DDIMSchedule, noise: torch.Tensor,
                                num_steps: int, cache_interval: int = 2,
                                guidance_scale: Optional[float] = None,
                                guidance_rescale: float = 0.0, eta: float = 1.0,
                                guidance_interval: Optional[Tuple[float, float]] = None,
                                generator: Optional[torch.Generator] = None,
                                step_noise: Optional[Callable[[int], torch.Tensor]] = None):
    """DDIM loop with cross-step DiT layer caching.

    Every ``cache_interval``-th step calls ``model_full(x, t) -> (out,
    deep)``; the other steps of its group call ``model_cached(x, t, deep)
    -> out`` on that group's deep activation.  Both receive the CFG pair
    batch where CFG is on.  A guidance band rounds outward to cache groups
    (:func:`group_band`); the steps past the last whole group are full
    calls with their own per-step flag.  ``cache_interval=1`` is the plain
    sampler.
    """
    if cache_interval < 1:
        raise ValueError(f"cache_interval must be >= 1, got {cache_interval}")
    a_t, a_prev, ts = schedule.step_tables(num_steps)
    in_band = guidance_band(ts, num_steps, guidance_scale is not None, guidance_interval)

    def step(latents, i, use_cfg, deep):
        """One model call + DDIM update; ``deep=None`` is a full call,
        which returns the new deep activation."""
        batch = torch.cat([latents, latents], dim=0) if use_cfg else latents
        if deep is None:
            out, deep = model_full(batch, int(ts[i]))
        else:
            out = model_cached(batch, int(ts[i]), deep)
        pred = guided(out, guidance_scale, guidance_rescale) if use_cfg else out
        return _ddim_update(schedule, pred, latents, a_t, a_prev, i, eta, generator,
                            step_noise), deep

    groups = num_steps // cache_interval
    g_band = group_band(in_band, cache_interval, groups)
    latents = noise
    for g in range(groups):
        i0 = g * cache_interval
        latents, deep = step(latents, i0, g_band[g], None)
        for i in range(i0 + 1, i0 + cache_interval):
            latents, _ = step(latents, i, g_band[g], deep)
    for i in range(groups * cache_interval, num_steps):
        latents, _ = step(latents, i, in_band[i], None)
    return latents
