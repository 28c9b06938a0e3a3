"""DPM-Solver++(2M) for the DDIM schedule (counterpart of
``ezaudio_tpu/diffusion/dpm.py``).

Lu et al., arXiv 2211.01095, data-prediction multistep variant.  The
EzAudio schedule has zero terminal SNR (alpha_bar(999) = 0, lambda = -inf),
so every update is written through the ratios ``sigma_{i+1}/sigma_i`` and
``exp(-h_i)``, whose limits are finite; the first step reduces to
``x_1 = sigma_1 x_0 + alpha_1 x0_pred`` and the terminal step is first
order.  The tables are built in float64 numpy and kept as float32, exactly
as the JAX package builds them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.diffusion.sampling import (equal_flag_runs, group_band, guided,
                                                  guidance_band, rescale_noise_cfg)


def _dpm_tables(schedule: DDIMSchedule, num_steps: int):
    a_t, _, ts = schedule.step_tables(num_steps)
    abar = a_t.astype(np.float64)
    alpha = np.sqrt(abar)
    sigma = np.sqrt(1.0 - abar)
    # append the terminal point t=0: alpha=1, sigma=0
    alpha = np.append(alpha, 1.0)
    sigma = np.append(sigma, 0.0)

    with np.errstate(divide="ignore"):
        lam = np.log(np.maximum(alpha, 1e-300)) - np.log(np.maximum(sigma, 1e-300))
    h = lam[1:] - lam[:-1]  # (num_steps,)

    s_ratio = np.zeros(num_steps)
    e_term = np.zeros(num_steps)
    for i in range(num_steps):
        s_ratio[i] = sigma[i + 1] / sigma[i] if sigma[i] > 0 else 0.0
        # exp(-h_i) via ratios (0 when alpha_i == 0, i.e. zero-SNR start)
        if alpha[i + 1] > 0 and sigma[i] > 0:
            e_term[i] = (alpha[i] * sigma[i + 1]) / (alpha[i + 1] * sigma[i])
    coeff = alpha[1:] * (1.0 - e_term)

    # multistep ratio 1/(2 r_i) = h_i / (2 h_{i-1}); 0 when h_{i-1} = inf
    inv2r = np.zeros(num_steps)
    for i in range(1, num_steps):
        if np.isfinite(h[i - 1]) and np.isfinite(h[i]):
            inv2r[i] = h[i] / (2.0 * h[i - 1])
    # lower_order_final: the terminal step has h = +inf; use first order there
    inv2r[-1] = 0.0

    return (ts, abar.astype(np.float32), s_ratio.astype(np.float32),
            coeff.astype(np.float32), inv2r.astype(np.float32))


def dpm_solver_sample(model_fn: Callable, schedule: DDIMSchedule, noise: torch.Tensor,
                      num_steps: int, guidance_scale: Optional[float] = None,
                      guidance_rescale: float = 0.0,
                      layer_cache_fns: Optional[tuple] = None, cache_interval: int = 1,
                      guidance_interval: Optional[tuple] = None,
                      cfg_refresh_interval: int = 1):
    """Deterministic DPM-Solver++(2M) sampling from ``noise`` (B, L, C).

    ``model_fn`` has the contract of ``sampling.sample_latents``.
    ``layer_cache_fns=(model_full, model_cached)`` with ``cache_interval >
    1`` runs one full call per cache group and cached calls for the rest
    of it, as ``sample_latents_layer_cached`` does.  ``guidance_interval``
    applies CFG only inside the band (rounded outward to cache groups when
    caching); the 2M history crosses the band's edges.

    ``cfg_refresh_interval=P > 1`` runs the CFG pair only on every P-th
    in-band step (every P-th group with caching) and the other in-band
    steps cond-only, guided by the carried delta ``cond + (s - 1) *
    (cond_ref - uncond_ref)``.  Every in-band run of steps starts with a
    refresh, so the delta is written before it is read.
    """
    ts_np, abar, s_ratio, coeff, inv2r = _dpm_tables(schedule, num_steps)
    cfg_on = guidance_scale is not None
    in_band = guidance_band(ts_np, num_steps, cfg_on, guidance_interval)
    refresh_p = int(cfg_refresh_interval) if cfg_on else 1
    if refresh_p < 1:
        raise ValueError(f"cfg_refresh_interval must be >= 1, got {cfg_refresh_interval}")
    use_cache = layer_cache_fns is not None and cache_interval > 1

    # modes: 'pair'  - CFG pair (2B batch), recomputes the guidance delta;
    #        'reuse' - cond-only (B batch), guided by the carried delta;
    #        'plain' - cond-only, unguided (out of band / CFG off).
    def predict_x0(x, i, deep, mode, delta):
        t = int(ts_np[i])
        batch = torch.cat([x, x], dim=0) if mode == "pair" else x
        if not use_cache:
            out = model_fn(batch, t)
        elif deep is None:
            out, deep = layer_cache_fns[0](batch, t)
        else:
            out = layer_cache_fns[1](batch, t, deep)
        if mode == "pair":
            cond, uncond = out.chunk(2, dim=0)
            delta = (cond - uncond).to(x.dtype)
            pred = guided(out, guidance_scale, guidance_rescale)
        elif mode == "reuse":
            pred = out + (guidance_scale - 1.0) * delta
            if guidance_rescale > 0.0:
                pred = rescale_noise_cfg(pred, out, guidance_rescale)
        else:
            pred = out
        x0, _ = schedule.convert_output(pred, x, float(abar[i]))
        return x0, deep, delta

    x, x0_prev, has_prev, delta = noise, torch.zeros_like(noise), 0.0, torch.zeros_like(noise)

    def step(i, deep, mode):
        """One model call and 2M update (first order on the first step);
        returns the deep activation."""
        nonlocal x, x0_prev, has_prev, delta
        x0, deep, delta = predict_x0(x, i, deep, mode, delta)
        # f32 update from a bf16 carry, cast back (the JAX f32 tables promote)
        w = float(inv2r[i]) * has_prev
        d = (1.0 + w) * x0 - w * x0_prev.float()
        x = (float(s_ratio[i]) * x.float() + float(coeff[i]) * d).to(noise.dtype)
        x0_prev, has_prev = x0.to(noise.dtype), 1.0
        return deep

    def step_mode(flag: bool, offset: int) -> str:
        """Mode of the ``offset``-th step or group of an equal-flag run."""
        if not flag:
            return "plain"
        return "pair" if offset % refresh_p == 0 else "reuse"

    if not use_cache:
        for start, end, flag in equal_flag_runs(in_band):
            for k in range(end - start):
                step(start + k, None, step_mode(flag, k))
        return x

    groups = num_steps // cache_interval
    g_band = group_band(in_band, cache_interval, groups)
    for g0, g1, flag in equal_flag_runs(g_band):
        for k in range(g1 - g0):
            mode = step_mode(flag, k)
            i0 = (g0 + k) * cache_interval
            deep = step(i0, None, mode)
            for i in range(i0 + 1, i0 + cache_interval):
                step(i, deep, mode)
    # trailing partial group: full-depth calls, CFG refreshed where in band
    for i in range(groups * cache_interval, num_steps):
        step(i, None, "pair" if in_band[i] else "plain")
    return x
