"""Shared mid-scale plumbing (counterpart of the parts of
``scripts/mid_common.py`` that ``quality_validate_mid`` uses): the cache
root, the parameter cache (``_save_params`` / ``_load_params``), the VAE
fingerprint that keys caches on the exact fitted VAE, and the brief
adversarial fit of the production-geometry VAE (``fit_vae_facade``).

The cache root lies outside the checkout (``default_cache_root``): a
depth-12 teacher is ~0.33 GB in f32 and the flagship ~2.4 GB.  Every entry
point takes ``--cache-root`` instead.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

PROMPTS = [
    "a deep tone pulsing very slowly",
    "a low tone with a gentle beat",
    "a mid tone trembling quickly",
    "a high tone fluttering rapidly",
]
GUIDANCE = 3.0


def default_cache_root() -> str:
    """``$XDG_CACHE_HOME/ezaudio_tpu_torch/mid`` (``~/.cache`` without it)."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "ezaudio_tpu_torch", "mid")


def _save_params(folder: str, params: Dict[str, torch.Tensor], meta: dict) -> None:
    """A state dict (name -> tensor) as ``params.npz`` and ``meta`` as
    ``meta.json`` under ``folder``."""
    os.makedirs(folder, exist_ok=True)
    flat = {k: v.detach().cpu().numpy() for k, v in params.items()}
    np.savez(os.path.join(folder, "params.npz"), **flat)
    with open(os.path.join(folder, "meta.json"), "w") as f:
        json.dump(meta, f)


def _load_params(folder: str):
    """``(state dict of CPU tensors, meta)`` written by :func:`_save_params`."""
    with np.load(os.path.join(folder, "params.npz")) as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    with open(os.path.join(folder, "meta.json")) as f:
        return params, json.load(f)


def _vae_fingerprint(params: Dict[str, torch.Tensor]) -> str:
    """Cheap content fingerprint of a state dict, used to key the latent
    and teacher caches on the exact fitted VAE."""
    total = 0.0
    for v in params.values():
        total += float(np.float64(np.abs(v.detach().cpu().numpy()).sum()))
    return f"{total:.6e}".replace("+", "")


def fit_vae_facade(facade, sr: int, steps: int = 1500, batch: int = 4, seg_s: float = 1.0,
                   cache_root: Optional[str] = None):
    """Briefly train ``facade``'s VAE on the synth family (multi-scale STFT +
    KL + adversarial, ``training/codec_trainer.py``) so the decoder is
    non-degenerate: a random decoder collapses to near-constant audio, which
    zeroes every audio-domain metric.  Crops of ``batch`` x ``seg_s`` s come
    from a pool of 32 seeded 4 s clips; the snapshot with the best smoothed
    mrstft is kept (adversarial fits destabilise late: the JAX harness saw
    mrstft 3.9 -> 4784 at step 1250 of 1500).  Cached on disk by (steps,
    batch); the weights are loaded into ``facade.model``.  Returns the
    per-step walls (empty when the cache served)."""
    from ezaudio_tpu_torch.codecs.discriminator import Discriminator
    from ezaudio_tpu_torch.training.codec_trainer import (init_codec_train_state,
                                                          make_codec_train_steps)
    from ezaudio_tpu_torch.validation.quality_validate_mid import synth_clip

    folder = os.path.join(cache_root or default_cache_root(), "mid_vae", f"s{steps}_b{batch}")
    model = facade.model
    if os.path.exists(os.path.join(folder, "params.npz")):
        params, _ = _load_params(folder)
        model.load_state_dict(params, strict=True)
        print(f"[vae] reusing cached fitted VAE: {folder}", flush=True)
        return []
    dev = next(model.parameters()).device
    seg = int(seg_s * sr)
    rng = np.random.default_rng(42)
    # a pool of full clips to crop from (all 4 classes)
    pool = np.stack([synth_clip(rng, c % len(PROMPTS), 4 * sr, sr) for c in range(32)])
    pool /= np.abs(pool).max(axis=1, keepdims=True) + 1e-9

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        disc = Discriminator(periods=(2, 3), fft_sizes=(1024, 512), rates=(), sample_rate=sr)
    disc = disc.to(dev)
    step_fn = make_codec_train_steps(model, disc, "vae", sample_rate=sr, gen_lr=3e-4,
                                     disc_lr=3e-4, warmup=0.0,
                                     stft_windows=(2048, 1024, 512, 256))

    def crops(n):
        idx = rng.integers(0, len(pool), n)
        off = rng.integers(0, pool.shape[1] - seg, n)
        return np.stack([pool[i, o:o + seg] for i, o in zip(idx, off)])

    crops(batch)  # the JAX harness draws its init batch here: keep the crops aligned
    # seeded discriminator; the VAE keeps its weights (a warm start)
    init_codec_train_state(model, disc, torch.Generator(device=dev).manual_seed(5),
                           gen_state_dict={k: v.clone() for k, v in model.state_dict().items()})
    t1 = time.time()
    ema, best_ema, best, walls = None, float("inf"), None, []
    for i in range(steps):
        audio = torch.as_tensor(crops(batch)[:, :, None], device=dev)
        ts = time.perf_counter()
        cur = float(step_fn(audio, seed=i)["gen/mrstft"])
        walls.append(time.perf_counter() - ts)
        ema = cur if ema is None else 0.95 * ema + 0.05 * cur
        if i >= steps // 4 and i % 50 == 0 and ema < best_ema:
            best_ema = ema
            best = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        if i % 250 == 0 or i == steps - 1:
            print(f"  [vae] step {i}: mrstft {cur:.4f} (ema {ema:.4f}, best {best_ema:.4f}, "
                  f"{time.time() - t1:.0f}s)", flush=True)
    if best is None or ema < best_ema:
        best = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        best_ema = ema
    print(f"[vae] keeping snapshot at ema mrstft {best_ema:.4f}", flush=True)
    model.load_state_dict(best, strict=True)
    model.eval().requires_grad_(False)
    _save_params(folder, best, {"steps": steps, "best_ema_mrstft": best_ema})
    print(f"[vae] cached: {folder}", flush=True)
    return walls
