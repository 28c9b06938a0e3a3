"""Shared mid-scale plumbing (counterpart of ``scripts/mid_common.py``): a
prompt-conditioned ``EzAudio`` at the production latent geometry (vae.json:
24 kHz, x480, 128 channels) with a tiny T5, the 4-class synthetic data
family encoded through its own VAE, and a cached teacher-training loop.

``quality_validate_mid`` uses the cache root, the parameter cache
(``_save_params`` / ``_load_params``), the VAE fingerprint that keys caches
on the exact fitted VAE and the brief adversarial fit of the VAE
(``fit_vae_facade``); ``distill_serve_mid`` and
``quality_edit_controlnet_mid`` need the same trained base, so
:func:`train_teacher` caches it on disk (a ``model_io`` bundle keyed by
geometry and steps) and trains it at most once.

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


# ---------------------------------------------------------------------------
# the mid-scale EzAudio, its data and its teacher (distill_serve_mid,
# quality_edit_controlnet_mid)
# ---------------------------------------------------------------------------

# the tiny T5 of the mid model: conditioning runs through the real
# tokenizer -> T5 path, so serving and editing reproduce training's
MID_T5 = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
              relative_attention_num_buckets=8, relative_attention_max_distance=20)
MID_DIFF = dict(num_train_timesteps=1000, beta_schedule="scaled_linear", beta_start=0.00085,
                beta_end=0.012, prediction_type="v_prediction", rescale_betas_zero_snr=True,
                timestep_spacing="trailing", clip_sample=False)
# the reference energy ControlNet's geometry (ckpts/controlnet/energy_l.yml)
MID_CONTROLNET = dict(cond_in=1, cond_blocks=[64, 128], cond_mask=True, cond_mask_prob=0.25,
                      cond_mask_ratio=[0.25, 0.50], cond_mask_span=10)
MID_CONDITIONER = dict(condition_type="energy", hop_size=240, window_size=1920,
                       padding="reflect", min_db=-60, norm=True)
ENCODE_CHUNK = 8  # clips per VAE call


class RunningMean:
    """A training loop's losses summed on the device (one sync a logging
    interval, not one a step); :meth:`take` gives the interval's mean as a
    log field and keeps ``(step, mean)`` in ``curve``."""

    def __init__(self):
        self.total, self.n, self.curve = 0.0, 0, []

    def add(self, loss) -> None:
        self.total = self.total + loss.detach()
        self.n += 1

    def take(self, step: int) -> str:
        mean = float(self.total) / self.n
        self.curve.append((step, mean))
        text = f"mean loss {mean:.5f} over {self.n} steps"
        self.total, self.n = 0.0, 0
        return text


def peak_wav(x) -> np.ndarray:
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def _np(x) -> np.ndarray:
    """A codec output (tensor or array) as a float32 host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def build_mid_ezaudio(depth: int, dim: int, heads: int, frames: int,
                      dtype: torch.dtype = torch.float32, with_controlnet: bool = False,
                      device=None, vae_config: Optional[dict] = None):
    """``(ez, cfg, model_cfg, vae_cfg)``: EzAudio at mid scale with the
    production VAE geometry (``vae_config``, default ``vae.json``) and the
    tiny T5 (``MID_T5``, ``max_length`` 8) on seeded random weights.
    ``with_controlnet`` adds the reference energy-ControlNet blocks to the
    config so ``EzAudioControlNet(base=ez)`` can attach."""
    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
    from ezaudio_tpu_torch.validation.quality_validate_mid import model_config, vae_json

    vae_cfg = vae_config or vae_json()
    C = vae_cfg["model"]["latent_dim"]
    sr = vae_cfg["sample_rate"]
    ratio = vae_cfg["model"]["downsampling_ratio"]
    model_cfg = model_config(depth, dim, heads, frames, C, False)
    cfg = dict(
        model_name="EzAudio-Mid",
        model=model_cfg,
        autoencoder=dict(name="stable_vae", dim=C, sr=sr, latent_sr=sr // ratio, q_first=True,
                         scale=1.0, shift=0.0),
        text_encoder=dict(model="tiny-t5", max_length=8, cfg=0.1),
        diff=dict(MID_DIFF),
    )
    if with_controlnet:
        cfg["controlnet"] = dict(MID_CONTROLNET)
        cfg["conditioner"] = dict(MID_CONDITIONER)
    ez = EzAudio(config=cfg, t5_config=T5EncoderConfig(**MID_T5), vae_config=vae_cfg,
                 dtype=dtype, device=device)
    return ez, cfg, model_cfg, vae_cfg


def encode(ez, wavs: np.ndarray) -> np.ndarray:
    """(n, T) waveforms -> (n, L, C) posterior-mean latents, ENCODE_CHUNK
    clips a call."""
    with torch.inference_mode():
        return np.concatenate([_np(ez.autoencoder.encode(wavs[i:i + ENCODE_CHUNK, :, None],
                                                         sample=False))
                               for i in range(0, len(wavs), ENCODE_CHUNK)], 0)


def roundtrip_latents(ez, lat_m: np.ndarray, mu: float, sd: float) -> np.ndarray:
    """Model-space latents -> decode -> audio -> encode -> model space, in
    chunks of ENCODE_CHUNK.  Scoring generated audio re-encodes it; the same
    round trip on the reference side keeps the comparison fair (the VAE is
    not exactly invertible)."""
    outs = []
    with torch.inference_mode():
        for i in range(0, len(lat_m), ENCODE_CHUNK):
            wav = ez.autoencoder.decode(lat_m[i:i + ENCODE_CHUNK] * sd + mu)
            outs.append(_np(ez.autoencoder.encode(wav, sample=False)))
    return (np.concatenate(outs, 0) - mu) / sd


def fit_vae(ez, steps: int = 1500, batch: int = 4, seg_s: float = 1.0,
            cache_root: Optional[str] = None):
    """:func:`fit_vae_facade` on ``ez``'s own VAE (a random decoder
    collapses to near-constant audio, which zeroes every decode -> encode
    roundtrip metric); the same cache, so every mid harness shares one
    fitted VAE per (steps, batch)."""
    return fit_vae_facade(ez.autoencoder, ez.sr, steps=steps, batch=batch, seg_s=seg_s,
                          cache_root=cache_root)


def _text(ez) -> dict:
    """The prompts' and the empty prompt's T5 embeddings and masks."""
    cond_emb, cond_mask = ez.embed_text(PROMPTS)
    unc_emb, unc_mask = ez.embed_text([""])
    return dict(cond_emb=_np(cond_emb), cond_mask=cond_mask.cpu().numpy(),
                unc_emb=_np(unc_emb), unc_mask=unc_mask.cpu().numpy())


def prepare_data(ez, frames: int, n_train: int, n_eval: int, min_readout_acc: float = 0.95,
                 cache_root: Optional[str] = None) -> dict:
    """Synthesize the 4-class distribution (peak-normalised clips: the
    editing and ControlNet surfaces peak-normalise every gt input), encode
    it through ``ez``'s VAE, normalise by the training latents' scalar mean
    and std, and set ``ez.scale = 1/sd``, ``ez.shift = -mu`` so the API's
    decode maps model-space latents back to audio.  The latents are cached
    by (frames, n_train, n_eval, VAE fingerprint); the text embeddings are
    computed at every call.  Asserts the readout gate on the eval latents."""
    from ezaudio_tpu_torch.validation.quality_validate_mid import latent_class, synth_clip

    sr = ez.sr
    ratio = sr // ez.latent_sr
    # short clips lose the AM rate's spectral resolution: 0.8 below 250 frames
    gate = min_readout_acc if frames >= 250 else 0.8
    folder = os.path.join(cache_root or default_cache_root(), "mid_data",
                          f"f{frames}_t{n_train}_e{n_eval}_"
                          f"{_vae_fingerprint(ez.autoencoder.model.state_dict())}")
    cache_npz = os.path.join(folder, "latents.npz")
    if os.path.exists(cache_npz):
        with np.load(cache_npz) as z:
            z = {k: z[k] for k in z.files}
        mu, sd = float(z["mu"]), float(z["sd"])
        ez.scale, ez.shift = 1.0 / sd, -mu
        acc_ref = float((latent_class(z["m_eval"]) == z["cls_eval"]).mean())
        print(f"[data] reusing cached latents: {folder} (readout {acc_ref:.3f})", flush=True)
        assert acc_ref >= gate, f"readout {acc_ref:.3f} < {gate}"
        return dict(m_train=z["m_train"], cls_train=z["cls_train"], m_eval=z["m_eval"],
                    cls_eval=z["cls_eval"], mu=mu, sd=sd, **_text(ez))

    def encode_clips(n, seed):
        rng = np.random.default_rng(seed)
        cls = rng.integers(0, len(PROMPTS), n)
        zs = []
        for i in range(0, n, ENCODE_CHUNK):
            wavs = np.stack([peak_wav(synth_clip(rng, int(c), frames * ratio, sr))
                             for c in cls[i:i + ENCODE_CHUNK]])
            zs.append(encode(ez, wavs))
        return np.concatenate(zs, 0), cls

    t0 = time.time()
    z_train, cls_train = encode_clips(n_train, seed=0)
    z_eval, cls_eval = encode_clips(n_eval, seed=1)
    mu = float(z_train.mean())
    sd = float(z_train.std()) + 1e-6
    # model space m = (z - mu) / sd; the API decodes z = m / scale - shift
    ez.scale, ez.shift = 1.0 / sd, -mu
    m_train = (z_train - mu) / sd
    m_eval = (z_eval - mu) / sd
    print(f"encoded {n_train}+{n_eval} clips in {time.time() - t0:.0f}s; mu {mu:.4f} "
          f"sd {sd:.4f}", flush=True)
    os.makedirs(folder, exist_ok=True)
    np.savez(cache_npz, m_train=m_train, cls_train=cls_train, m_eval=m_eval,
             cls_eval=cls_eval, mu=mu, sd=sd)
    print(f"[data] cached: {folder}", flush=True)
    acc_ref = float((latent_class(m_eval) == cls_eval).mean())
    print(f"readout accuracy on reference latents: {acc_ref:.3f}", flush=True)
    assert acc_ref >= gate, f"readout {acc_ref:.3f} < {gate}"
    return dict(m_train=m_train, cls_train=cls_train, m_eval=m_eval, cls_eval=cls_eval,
                mu=mu, sd=sd, **_text(ez))


def train_teacher(ez, model_cfg: dict, data: dict, steps: int, batch: int, lr: float = 2e-4,
                  cache_root: Optional[str] = None, tag: str = "teacher", seed: int = 0,
                  log_every: int = 500):
    """Train ``ez.dit`` on the prompt-conditioned data (AdamW, warmup 200,
    CFG dropout 0.1 to the empty prompt's embedding, batches of rows from
    ``np.random.default_rng(0)``), from the initialiser the mid harness
    trains from (``quality_validate.seeded_maskdit(model_cfg, seed)``,
    loaded into ``ez.dit``).  Cached as a ``model_io`` bundle keyed by depth,
    width, frames, steps and batch; a cached bundle is taken only when its
    model kwargs and its latent mean and std match (the key leaves out the
    number of heads, so this check keeps a teacher of another shape out).
    Returns ``ez.dit``, frozen (eval, no grad)."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.training.model_io import load_model, save_model
    from ezaudio_tpu_torch.training.optim import make_optimizer
    from ezaudio_tpu_torch.training.trainer import make_train_step
    from ezaudio_tpu_torch.validation.quality_validate import seeded_maskdit

    dit = ez.dit
    key = (f"d{model_cfg['depth']}_w{model_cfg['embed_dim']}_L{model_cfg['img_size']}"
           f"_s{steps}_b{batch}")
    folder = os.path.join(cache_root or default_cache_root(), "mid_teacher", key)
    if os.path.exists(os.path.join(folder, "params.npz")):
        with open(os.path.join(folder, "metadata.json")) as f:
            meta_all = json.load(f)
        meta = meta_all["metadata"]
        if (meta_all["kwargs"]["model"] == dict(model_cfg)
                and abs(meta.get("latent_mu", 1e9) - data["mu"]) < 1e-6
                and abs(meta.get("latent_sd", 1e9) - data["sd"]) < 1e-6):
            cached, _ = load_model(folder)
            dit.load_state_dict(cached.state_dict())
            print(f"[{tag}] reusing cached teacher: {folder}", flush=True)
            return dit.eval().requires_grad_(False)
        print(f"[{tag}] cache at {folder} does not match (arch or latent norm) - retraining",
              flush=True)

    device = next(dit.parameters()).device
    dit.load_state_dict(seeded_maskdit(model_cfg, seed, "cpu").state_dict())
    dit.train().requires_grad_(True)
    step = make_train_step(dit, DDIMSchedule.from_config(MID_DIFF),
                           make_optimizer(dit, learning_rate=lr, warmup=200), cfg_dropout=0.1)
    rng = np.random.default_rng(0)
    n_train = len(data["m_train"])
    uncond = {"uncond": torch.as_tensor(data["unc_emb"], device=device),
              "uncond_mask": torch.as_tensor(data["unc_mask"], device=device)}
    t1 = time.time()
    for i in range(steps):
        idx = rng.integers(0, n_train, batch)
        cls = data["cls_train"][idx]
        b = {"latents": torch.as_tensor(data["m_train"][idx], device=device),
             "text": torch.as_tensor(data["cond_emb"][cls], device=device),
             "text_mask": torch.as_tensor(data["cond_mask"][cls], device=device), **uncond}
        loss = step(b, seed=i)["loss"]
        if i % log_every == 0 or i == steps - 1:
            print(f"  [{tag}] step {i}: loss {float(loss):.4f} ({time.time() - t1:.0f}s)",
                  flush=True)
    dit.eval().requires_grad_(False)
    save_model(folder, "maskdit", {"model": dict(model_cfg)}, dit,
               extra_metadata={"latent_mu": data["mu"], "latent_sd": data["sd"],
                               "steps": steps})
    print(f"[{tag}] cached: {folder}", flush=True)
    return dit
