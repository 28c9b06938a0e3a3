"""Mid-scale quality validation of the acceleration recipes on a model the
port trains itself (counterpart of ``scripts/quality_validate_mid.py``).

This harness:
  * synthesizes a 4-class audio distribution at 24 kHz (class = carrier f0
    x amplitude-modulation rate, :func:`synth_clip`) and encodes it through
    the production Oobleck VAE architecture (``configs/vae.json``: x480
    downsample -> 500-frame / 128-channel latents; seeded random weights);
  * trains a MaskDiT (default depth 12 / dim 512 / 8 heads) on those
    latents;
  * scores every acceleration recipe of the JAX harness's table with the
    Frechet-distance + conditional-accuracy harness of ``quality_validate``,
    plus flow matching (``diffusion/flow.py``, a second model) and
    progressive distillation (``diffusion/distill.py``, 2 halving stages).

Sanity gate: the conditional readout (AM rate of the latent energy
envelope, :func:`latent_class`) must classify the reference latents at
>= 0.95 accuracy before any training happens, or the harness is invalid.

CLAP columns (``--clap 1``, default): every row also reports the CLAP
score (mean prompt <-> audio cosine, ``audio/clap.py::CLAPScorer``) and the
FAD over CLAP audio embeddings, on audio decoded through a briefly fitted
VAE (``mid_common.fit_vae_facade``: a random decoder makes audio-domain
metrics degenerate).  With seeded random CLAP weights the columns are
relative only; ``--clap-weights`` (a local ``laion/clap-htsat-unfused``
state dict) and ``--clap-tokenizer`` (its tokenizer directory) make them
literature-shaped.

    python -m ezaudio_tpu_torch.validation.quality_validate_mid [--depth 12] ...
    CPU smoke: --device cpu --depth 2 --dim 64 --frames 50 --train-steps 30
               --n-train 32 --n-eval 16 --eval-chunk 8 --vae-steps 5

Each ``MID_*`` knob of the JAX harness is the flag of the same name
(``MID_ROWS`` -> ``--rows``, ...).  Caches (the fitted VAE, the encoded
latents, the trained models) live under ``--cache-root`` (default
``mid_common.default_cache_root()``, outside the checkout), so a run can
be split: the teacher is reused and ``--rows`` takes a subset of the table.

Randomness (ROADMAP F1): the training batch indices come from
``np.random.default_rng(seed)`` as in JAX; the step draws, the eval noise
(JAX ``PRNGKey(7)``) and the DDIM eta noise (``PRNGKey(8)``) come from
``torch.Generator`` seeds.  :func:`run_config` takes the eval noise and a
per-step noise callable, so a test can inject JAX's draws.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.diffusion.dpm import dpm_solver_sample
from ezaudio_tpu_torch.diffusion.sampling import sample_latents, sample_latents_layer_cached
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from ezaudio_tpu_torch.training.optim import make_optimizer
from ezaudio_tpu_torch.training.trainer import StepLoop, make_train_step
from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation import mid_common
from ezaudio_tpu_torch.validation import quality_validate as qv

Lc, D = 4, 64
N_CLASS = 4
F0S = (220.0, 330.0, 440.0, 660.0)
AMS = (2.0, 4.0, 7.0, 11.0)
GUIDANCE = 3.0
LATENT_FPS = 50.0  # frames per second at x480 / 24 kHz
MIN_READOUT_ACC = 0.95  # the sanity gate
ENCODE_BATCH = 8
DIFF_CFG = qv.DIFF_CFG


# ---------------------------------------------------------------------------
# data: 4-class audio -> Oobleck latents
# ---------------------------------------------------------------------------

def synth_clip(rng, cls: int, n_samples: int, sr: int) -> np.ndarray:
    t = np.arange(n_samples) / sr
    f0, am = F0S[cls], AMS[cls]
    carrier = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
                  / k for k in range(1, 5))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * am * t + rng.uniform(0, 2 * np.pi))
    x = carrier * env + 0.003 * rng.standard_normal(n_samples)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def vae_json() -> dict:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "vae.json")
    with open(path) as f:
        return json.load(f)


def make_vae(device, vae_config: Optional[dict] = None, seed: int = 11):
    """``(facade, sample rate, downsampling ratio)``: the VAE of
    ``vae_config`` (``vae.json``) with the port's seeded init
    (``api.ezaudio.init_random_``, drawn on the CPU from ``seed``)."""
    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import vae_from_config

    cfg = vae_config or vae_json()
    model = vae_from_config(cfg)
    init_random_(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval().requires_grad_(False)
    return AutoencoderFacade(model), cfg["sample_rate"], model.downsampling_ratio


def encode_dataset(n_clips: int, seed: int, facade, sr: int, ratio: int, frames: int = 500):
    """(n, frames, C) latents (the posterior mean) + class labels through
    ``facade``, in batches of ``ENCODE_BATCH`` clips."""
    n_samples = frames * ratio
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, N_CLASS, n_clips)
    lats = []
    eb = max(1, min(ENCODE_BATCH, n_clips))
    for i in range(0, n_clips, eb):
        wavs = np.stack([synth_clip(rng, int(c), n_samples, sr) for c in cls[i:i + eb]])
        z = facade.encode(wavs[:, :, None], sample=False)
        lats.append(z.float().cpu().numpy())
    return np.concatenate(lats, axis=0), cls


def _crc_tokenizer(cfg, max_len: int = 16):
    """Deterministic host-side stand-in tokenizer (crc32 word hash onto the
    RoBERTa id space, bos=0/eos=2/pad=1 framing).  With random CLAP weights
    any injective tokenization is equivalent; ``--clap-tokenizer`` gives the
    real RoBERTa BPE for published weights."""
    def tok(texts):
        ids = np.full((len(texts), max_len), cfg.text.pad_token_id, np.int64)
        am = np.zeros((len(texts), max_len), np.int64)
        for i, t in enumerate(texts):
            body = [5 + zlib.crc32(w.encode()) % (cfg.text.vocab_size - 10)
                    for w in t.lower().split()][: max_len - 2]
            toks = [0] + body + [2]
            ids[i, : len(toks)] = toks
            am[i, : len(toks)] = 1
        return ids, am

    return tok


def make_clap_scorer(weights_path: Optional[str] = None, tokenizer_dir: Optional[str] = None,
                     device=None, cfg=None):
    """``(CLAPScorer, has_weights)``: seeded random weights unless
    ``weights_path`` (a transformers-format state dict, ``torch.load``);
    ``tokenizer_dir`` imports ``transformers`` for its tokenizer, else the
    crc32 stand-in."""
    from ezaudio_tpu_torch.audio.clap import CLAPScorer

    weights = None
    if weights_path:
        weights = torch.load(weights_path, map_location="cpu")
        if hasattr(weights, "state_dict"):
            weights = weights.state_dict()
    scorer = CLAPScorer(cfg, weights=weights, device=device)
    if tokenizer_dir:
        from transformers import AutoTokenizer

        hf_tok = AutoTokenizer.from_pretrained(tokenizer_dir)

        def tok(texts):
            enc = hf_tok(list(texts), padding=True, return_tensors="np")
            return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

        scorer.tokenizer = tok
    else:
        scorer.tokenizer = _crc_tokenizer(scorer.cfg)
    return scorer, weights is not None


def class_text(cls: np.ndarray) -> np.ndarray:
    txt = np.zeros((len(cls), Lc, D), np.float32)
    txt[np.arange(len(cls)), :, cls] = 1.0
    return txt


def latent_class(lat: np.ndarray) -> np.ndarray:
    """Readout: AM rate of the per-frame energy envelope -> class."""
    lat = np.asarray(lat, np.float32)
    e = (lat ** 2).mean(-1)
    e = e - e.mean(1, keepdims=True)
    spec = np.abs(np.fft.rfft(e, axis=1))
    seconds = lat.shape[1] / LATENT_FPS
    bins = [int(round(am * seconds)) for am in AMS]
    # each class scores the energy in a +-1-bin window around its AM line
    scores = np.stack([spec[:, max(b - 1, 1): b + 2].max(1) for b in bins], axis=1)
    return scores.argmax(1)


def features(lat: np.ndarray) -> np.ndarray:
    """Per-sample embedding for the Frechet distance: channel stats +
    energy-envelope spectrum bands."""
    lat = np.asarray(lat, np.float32)
    mean = lat.mean(1)
    std = lat.std(1)
    e = (lat ** 2).mean(-1)
    e = e - e.mean(1, keepdims=True)
    spec = np.abs(np.fft.rfft(e, axis=1))
    nb = 16
    edges = np.linspace(1, spec.shape[1], nb + 1).astype(int)
    bands = np.stack([spec[:, a:b].mean(1) for a, b in zip(edges[:-1], edges[1:])], axis=1)
    return np.concatenate([mean, std, bands], axis=1)


def sanity_gate(lat_eval, cls_eval) -> float:
    """The readout's accuracy on the reference latents; raises below
    ``MIN_READOUT_ACC``."""
    acc = float((latent_class(lat_eval) == cls_eval).mean())
    print(f"readout accuracy on reference latents: {acc:.3f}", flush=True)
    assert acc >= MIN_READOUT_ACC, (
        f"conditional readout cannot classify the reference latents ({acc:.3f} < "
        f"{MIN_READOUT_ACC}): harness invalid at this geometry")
    return acc


def model_config(depth, dim, heads, frames, channels, remat) -> dict:
    return dict(
        mae=False, mae_prob=0.0, mask_ratio=[0.25, 1.0], mask_span=4,
        img_size=frames, patch_size=1, in_chans=channels, out_chans=channels,
        input_type="1d", embed_dim=dim, depth=depth, num_heads=heads,
        mlp_ratio=4.0, qkv_bias=False, qk_scale=None, qk_norm="layernorm",
        norm_layer="layernorm", act_layer="geglu", context_norm=True,
        use_checkpoint=remat, time_fusion="ada_sola_bias",
        ada_sola_rank=32, ada_sola_alpha=32, cls_dim=None,
        context_dim=D, context_fusion="cross", context_max_length=None,
        context_pe_method="none", pe_method="none", rope_mode="shared",
        use_conv=True, skip=True, skip_norm=True,
    )


# ---------------------------------------------------------------------------
# the rows: builder(model, noise_c, ctx, step_noise) -> latents of one chunk
# ---------------------------------------------------------------------------

def apply_base(model, lat, t, ctx_pair, **kw):
    return model(lat, t, ctx_pair[:lat.shape[0]], **kw)[0]


def _eta_noise(noise_c, step_noise):
    """The DDIM eta noise of one chunk: ``step_noise(i, shape)`` when
    injected, else a generator seeded as JAX's ``PRNGKey(8)`` (every chunk
    draws the same)."""
    if step_noise is not None:
        return dict(generator=None, step_noise=lambda i: step_noise(i, tuple(noise_c.shape)))
    return dict(generator=qv.step_generator(noise_c.device), step_noise=None)


def ddim(sched, steps, interval=None):
    def builder(model, noise_c, ctx_pair, step_noise=None):
        return sample_latents(lambda lat, t: apply_base(model, lat, t, ctx_pair), sched,
                              noise_c, steps, guidance_scale=GUIDANCE, guidance_rescale=0.0,
                              eta=1.0, guidance_interval=interval,
                              **_eta_noise(noise_c, step_noise))
    return builder


def dpm(sched, steps, layer_cache=None, interval=None, cfg_refresh=1):
    def builder(model, noise_c, ctx_pair, step_noise=None):
        kw = {}
        if layer_cache is not None:
            k, m = layer_cache
            kw = dict(layer_cache_fns=(
                lambda lat, t: apply_base(model, lat, t, ctx_pair, collect_deep_k=k),
                lambda lat, t, deep: apply_base(model, lat, t, ctx_pair, deep_cache=(k, deep))),
                cache_interval=m)
        return dpm_solver_sample(lambda lat, t: apply_base(model, lat, t, ctx_pair), sched,
                                 noise_c, steps, guidance_scale=GUIDANCE,
                                 guidance_interval=interval, cfg_refresh_interval=cfg_refresh,
                                 **kw)
    return builder


def ddim_lc(sched, steps, k, m):
    def builder(model, noise_c, ctx_pair, step_noise=None):
        return sample_latents_layer_cached(
            lambda lat, t: apply_base(model, lat, t, ctx_pair, collect_deep_k=k),
            lambda lat, t, deep: apply_base(model, lat, t, ctx_pair, deep_cache=(k, deep)),
            sched, noise_c, steps, cache_interval=m, guidance_scale=GUIDANCE,
            **_eta_noise(noise_c, step_noise))
    return builder


def row_configs(sched, depth: int) -> list:
    """The JAX harness's table, ``(name, builder, recipe)`` in its order."""
    half = depth // 2
    k_lc = min(2, half - 1)
    bf16_int8 = {"quant_int8": True, "attn_impl": "chunked_bf16"}
    configs = [
        ("DDIM-100 (reference default)", ddim(sched, 100), {}),
        ("DDIM-50", ddim(sched, 50), {}),
        ("DPM-Solver++(2M)-25", dpm(sched, 25), {}),
        ("DPM-Solver++(2M)-10", dpm(sched, 10), {}),
        ("DDIM-100 + interval(100,900)", ddim(sched, 100, (100, 900)), {}),
        ("DDIM-100 + interval(300,800)", ddim(sched, 100, (300, 800)), {}),
        ("DDIM-100 int8 (all linears)", ddim(sched, 100), {"quant_int8": True}),
        # bf16 softmax sits in the quality path: a recommended default only
        # if this row holds FAD
        ("DDIM-100 attn=chunked_bf16", ddim(sched, 100), {"attn_impl": "chunked_bf16"}),
    ]
    if k_lc >= 1:  # layer caching needs half >= 2
        lc = (k_lc, 2)
        configs += [
            (f"DDIM-100 + layer_cache(k={k_lc},m=2)", ddim_lc(sched, 100, k_lc, 2), {}),
            (f"DDIM-100 + layer_cache(k={k_lc},m=4)", ddim_lc(sched, 100, k_lc, 4), {}),
            (f"DPM-25 + layer_cache(k={k_lc},m=2) (36x recipe)", dpm(sched, 25, lc), {}),
            # the bench fast recipe: all three approximations composed
            (f"DPM-25 + lc({k_lc},2) + chunked_bf16 (bench fast recipe)", dpm(sched, 25, lc),
             {"attn_impl": "chunked_bf16"}),
            (f"DPM-25 + lc({k_lc},2) + chunked_bf16 + int8 (max recipe)", dpm(sched, 25, lc),
             bf16_int8),
            # guidance_interval composed into the fast recipe (the band rounds
            # outward to cache groups): CFG only in-band
            ("DPM-25 + interval(300,800)", dpm(sched, 25, interval=(300, 800)), {}),
            (f"DPM-25 + lc({k_lc},2) + interval(300,800)",
             dpm(sched, 25, lc, interval=(300, 800)), {}),
            (f"DPM-25 + lc({k_lc},2) + gi(300,800) + chunked_bf16 + int8 (max+gi recipe)",
             dpm(sched, 25, lc, interval=(300, 800)), bf16_int8),
            # whether gi's headroom buys fewer steps, and the band's edges
            (f"DPM-20 + lc({k_lc},2) + gi(300,800) + bf16 + int8 (explore20)",
             dpm(sched, 20, lc, interval=(300, 800)), bf16_int8),
            (f"DPM-15 + lc({k_lc},2) + gi(300,800) + bf16 + int8 (explore15)",
             dpm(sched, 15, lc, interval=(300, 800)), bf16_int8),
            (f"DPM-25 + lc({k_lc},2) + gi(200,800) + bf16 + int8 (band200)",
             dpm(sched, 25, lc, interval=(200, 800)), bf16_int8),
            (f"DPM-25 + lc({k_lc},2) + gi(300,900) + bf16 + int8 (band900)",
             dpm(sched, 25, lc, interval=(300, 900)), bf16_int8),
            (f"DPM-25 + lc({k_lc},2) + gi(400,700) + bf16 + int8 (band47)",
             dpm(sched, 25, lc, interval=(400, 700)), bf16_int8),
            # cfg_refresh: uncond recomputed every P-th in-band cache group,
            # delta reuse between; with and without gi
            (f"DPM-25 + lc({k_lc},2) + gi(300,800) + cfgr2 (delta-reuse)",
             dpm(sched, 25, lc, interval=(300, 800), cfg_refresh=2), {}),
            (f"DPM-25 + lc({k_lc},2) + gi(300,800) + cfgr3 (delta-reuse)",
             dpm(sched, 25, lc, interval=(300, 800), cfg_refresh=3), {}),
            (f"DPM-25 + lc({k_lc},2) + gi(300,800) + cfgr2 + bf16 + int8 (max+gi+cfgr2)",
             dpm(sched, 25, lc, interval=(300, 800), cfg_refresh=2), bf16_int8),
            (f"DPM-25 + lc({k_lc},2) + cfgr2 (no gi)", dpm(sched, 25, lc, cfg_refresh=2), {}),
            (f"DPM-25 + lc({k_lc},2) + cfgr3 (no gi)", dpm(sched, 25, lc, cfg_refresh=3), {}),
            (f"DPM-25 + lc({k_lc},2) + cfgr2 + bf16 + int8 (max+cfgr2, no gi)",
             dpm(sched, 25, lc, cfg_refresh=2), bf16_int8),
        ]
    return configs


def filter_rows(configs: list, rows: Optional[str]) -> list:
    """``rows="substr1,substr2"``: only the rows whose name contains one of
    the substrings (case-insensitive)."""
    if not rows:
        return configs
    pats = [p.strip().lower() for p in rows.split(",") if p.strip()]
    return [c for c in configs if any(p in c[0].lower() for p in pats)]


def run_config(model, builder, noise_all, txt_eval, chunk: int, quant_int8: bool = False,
               attn_impl: Optional[str] = None, step_noise: Optional[Callable] = None,
               pair: bool = True) -> np.ndarray:
    """``builder`` mapped over the eval chunks of ``chunk`` samples:
    ``noise_all`` (N, L, C) and ``txt_eval`` (N, Lc, D) tensors; the context
    of a chunk is its CFG pair ``[txt; 0]`` (``pair``) or its text alone.
    ``quant_int8`` quantizes every linear (``MIN_QUANT_ELEMENTS`` 0);
    ``attn_impl`` names the attention implementation of the whole row."""
    outs = []
    with qv.recipe_context(quant_int8, attn_impl):
        for i in range(0, len(noise_all), chunk):
            noise_c, txt_c = noise_all[i:i + chunk], txt_eval[i:i + chunk]
            ctx = torch.cat([txt_c, torch.zeros_like(txt_c)], 0) if pair else txt_c
            outs.append(builder(model, noise_c, ctx, step_noise).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def flow_builder(steps):
    from ezaudio_tpu_torch.diffusion.flow import FlowSchedule, flow_sample

    def builder(model, noise_c, ctx_pair, step_noise=None):
        def model_fn(x, t):
            return model(x, t.expand(x.shape[0]), ctx_pair[:x.shape[0]])[0]
        return flow_sample(model_fn, FlowSchedule(), noise_c, steps, guidance_scale=GUIDANCE)
    return builder


def distilled_builder(sched, n_student):
    from ezaudio_tpu_torch.diffusion.distill import distill_tables, distilled_sample

    tables = distill_tables(sched, n_student)

    def builder(model, noise_c, txt_c, step_noise=None):
        def student_fn(x, t):
            t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
            return model(x, t, txt_c[:x.shape[0]])[0]
        return distilled_sample(student_fn, sched, noise_c, tables)
    return builder


class FlowStep(StepLoop):
    """One flow-matching train step (the JAX harness's ``_step``): CFG
    dropout 0.1 to a zero context, noise and a uniform ``t`` drawn per
    step, ``flow_matching_loss`` on the model's MAE-free mask."""

    def __init__(self, model, optimizer):
        from ezaudio_tpu_torch.diffusion.flow import FlowSchedule

        self.model, self.optimizer, self.params = model, optimizer, optimizer.params
        self.fsched, self.dtype, self.step = FlowSchedule(), torch.float32, 0

    def draw(self, generator, batch):
        x0 = batch["latents"]
        B, dev = x0.shape[0], x0.device
        return dict(t=torch.rand(B, generator=generator, device=dev),
                    noise=torch.randn(x0.shape, generator=generator, device=dev),
                    cfg=torch.rand(B, generator=generator, device=dev))

    def loss(self, batch, draws):
        from ezaudio_tpu_torch.diffusion.flow import flow_matching_loss

        text = batch["text"]
        text = torch.where((draws["cfg"] < 0.1)[:, None, None], torch.zeros_like(text), text)
        return flow_matching_loss(lambda xt, tt: self.model(xt, tt, text), batch["latents"],
                                  draws["noise"], draws["t"], schedule=self.fsched)


# ---------------------------------------------------------------------------

class MidHarness:
    """The harness's state: the VAE, the data, the models, the scored rows
    and each stage's wall.  ``main`` runs it end to end; each stage is a
    method so a caller (phase 34 of chip_smoke.py) can run a cut of it."""

    def __init__(self, args, device, vae_config: Optional[dict] = None, clap_config=None):
        self.args, self.device = args, torch.device(device)
        self.facade, self.sr, self.ratio = make_vae(self.device, vae_config)
        self.C = self.facade.latent_channels
        self.model_cfg = model_config(args.depth, args.dim, args.heads, args.frames, self.C,
                                      args.remat)
        self.sched = DDIMSchedule.from_config(DIFF_CFG)
        self.cache_root = args.cache_root or mid_common.default_cache_root()
        self.clap_config = clap_config
        self.clap = None
        self.rows, self.walls = [], {"rows_s": {}}

    # -- data ---------------------------------------------------------------
    def fit_vae(self):
        t0 = time.time()
        walls = mid_common.fit_vae_facade(self.facade, self.sr, steps=self.args.vae_steps,
                                          batch=4, cache_root=self.cache_root)
        self.walls["vae_fit_s"] = time.time() - t0
        if walls:
            self.walls["vae_fit_s_per_step"] = float(np.median(walls))

    def fingerprint(self) -> str:
        return mid_common._vae_fingerprint(self.facade.model.state_dict())

    def encode(self):
        a = self.args
        t0 = time.time()
        enc_cache = os.path.join(self.cache_root, "qv_latents",
                                 f"f{a.frames}_t{a.n_train}_e{a.n_eval}_{self.fingerprint()}.npz")
        if a.cache and os.path.exists(enc_cache):
            z = dict(np.load(enc_cache))
            lat_train, cls_train = z["lat_train"], z["cls_train"]
            lat_eval, cls_eval = z["lat_eval"], z["cls_eval"]
            print(f"[data] reusing cached latents: {enc_cache}", flush=True)
        else:
            lat_train, cls_train = encode_dataset(a.n_train, 0, self.facade, self.sr,
                                                  self.ratio, a.frames)
            lat_eval, cls_eval = encode_dataset(a.n_eval, 1, self.facade, self.sr,
                                                self.ratio, a.frames)
            if a.cache:
                os.makedirs(os.path.dirname(enc_cache), exist_ok=True)
                np.savez(enc_cache, lat_train=lat_train, cls_train=cls_train,
                         lat_eval=lat_eval, cls_eval=cls_eval)
        self.mu = lat_train.mean((0, 1), keepdims=True)
        self.sd = lat_train.std((0, 1), keepdims=True) + 1e-6
        self.lat_train, self.cls_train = (lat_train - self.mu) / self.sd, cls_train
        self.lat_eval, self.cls_eval = (lat_eval - self.mu) / self.sd, cls_eval
        self.walls["encode_s"] = time.time() - t0
        print(f"encoded {a.n_train}+{a.n_eval} clips in {self.walls['encode_s']:.0f}s; "
              f"latent std pre-norm {float(self.sd.mean()):.4f}", flush=True)

    def gate(self) -> float:
        return sanity_gate(self.lat_eval, self.cls_eval)

    # -- training -----------------------------------------------------------
    def cache_key(self, loss_kind: str, steps: int, seed: int) -> str:
        a = self.args
        return (f"{loss_kind}_d{a.depth}_w{a.dim}_h{a.heads}_L{a.frames}_s{steps}_b{a.batch}"
                f"_n{a.n_train}_lr{a.lr:g}_seed{seed}_{self.device.type}"
                + (f"_mu{a.mu_dtype}" if a.mu_dtype else "")
                # the data depends on the (possibly fitted) VAE
                + f"_v{self.fingerprint()}")

    def new_model(self, seed: int):
        return qv.seeded_maskdit(self.model_cfg, seed, self.device)

    def train(self, loss_kind: str, steps: int, seed: int, log_every: int = 500):
        """A fresh model trained with ``loss_kind`` ('diffusion' | 'flow');
        cached under ``cache_key`` (``--cache 0`` disables)."""
        a = self.args
        key = self.cache_key(loss_kind, steps, seed)
        folder = os.path.join(a.cache_dir or os.path.join(self.cache_root, "qv_cache"), key)
        model = self.new_model(seed)
        if a.cache and os.path.exists(os.path.join(folder, "params.npz")):
            params, _ = mid_common._load_params(folder)
            model.load_state_dict(params, strict=True)
            print(f"  [{loss_kind}] reusing cached params: {folder}", flush=True)
            return model.eval().requires_grad_(False)
        model.train().requires_grad_(True)
        # mu_dtype=bfloat16 halves the first moment's memory
        opt = make_optimizer(model, learning_rate=a.lr, warmup=200, mu_dtype=a.mu_dtype or None)
        step = (make_train_step(model, self.sched, opt, cfg_dropout=0.1)
                if loss_kind == "diffusion" else FlowStep(model, opt))
        rng = np.random.default_rng(seed)
        uncond = torch.zeros(1, Lc, D, device=self.device)
        ones = torch.ones(a.batch, Lc, dtype=torch.bool, device=self.device)
        t1, walls = time.time(), []
        for i in range(steps):
            idx = rng.integers(0, a.n_train, a.batch)
            batch = {"latents": torch.as_tensor(self.lat_train[idx], device=self.device),
                     "text": torch.as_tensor(class_text(self.cls_train[idx]), device=self.device),
                     "text_mask": ones, "uncond": uncond, "uncond_mask": ones[:1]}
            ts = time.perf_counter()
            loss = step(batch, seed=i)["loss"]
            if i % log_every == 0 or i == steps - 1:
                print(f"  [{loss_kind}] step {i}: loss {float(loss):.4f} "
                      f"({time.time() - t1:.0f}s)", flush=True)
            qv.sync(self.device)
            walls.append(time.perf_counter() - ts)
        self.walls[f"train_{loss_kind}_s_per_step"] = float(np.median(walls[1:] or walls))
        model.eval().requires_grad_(False)
        if a.cache:
            mid_common._save_params(folder, model.state_dict(), {"key": key, "steps": steps})
            print(f"  [{loss_kind}] cached: {folder}", flush=True)
        return model

    # -- evaluation ---------------------------------------------------------
    def eval_inputs(self):
        noise_all = qv.eval_noise((self.args.n_eval, self.args.frames, self.C), self.device)
        txt_eval = torch.as_tensor(class_text(self.cls_eval), device=self.device)
        return noise_all, txt_eval

    def configs(self) -> list:
        return filter_rows(row_configs(self.sched, self.args.depth), self.args.rows)

    def run(self, model, builder, pair: bool = True, step_noise=None, **recipe) -> np.ndarray:
        noise_all, txt_eval = self.eval_inputs()
        return run_config(model, builder, noise_all, txt_eval, self.args.eval_chunk,
                          step_noise=step_noise, pair=pair, **recipe)

    def decode_wavs(self, lat_m) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            for i in range(0, len(lat_m), ENCODE_BATCH):
                z = torch.as_tensor(lat_m[i:i + ENCODE_BATCH] * self.sd + self.mu,
                                    device=self.device)
                w = self.facade.decode(z).float().cpu().numpy()
                outs.append(w[..., 0] if w.ndim == 3 else w)
        return np.concatenate(outs, 0)

    def clap_embed(self, lat_m) -> np.ndarray:
        wavs = self.decode_wavs(lat_m)
        return np.concatenate([self.scorer.embed_audio(wavs[i:i + 8], self.sr).float().cpu()
                               .numpy() for i in range(0, len(wavs), 8)], 0)

    def setup_clap(self):
        self.scorer, has_weights = make_clap_scorer(self.args.clap_weights,
                                                    self.args.clap_tokenizer, self.device,
                                                    self.clap_config)
        if not has_weights:
            print("[clap] random-init CLAP weights: CLAP columns are RELATIVE-only "
                  "(recipe-vs-anchor ordering within this table; the audio tower still acts "
                  "as a fixed random projection, so CLAP-FAD is a valid distance) - NOT "
                  "literature-comparable absolute scores; set --clap-weights + "
                  "--clap-tokenizer for those", flush=True)
        t0 = time.time()
        clap_ref = self.clap_embed(self.lat_eval)
        text_emb = self.scorer.embed_text(mid_common.PROMPTS).float().cpu().numpy()
        self.clap = (text_emb, clap_ref)
        print(f"[clap] reference audio embeddings + text embeddings in "
              f"{time.time() - t0:.0f}s", flush=True)

    def header(self):
        if self.clap is not None:
            print("\n| sampler | FAD (latent feats) vs data | cond. class acc | CLAP score "
                  "| CLAP-FAD | s |")
            print("|---|---|---|---|---|---|", flush=True)
        else:
            print("\n| sampler | FAD (latent feats) vs data | cond. class acc | s |")
            print("|---|---|---|---|", flush=True)

    def score(self, name, out, seconds: float = float("nan")):
        fad = frechet_audio_distance(features(out), features(self.lat_eval))
        acc = float((latent_class(out) == self.cls_eval).mean())
        self.walls["rows_s"][name] = seconds
        if self.clap is not None:
            text_emb, clap_ref = self.clap
            emb = self.clap_embed(out)
            cscore = float((emb * text_emb[self.cls_eval]).sum(-1).mean())
            cfad = frechet_audio_distance(emb, clap_ref)
            self.rows.append((name, fad, acc, cscore, cfad))
            print(f"| {name} | {fad:.3f} | {acc:.2f} | {cscore:.4f} | {cfad:.4f} | "
                  f"{seconds:.1f} |", flush=True)
        else:
            self.rows.append((name, fad, acc))
            print(f"| {name} | {fad:.3f} | {acc:.2f} | {seconds:.1f} |", flush=True)

    def timed_row(self, name, model, builder, **kw) -> np.ndarray:
        t0 = time.time()
        out = self.run(model, builder, **kw)
        qv.sync(self.device)
        self.score(name, out, time.time() - t0)
        return out

    def flow_rows(self):
        flow = self.train("flow", self.args.train_steps, seed=100)
        for steps in (50, 25):
            self.timed_row(f"flow-matching Euler-{steps} + CFG", flow, flow_builder(steps))
        del flow

    def distill_rows(self, teacher):
        from ezaudio_tpu_torch.validation.distill_validate import distill_stages

        a, rng = self.args, np.random.default_rng(7)

        def batches():
            idx = rng.integers(0, a.n_train, a.batch)
            return {"latents": torch.as_tensor(self.lat_train[idx], device=self.device),
                    "text": torch.as_tensor(class_text(self.cls_train[idx]),
                                            device=self.device)}

        t0 = time.time()
        students = distill_stages(teacher, self.sched, a.distill_steps, batches, 50_000,
                                  GUIDANCE, log_every=500)
        self.walls["distill_s"] = time.time() - t0
        for n in (8, 4):
            self.timed_row(f"distilled-{n} (no CFG pair)", students[n],
                           distilled_builder(self.sched, n), pair=False)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m ezaudio_tpu_torch.validation.quality_validate_mid",
        description="Each flag is the JAX harness's MID_* knob of the same name.")
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--train-steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--n-eval", type=int, default=128)
    p.add_argument("--eval-chunk", type=int, default=32)
    p.add_argument("--flow", type=int, default=1, choices=(0, 1))
    p.add_argument("--distill", type=int, default=1, choices=(0, 1))
    p.add_argument("--distill-steps", type=int, default=1500)
    p.add_argument("--remat", type=int, default=None, choices=(0, 1),
                   help="per-block remat (default: on from depth 16)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--clap", type=int, default=1, choices=(0, 1))
    p.add_argument("--vae-steps", type=int, default=1500)
    p.add_argument("--rows", default=None,
                   help="comma-separated substrings: only the table rows containing one")
    p.add_argument("--cache", type=int, default=1, choices=(0, 1))
    p.add_argument("--cache-dir", default=None, help="the trained models' cache")
    p.add_argument("--mu-dtype", default=None, help="bfloat16: AdamW's first moment in bf16")
    p.add_argument("--clap-weights", default=None)
    p.add_argument("--clap-tokenizer", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--cache-root", default=None,
                   help="caches (default: outside the checkout, mid_common.default_cache_root)")
    args = p.parse_args(argv)
    if args.remat is None:
        args.remat = args.depth >= 16
    args.remat = bool(args.remat)
    return args


def main(argv=None, *, vae_config: Optional[dict] = None, clap_config=None):
    """Run the harness; ``vae_config`` and ``clap_config`` replace
    ``vae.json`` and the CLAP widths (tests run tiny ones).  Returns the
    scored rows and the stage walls."""
    a = parse_args(argv)
    device = resolve_device(a.device)
    h = MidHarness(a, device, vae_config, clap_config)
    print(qv.precision_line(device), flush=True)
    print(f"mid-scale harness: depth {a.depth} dim {a.dim} heads {a.heads} L={a.frames} "
          f"C={h.C}; {a.train_steps} steps batch {a.batch}; {a.n_train}+{a.n_eval} clips "
          f"through the Oobleck VAE", flush=True)
    if a.clap:
        # audio-domain CLAP rows need a non-degenerate decoder
        h.fit_vae()
    h.encode()
    h.gate()
    with torch.device("meta"):
        n_params = sum(p.numel() for p in maskdit_from_config(h.model_cfg).parameters())
    print(f"mid MaskDiT: {n_params / 1e6:.1f}M params", flush=True)
    diff = h.train("diffusion", a.train_steps, seed=0)
    configs = h.configs()
    if a.clap:
        h.setup_clap()
    h.header()
    for name, builder, recipe in configs:
        h.timed_row(name, diff, builder, **recipe)
    if a.flow:
        h.flow_rows()
    if a.distill:
        h.distill_rows(diff)
    print("\nsummary rows:", len(h.rows))
    print("stage walls " + json.dumps(h.walls), flush=True)
    return h.rows, h.walls


if __name__ == "__main__":
    main()
