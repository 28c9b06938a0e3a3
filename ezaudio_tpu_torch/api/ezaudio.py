"""EzAudio: the end-user facade (counterpart of
``ezaudio_tpu/api/ezaudio.py::EzAudio``), staged path.

  * ``generate_audio(text, length=10, guidance_scale=5, guidance_rescale=0.75,
    ddim_steps=100, eta=1, random_seed=None, sampler='ddim', ...)`` ->
    (sr, waveform): HashTokenizer/tokenizer.json ids -> T5 -> CFG-paired
    sampler over MaskDiT -> ``scale_shift_re`` -> Oobleck decode in chunks
    of up to 4 clips.  ``text`` may be a list (waveform (B, T)); an
    all-empty batch turns guidance off.  Samplers: ``'ddim'``, ``'dpm'``
    (DPM-Solver++(2M)), ``'distilled'`` (a distilled student, no CFG);
    ``guidance_interval``, ``layer_cache`` and ``cfg_refresh`` as in the
    JAX package;
  * ``editing_audio(text, boundary, gt_file, mask_start, mask_length, ...)``:
    mask-based inpainting/outpainting of a clip with boundary windowing;
  * ``generate_long(text, length, window=10, overlap=2, ...)``: chained
    outpainting past the training window.

Runs on CUDA unless ``device="cpu"`` is passed; with no GPU and no device
it raises.  Weights are random, drawn from ``seed``: loading the published
checkpoints waits for those files.  ``fused``, ``quant``, ``attn_impl`` and
``mesh`` raise ``NotImplementedError``.  Every random draw goes through
``utils.randn`` (ROADMAP F1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
from ezaudio_tpu_torch.config import ConfigDict, MODEL_REGISTRY, load_config
from ezaudio_tpu_torch.data.audio_io import load_wav, peak_normalize
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.diffusion.distill import distill_tables, distilled_sample
from ezaudio_tpu_torch.diffusion.dpm import dpm_solver_sample
from ezaudio_tpu_torch.diffusion.sampling import sample_latents, sample_latents_layer_cached
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from ezaudio_tpu_torch.ops.norms import LayerNorm, RMSNorm
from ezaudio_tpu_torch.text.t5 import T5Encoder, T5EncoderConfig, T5LayerNorm
from ezaudio_tpu_torch.text.tokenizer import get_tokenizer
from ezaudio_tpu_torch.utils import resolve_device, scale_shift_re

MAX_SEED = np.iinfo(np.int32).max

_T5_CONFIGS = {
    "google/flan-t5-large": T5EncoderConfig.flan_t5_large,
    "google/flan-t5-xl": T5EncoderConfig.flan_t5_xl,
}
_NORMS = (LayerNorm, RMSNorm, T5LayerNorm)
SAMPLERS = ("ddim", "dpm", "distilled")


def _refuse(**args):
    """Raise for the arguments whose items are not ported yet."""
    named = [k for k, on in args.items() if on]
    if named:
        raise NotImplementedError(f"not ported yet: {', '.join(named)}")


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, by the JAX package's init rules: convs take
    torch's default U(+-1/sqrt(fan_in)) (weight and bias), every other
    matrix xavier-uniform, every other vector N(0, 0.02); norms stay (1, 0)."""
    done = set()
    for m in module.modules():
        if isinstance(m, _NORMS):
            done.update(id(p) for p in m.parameters())
        elif isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight.shape[1] * m.weight.shape[2])  # torch fan_in
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
                done.add(id(p))
    for p in module.parameters():
        if id(p) in done:
            continue
        if p.ndim >= 2:
            fan_out, fan_in = p.shape[0], p[0].numel()
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-bound, bound, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return module


class EzAudio:
    def __init__(
        self,
        model_name: str = "s3_l",
        config: Optional[dict] = None,
        config_path: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        vae_path: Optional[str] = None,
        t5_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        t5_config: Optional[T5EncoderConfig] = None,
        vae_config: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
        mesh=None,
    ):
        if ckpt_path or vae_path or t5_path:
            raise NotImplementedError(
                "loading the published checkpoints is not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device inference) is not ported yet")
        if dtype != torch.float32:
            raise NotImplementedError("only float32 inference is ported")
        self.device = resolve_device(device)
        self.dtype = dtype
        if config is not None:
            cfg = ConfigDict.wrap(config)
        else:
            cfg = load_config(config_path or MODEL_REGISTRY[model_name]["config"])
        self.params_cfg = cfg
        self.sr = cfg.autoencoder.sr
        self.latent_sr = cfg.autoencoder.latent_sr
        self.latent_dim = cfg.autoencoder.dim
        self.scale = cfg.autoencoder.get("scale", 1.0)
        self.shift = cfg.autoencoder.get("shift", 0.0)

        if t5_config is not None:
            self.t5_cfg = t5_config
        elif cfg.text_encoder.model in _T5_CONFIGS:
            self.t5_cfg = _T5_CONFIGS[cfg.text_encoder.model]()
        else:
            self.t5_cfg = T5EncoderConfig(d_model=cfg.model.context_dim)
        if self.t5_cfg.d_model != cfg.model.context_dim:
            raise ValueError("text encoder width must match model context_dim")
        vae_cfg = vae_config if vae_config is not None else load_config(
            MODEL_REGISTRY["vae"]["config"]).to_dict()

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.device(self.device):
            self.dit = maskdit_from_config(cfg.model.to_dict())
            vae = vae_from_config(vae_cfg)
            self.t5 = T5Encoder(self.t5_cfg)
        for m in (self.dit, vae, self.t5):
            init_random_(m, gen).eval().requires_grad_(False)
        self.autoencoder = AutoencoderFacade(
            vae, quantization_first=cfg.autoencoder.get("q_first", True))
        self.max_length = cfg.text_encoder.max_length
        self.tokenizer = get_tokenizer(tokenizer_path, self.t5_cfg.vocab_size)
        self.noise_scheduler = DDIMSchedule.from_config(cfg.diff)
        self._uncond = {}

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def embed_text(self, texts: Sequence[str]):
        ids, mask = self.tokenizer(list(texts), max_length=self.max_length)
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        return self.t5(ids, mask), mask

    def _uncond_embedding(self, batch: int):
        """Cached empty-prompt embedding (the CFG uncond branch)."""
        if batch not in self._uncond:
            if len(self._uncond) >= 8:
                self._uncond.clear()
            self._uncond[batch] = self.embed_text([""] * batch)
        return self._uncond[batch]

    @torch.inference_mode()
    def _generate_latents(self, texts, frames, guidance_scale, guidance_rescale,
                          ddim_steps, eta, random_seed, initial_latents=None, gt=None,
                          gt_mask=None, guidance_interval=None, sampler="ddim",
                          layer_cache=None, cfg_refresh=1):
        """Sampled latents (B, frames, C).  ``gt`` (B, frames, C) and
        ``gt_mask`` (B, frames, 1) condition MaskDiT for editing; their rows
        repeat across the CFG pair."""
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        B = len(texts)
        if random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)
        gen = torch.Generator(device=self.device).manual_seed(int(random_seed))
        cond, cond_mask = self.embed_text(texts)
        if guidance_scale:
            uncond, uncond_mask = self._uncond_embedding(B)
            ctx = torch.cat([cond, uncond], dim=0)
            cmask = torch.cat([cond_mask, uncond_mask], dim=0)
        else:
            guidance_scale = None
            ctx, cmask = cond, cond_mask
        shape = (B, frames, self.latent_dim)
        if initial_latents is not None:
            noise = torch.as_tensor(initial_latents, dtype=self.dtype, device=self.device)
            if noise.shape != shape:
                raise ValueError(f"initial_latents {tuple(noise.shape)}, expected {shape}")
        else:
            noise = utils.randn(shape, gen, self.device, self.dtype)
        if gt is not None:
            gt = torch.as_tensor(gt, dtype=self.dtype, device=self.device)
            gt_mask = torch.as_tensor(gt_mask, device=self.device).bool()

        def apply(lat, t, **kw):
            # cond-first CFG order: a single batch (out of band) is ctx[:n]
            n = lat.shape[0]
            if gt is not None:
                r = n // gt.shape[0]
                kw.update(gt=gt.repeat(r, 1, 1), mae_mask_infer=gt_mask.repeat(r, 1, 1))
            out, _ = self.dit(lat, t, ctx[:n], context_mask=cmask[:n], **kw)
            return out

        steps, schedule = int(ddim_steps), self.noise_scheduler
        cache_fns, interval = None, 1
        if layer_cache is not None:
            k, interval = (int(v) for v in layer_cache)
            cache_fns = (lambda lat, t: apply(lat, t, collect_deep_k=k),
                         lambda lat, t, deep: apply(lat, t, deep_cache=(k, deep)))
        if sampler == "dpm":
            return dpm_solver_sample(
                apply, schedule, noise, steps, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, layer_cache_fns=cache_fns,
                cache_interval=interval, guidance_interval=guidance_interval,
                cfg_refresh_interval=int(cfg_refresh))
        if sampler == "distilled":
            # DDIM on the student's grid, single batch: guidance is distilled in
            return distilled_sample(apply, schedule, noise, distill_tables(schedule, steps))
        if cache_fns is not None:
            return sample_latents_layer_cached(
                *cache_fns, schedule, noise, steps, cache_interval=interval,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                eta=float(eta), guidance_interval=guidance_interval, generator=gen)
        return sample_latents(apply, schedule, noise, steps, guidance_scale=guidance_scale,
                              guidance_rescale=guidance_rescale, eta=float(eta),
                              generator=gen, guidance_interval=guidance_interval)

    def _decode(self, pred):
        """Latents (B, L, C) -> waveform (B, T) on the host; the x480
        decoder inflates activations ~1000x, so <= 4 clips at once."""
        B, chunk = pred.shape[0], min(pred.shape[0], 4)
        wav = torch.cat([self.autoencoder.decode(pred[i: i + chunk])
                         for i in range(0, B, chunk)], dim=0)[..., 0]
        return wav.float().cpu().numpy()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate_audio(
        self,
        text: Union[str, Sequence[str]],
        length: float = 10,
        guidance_scale: Optional[float] = 5,
        guidance_rescale: float = 0.75,
        ddim_steps: int = 100,
        eta: float = 1,
        random_seed: Optional[int] = None,
        randomize_seed: bool = False,
        guidance_interval: Optional[Tuple[float, float]] = None,
        sampler: str = "ddim",
        initial_latents=None,
        quant: Optional[str] = None,
        layer_cache: Optional[Tuple[int, int]] = None,
        attn_impl: Optional[str] = None,
        fused: bool = False,
        cfg_refresh: int = 1,
    ) -> Tuple[int, np.ndarray]:
        """Generate audio from text; returns (sr, waveform).

        ``sampler``: ``'ddim'`` (reference parity, eta-noised), ``'dpm'``
        (DPM-Solver++(2M), deterministic) or ``'distilled'`` (a distilled
        student: DDIM on its grid, no CFG pair).

        ``guidance_interval=(t_lo, t_hi)``: the CFG pair only for
        timesteps inside the band, the conditional model alone elsewhere.

        ``layer_cache=(k, interval)``: every ``interval``-th step runs the
        full depth and caches the deep U-stack activation; the other steps
        recompute only ``k`` in-blocks and ``k`` out-blocks around it.

        ``cfg_refresh=P`` (``sampler='dpm'`` only): the uncond branch on
        every P-th in-band step (every P-th cache group), the carried
        guidance delta on the others.

        ``initial_latents``: optional (B, frames, C) starting noise in
        place of the seeded draw; the eta noise of each step comes from a
        generator seeded with ``random_seed``.
        """
        _refuse(fused=bool(fused), quant=quant is not None, attn_impl=attn_impl is not None)
        batched = not isinstance(text, str)
        texts = list(text) if batched else [text]
        if all(t == "" for t in texts):
            # reference: empty prompt -> no CFG; a mixed batch keeps the pair
            guidance_scale = None
        if randomize_seed or random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)
        if sampler == "distilled":
            # guidance is folded into the student; the cache and band
            # schedules are defined on the full-grid samplers
            guidance_scale = None
            if layer_cache is not None or guidance_interval is not None:
                raise ValueError("sampler='distilled' does not compose with layer_cache "
                                 "or guidance_interval")
        if int(cfg_refresh) != 1 and sampler != "dpm":
            raise ValueError("cfg_refresh > 1 is implemented for sampler='dpm' only "
                             f"(got sampler={sampler!r})")

        frames = int(length * self.latent_sr)
        latents = self._generate_latents(
            texts, frames, guidance_scale, guidance_rescale, ddim_steps, eta,
            random_seed, initial_latents=initial_latents,
            guidance_interval=guidance_interval, sampler=sampler,
            layer_cache=layer_cache, cfg_refresh=cfg_refresh)
        wav = self._decode(scale_shift_re(latents, self.scale, self.shift))
        return self.sr, (wav if batched else wav[0])

    # ------------------------------------------------------------------
    def generate_long(
        self,
        text: str,
        length: float,
        window: float = 10.0,
        overlap: float = 2.0,
        guidance_scale: Optional[float] = 5,
        guidance_rescale: float = 0.75,
        ddim_steps: int = 100,
        eta: float = 1,
        random_seed: Optional[int] = None,
        quant: Optional[str] = None,
        layer_cache: Optional[Tuple[int, int]] = None,
        attn_impl: Optional[str] = None,
    ) -> Tuple[int, np.ndarray]:
        """Audio longer than the training window by chained outpainting:
        the first ``window`` seconds, then ``editing_audio`` extensions with
        ``overlap`` seconds of boundary context, seeds ``random_seed + step``."""
        _refuse(quant=quant is not None, attn_impl=attn_impl is not None)
        if not window > overlap >= 0:
            raise ValueError(f"need window > overlap >= 0, got {window}, {overlap}")
        sr = self.sr
        if random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)
        _, audio = self.generate_audio(
            text, length=min(window, length), guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, ddim_steps=ddim_steps, eta=eta,
            random_seed=random_seed, layer_cache=layer_cache)
        step = 0
        while len(audio) < int(length * sr):
            step += 1
            cur_s = len(audio) / sr
            ext = min(window - overlap, length - cur_s)
            _, audio = self.editing_audio(
                text, boundary=overlap, gt_file=audio, mask_start=cur_s, mask_length=ext,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                ddim_steps=ddim_steps, eta=eta, random_seed=random_seed + step,
                layer_cache=layer_cache)
        return sr, audio[: int(length * sr)]

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def editing_audio(
        self,
        text: str,
        boundary: float,
        gt_file: Union[str, np.ndarray],
        mask_start: float,
        mask_length: float,
        guidance_scale: Optional[float] = 3.5,
        guidance_rescale: float = 0.0,
        ddim_steps: int = 100,
        eta: float = 1,
        random_seed: Optional[int] = None,
        randomize_seed: bool = False,
        quant: Optional[str] = None,
        layer_cache: Optional[Tuple[int, int]] = None,
        attn_impl: Optional[str] = None,
        crossfade: float = 0.0,
    ) -> Tuple[int, np.ndarray]:
        """Regenerate ``[mask_start, mask_start + mask_length)`` seconds of
        ``gt_file`` (a wav path or a waveform), with ``boundary`` seconds of
        context on each side; a mask past the end extends the clip
        (outpainting).  Returns (sr, waveform).

        ``crossfade`` (seconds; 0 is the reference's hard paste): blend
        generated and gt latents linearly over this span just inside each
        mask edge.  A mask of fewer than 2 latent frames takes the hard
        paste (the JAX package writes its ramp outside such a mask,
        ROADMAP F4).
        """
        _refuse(quant=quant is not None, attn_impl=attn_impl is not None)
        if text == "":
            guidance_scale = None
        if randomize_seed:
            random_seed = np.random.randint(0, MAX_SEED)
        sr = self.sr
        if isinstance(gt_file, str):
            gt = load_wav(gt_file, sr)
        else:
            gt = np.asarray(gt_file, np.float32)
        gt = peak_normalize(gt)

        # host index arithmetic exactly as the JAX package (Python round)
        mask_end = mask_start + mask_length
        audio_length = len(gt) / sr
        mask_start = min(mask_start, audio_length)
        if mask_end > audio_length:  # outpainting: zero-pad the tail
            gt = np.pad(gt, (0, round((mask_end - audio_length) * sr)), "constant")
            audio_length = len(gt) / sr
        output_audio = gt.copy()

        boundary = min((mask_end - mask_start) / 2, boundary)
        start_idx = max(mask_start - boundary, 0)
        end_idx = min(mask_end + boundary, audio_length)
        mask_start -= start_idx
        mask_end -= start_idx

        window = gt[round(start_idx * sr): round(end_idx * sr)]
        window_p = np.pad(window, (0, (-len(window)) % self.autoencoder.downsampling_ratio))
        enc_gen = torch.Generator(device=self.device).manual_seed(int(random_seed or 0))
        gt_latent = self.autoencoder.encode(window_p[None, :, None], generator=enc_gen)
        B, L, _ = gt_latent.shape

        s0, s1 = round(mask_start * self.latent_sr), round(mask_end * self.latent_sr)
        gt_mask = torch.zeros((B, L, 1), dtype=torch.bool, device=self.device)
        gt_mask[:, s0:s1] = True
        latents = self._generate_latents(
            [text], L, guidance_scale, guidance_rescale, ddim_steps, eta, random_seed,
            gt=gt_latent, gt_mask=gt_mask, layer_cache=layer_cache)
        pred = scale_shift_re(latents, self.scale, self.shift)
        # paste the unmasked gt back (inference.py:104-105), then decode
        if crossfade > 0.0 and s1 - s0 >= 2:
            xf = max(1, min(round(crossfade * self.latent_sr), (s1 - s0) // 2))
            w = np.zeros(L, np.float32)
            w[s0:s1] = 1.0
            ramp = np.arange(1, xf + 1, dtype=np.float32) / (xf + 1)
            w[s0: s0 + xf] = ramp
            w[s1 - xf: s1] = ramp[::-1]
            w = torch.from_numpy(w).to(self.device)[None, :, None]
            pred = w * pred + (1.0 - w) * gt_latent
        else:
            pred = torch.where(gt_mask, pred, gt_latent)
        wav = self._decode(pred)[0]

        chunk = round((end_idx - start_idx) * sr)
        output_audio[round(start_idx * sr): round(start_idx * sr) + chunk] = wav[:chunk]
        return sr, output_audio
