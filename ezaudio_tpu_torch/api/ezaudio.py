"""EzAudio: the end-user text-to-audio facade (counterpart of
``ezaudio_tpu/api/ezaudio.py::EzAudio``), staged generation path.

``generate_audio(text, length=10, guidance_scale=5, guidance_rescale=0.75,
ddim_steps=100, eta=1, random_seed=None)`` -> (sr, waveform):
HashTokenizer/tokenizer.json ids -> T5 -> CFG-paired DDIM over MaskDiT ->
``scale_shift_re`` -> Oobleck decode in chunks of up to 4 clips.
``text`` may be a list (batched prompts, waveform (B, T)); an all-empty
batch turns guidance off.

Runs on CUDA unless ``device="cpu"`` is passed; with no GPU and no device
it raises.  Weights are random, drawn from ``seed``: loading the published
checkpoints waits for those files.  Arguments this slice does not cover
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
from ezaudio_tpu_torch.config import ConfigDict, MODEL_REGISTRY, load_config
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.diffusion.sampling import sample_latents
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
                          ddim_steps, eta, random_seed, initial_latents=None):
        B = len(texts)
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
            noise = torch.randn(shape, generator=gen, device=self.device, dtype=self.dtype)

        def model_fn(lat, t):
            n = lat.shape[0]
            out, _ = self.dit(lat, t, ctx[:n], context_mask=cmask[:n])
            return out

        return sample_latents(model_fn, self.noise_scheduler, noise, int(ddim_steps),
                              guidance_scale=guidance_scale,
                              guidance_rescale=guidance_rescale, eta=float(eta),
                              generator=gen)

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

        ``initial_latents``: optional (B, frames, C) starting noise in
        place of the seeded draw; the eta noise of each step comes from a
        generator seeded with ``random_seed``.
        """
        unsupported = {"sampler": sampler != "ddim", "fused": bool(fused),
                       "quant": quant is not None, "layer_cache": layer_cache is not None,
                       "guidance_interval": guidance_interval is not None,
                       "attn_impl": attn_impl is not None,
                       "cfg_refresh": int(cfg_refresh) != 1}
        named = [k for k, on in unsupported.items() if on]
        if named:
            raise NotImplementedError(f"not ported yet: {', '.join(named)}")
        batched = not isinstance(text, str)
        texts = list(text) if batched else [text]
        if all(t == "" for t in texts):
            # reference: empty prompt -> no CFG; a mixed batch keeps the pair
            guidance_scale = None
        if randomize_seed or random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)

        frames = int(length * self.latent_sr)
        latents = self._generate_latents(
            texts, frames, guidance_scale, guidance_rescale, ddim_steps, eta,
            random_seed, initial_latents=initial_latents)
        pred = scale_shift_re(latents, self.scale, self.shift)
        # the x480 decoder inflates activations ~1000x: decode <= 4 clips at once
        B, chunk = pred.shape[0], min(pred.shape[0], 4)
        wav = torch.cat([self.autoencoder.decode(pred[i: i + chunk])
                         for i in range(0, B, chunk)], dim=0)[..., 0]
        wav = wav.float().cpu().numpy()
        return self.sr, (wav if batched else wav[0])
