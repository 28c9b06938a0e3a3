"""EzAudioControlNet: energy-conditioned generation
(counterpart of ``ezaudio_tpu/api/controlnet.py::EzAudioControlNet``).

``generate_audio(text, audio_path, surpass_noise=0, guidance_scale=3.5,
guidance_rescale=0, ddim_steps=50, eta=1, conditioning_scale=1, ...)``
peak-normalizes the reference clip, pads or crops it to the 10 s window,
extracts its condition (``models/conditioners.py``) and samples with three
phases per model call: ``MaskDiT(forward_model=False)`` builds the concat,
``DiTControlNet`` computes the skips from it and the condition, and
``MaskDiT.forward_backbone`` runs UDiT with them.  The attention of all
25 + 12 blocks runs on kernel 1, the decode's ResidualUnits on kernel 2.

Runs on CUDA unless ``device="cpu"`` is passed; ``base=`` shares an
existing :class:`~ezaudio_tpu_torch.api.ezaudio.EzAudio` (its weights,
device and dtype), as ``GenerationServer(controlnet=)`` does.
``controlnet_path`` loads the published ControlNet checkpoint (key
``model``, strictly) from a local file; without it the ControlNet's
weights are random, drawn from ``seed + 1``, then its embedders and
in-blocks are copied from the base (``init_from_base_``).
``dtype=torch.bfloat16`` runs the base and the ControlNet in bf16, as
``EzAudio`` does: a base built here is built in f32, its in-blocks copied,
and both cast after, so the copies start from the f32 weights as the JAX
package's do.  ``mesh=`` (or a base on a mesh) places the base as
``EzAudio(mesh=)`` does and replicates the ControlNet's weights on it; a
call is one prompt, which every rank computes, each decoding its row of
the batch padded to the world.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.api.ezaudio import MAX_SEED, EzAudio, init_random_
from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict, load_torch_checkpoint
from ezaudio_tpu_torch.data.audio_io import load_wav, peak_normalize
from ezaudio_tpu_torch.diffusion.dpm import dpm_solver_sample
from ezaudio_tpu_torch.diffusion.sampling import sample_latents
from ezaudio_tpu_torch.models.conditioners import Conditioner
from ezaudio_tpu_torch.models.controlnet import controlnet_from_config, init_from_base_
from ezaudio_tpu_torch.ops.quant import quant_context
from ezaudio_tpu_torch.utils import cast_params_, scale_shift_re

# every reference clip is padded or cropped to the model's 10 s window
WINDOW_SECONDS = 10
SAMPLERS = ("ddim", "dpm")


class EzAudioControlNet:
    def __init__(
        self,
        model_name: str = "energy",
        config: Optional[dict] = None,
        config_path: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        controlnet_path: Optional[str] = None,
        vae_path: Optional[str] = None,
        t5_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        t5_config=None,
        vae_config: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        mesh=None,
        base: Optional[EzAudio] = None,
    ):
        """``dtype`` (default: the base's, float32 for a base built here)."""
        own_base = base is None
        if own_base:
            # built without the mesh: the in-blocks are copied from the whole
            # weights, the dtype is set, then the base goes on the mesh
            base = EzAudio(model_name=model_name, config=config, config_path=config_path,
                           ckpt_path=ckpt_path, vae_path=vae_path, t5_path=t5_path,
                           tokenizer_path=tokenizer_path, t5_config=t5_config,
                           vae_config=vae_config, seed=seed, device=device)
        elif dtype is not None and dtype != base.dtype:
            raise ValueError(f"dtype {dtype} differs from the base's {base.dtype}")
        if not own_base and mesh is None:
            mesh = base.mesh
        dtype = dtype or base.dtype
        self.base = base
        self.device = base.device
        cfg = base.params_cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        with torch.device(self.device):
            cn = controlnet_from_config(cfg.model.to_dict(), cfg.controlnet.to_dict())
        init_random_(cn, gen)
        if base._sharding is not None:  # a placed base: copy from its whole weights
            _init_from_state_dict_(cn, base._sharding.full_state_dict())
        else:
            cn = init_from_base_(cn, base.dit.model)
        if controlnet_path:
            load_state_dict_strict(cn, load_torch_checkpoint(controlnet_path, "model"),
                                   controlnet_path)
        if own_base:
            base._cast_(dtype)
            if mesh is not None:
                base._apply_mesh(mesh)
        self.controlnet = cast_params_(cn, dtype).eval().requires_grad_(False)
        if mesh is not None:  # the ControlNet's weights are replicated on the mesh
            from ezaudio_tpu_torch.parallel.mesh import replicate

            replicate(mesh, self.controlnet)
        self.dtype = dtype
        cond_kw = cfg.conditioner.to_dict()
        if cond_kw.get("condition_type") == "vc":
            cond_kw.setdefault("device", self.device)  # the HuBERT tower beside the model
        self.conditioner = Conditioner(**cond_kw)

    # ------------------------------------------------------------------
    def _denoise(self, ctx, cmask, condition, noise, steps, guidance_scale,
                 guidance_rescale, eta, conditioning_scale, sampler, generator):
        """The sampler loop; each model call runs MaskDiT's concat, the
        ControlNet on it (the condition tiled to the CFG batch) and the
        backbone with the ControlNet's skips."""
        base, dit = self.base, self.base.dit

        def apply(lat, t):
            n = lat.shape[0]
            ts = base._timestep(t)
            c, cm = ctx[:n], cmask[:n]
            with base._dit_context():
                concat, _ = dit(lat, ts, c, context_mask=cm, forward_model=False)
                skips = self.controlnet(
                    concat, ts, c, context_mask=cm,
                    condition=condition.repeat(n // condition.shape[0], 1, 1),
                    conditioning_scale=conditioning_scale)
                return dit.forward_backbone(concat, ts, c, context_mask=cm,
                                            controlnet_skips=skips)

        schedule = base.noise_scheduler
        if sampler == "dpm":
            return dpm_solver_sample(apply, schedule, noise, steps,
                                     guidance_scale=guidance_scale,
                                     guidance_rescale=guidance_rescale)
        return sample_latents(apply, schedule, noise, steps, guidance_scale=guidance_scale,
                              guidance_rescale=guidance_rescale, eta=eta,
                              generator=generator)

    @torch.inference_mode()
    def generate_audio(
        self,
        text: str,
        audio_path: Union[str, np.ndarray],
        surpass_noise: float = 0.0,
        guidance_scale: Optional[float] = 3.5,
        guidance_rescale: float = 0.0,
        ddim_steps: int = 50,
        eta: float = 1.0,
        conditioning_scale: float = 1.0,
        random_seed: Optional[int] = None,
        randomize_seed: bool = False,
        sampler: str = "ddim",
        quant: Optional[str] = None,
    ) -> Tuple[int, np.ndarray]:
        """Generate audio for ``text`` that follows the energy of
        ``audio_path`` (a wav path or a waveform at the model's rate);
        returns (sr, waveform) of the reference clip's length (at most the
        10 s window).  ``surpass_noise`` zeroes samples at or below that
        level after peak normalization; ``conditioning_scale`` scales the
        ControlNet's skips (0 runs the base model).  ``sampler``:
        ``'ddim'`` (eta-noised) or ``'dpm'`` (DPM-Solver++(2M)).
        ``quant='int8'``: W8A8 products in the DiT's and the ControlNet's
        linear layers."""
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        base, dev = self.base, self.device
        sr = base.sr
        gt = load_wav(audio_path, sr) if isinstance(audio_path, str) else audio_path
        gt = peak_normalize(np.asarray(gt, np.float32))
        if surpass_noise > 0:
            gt = np.where(np.abs(gt) <= surpass_noise, 0.0, gt)
        original_length = len(gt)
        num_samples = int(WINDOW_SECONDS * sr)
        frames = round(num_samples / sr * base.latent_sr)
        if len(gt) < num_samples:
            gt = np.pad(gt, (0, num_samples - len(gt)))
        else:
            gt = gt[:num_samples]
        wave = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(dev)
        condition = self.conditioner(wave[None]).to(self.dtype)

        if randomize_seed or random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)
        gen = torch.Generator(device=dev).manual_seed(int(random_seed))
        if text == "":
            guidance_scale = None
        cond, cond_mask = base.embed_text([text])
        if guidance_scale:
            uncond, uncond_mask = base._uncond_embedding(1)
            ctx = torch.cat([cond, uncond], dim=0)
            cmask = torch.cat([cond_mask, uncond_mask], dim=0)
        else:
            guidance_scale = None  # 0 means no CFG: the single batch
            ctx, cmask = cond, cond_mask
        noise = utils.randn((1, frames, base.latent_dim), gen, dev, self.dtype)
        with quant_context(quant):
            latents = self._denoise(ctx, cmask, condition, noise, int(ddim_steps),
                                    guidance_scale, float(guidance_rescale), float(eta),
                                    float(conditioning_scale), sampler, gen)
        wav = base._decode(scale_shift_re(latents, base.scale, base.shift))[0]
        return sr, wav[:original_length]


def _init_from_state_dict_(controlnet, sd) -> None:
    """``init_from_base_`` from a MaskDiT state dict (``model.*`` names)
    in the unsharded layout."""
    from ezaudio_tpu_torch.models.controlnet import SHARED_WITH_BASE

    for name in SHARED_WITH_BASE:
        mine = getattr(controlnet, name)
        if mine is not None:
            pre = f"model.{name}."
            mine.load_state_dict({k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)})


# the reference's spelling (api/controlnet.py class EzAudio_ControlNet)
EzAudio_ControlNet = EzAudioControlNet
