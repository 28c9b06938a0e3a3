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
    outpainting past the training window;
  * ``generate_audio_reranked(text, scorer, n_candidates=4, ...)``: best of
    K candidates by CLAP score (``audio/clap.py::CLAPScorer``).

``quant='int8'`` runs the DiT's linear layers as dynamic W8A8 int8
products (``ops/quant.py``).  ``generate_audio(fused=True)`` runs the whole
pipeline (T5, CFG concat, sampler loop, re-scale, chunked decode) as one
program: a CUDA graph captured at the first call of a signature and
replayed after (``api/graphs.py``), the same function eagerly on the CPU.
``attn_impl`` names that compute kernel 1's function (f32 softmax) run on
it; ``'bf16'`` and ``'chunked_bf16'`` run the JAX package's bf16-logit
einsum formulation in plain torch; ``'ring'`` runs self-attention on the
sequence-parallel ring inside ``parallel.ring_context(mesh)`` (and raises
outside one, as JAX asserts).

``config=`` builds any MaskDiT architecture the JAX package builds (its
``model:`` block's switches; concat/joint context needs
``context_max_length`` equal to ``text_encoder.max_length``).
Runs on CUDA unless ``device="cpu"`` is passed; with no GPU and no device
it raises.  ``ckpt_path``, ``vae_path`` and ``t5_path`` load the published
checkpoints from local files (``convert/checkpoints.py``); a component
without a path keeps its random weights, drawn from ``seed``.
``dtype=torch.bfloat16`` computes the JAX package's bf16 function: bf16
copies of the parameters, made once on the device, where the JAX package
casts its f32 parameters at each use, and f32 where it keeps f32 (norms,
RoPE, T5's scores and softmax, the sampler's update, the VAE snakes); both
kernels run in their bf16 modes.

``mesh=parallel.make_mesh(...)`` (one process per GPU, every rank making
the same calls): the DiT is placed by ``dit_param_shardings`` (FSDP2 over
dp x fsdp, Megatron tp), T5 and the VAE are replicated (rank 0's weights
broadcast).  A call's batch is padded to the data-parallel world (dp x
fsdp, repeating the last row), each rank samples and decodes its rows
(in chunks of 4, the JAX package's 4 x world a call), and every rank
returns the whole batch, gathered.  The noise is drawn for the request's
batch before the split, so a (prompt, seed) pair gives the single-device
waveform.  ``fused=True`` on a mesh is the staged program per rank on the
CPU, and on CUDA with dp alone (no collective may run inside a graph).
Every random draw goes through ``utils.randn`` (ROADMAP F1).
"""

from __future__ import annotations

import contextlib
import math
import weakref
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.api.graphs import GraphProgram
from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
from ezaudio_tpu_torch.config import ConfigDict, MODEL_REGISTRY, load_config
from ezaudio_tpu_torch.convert.checkpoints import (load_state_dict_strict,
                                                   load_t5_state_dict, load_torch_checkpoint,
                                                   strip_prefix)
from ezaudio_tpu_torch.convert.from_jax import fold_weight_norm
from ezaudio_tpu_torch.data.audio_io import load_wav, peak_normalize
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.diffusion.distill import distill_tables, distilled_sample
from ezaudio_tpu_torch.diffusion.dpm import dpm_solver_sample
from ezaudio_tpu_torch.diffusion.sampling import sample_latents, sample_latents_layer_cached
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from ezaudio_tpu_torch.ops.attention import BF16_IMPLS, attention_impl_context
from ezaudio_tpu_torch.ops.embeddings import PEWrapper
from ezaudio_tpu_torch.ops.mlp import ActProj
from ezaudio_tpu_torch.ops.norms import LayerNorm, RMSNorm
from ezaudio_tpu_torch.ops.quant import current_quant_mode, quant_context
from ezaudio_tpu_torch.text.t5 import (T5Encoder, T5EncoderConfig, T5LayerNorm,
                                       t5_state_dict_from_hf)
from ezaudio_tpu_torch.text.tokenizer import get_tokenizer
from ezaudio_tpu_torch.utils import cast_params_, resolve_device, scale_shift_re

MAX_SEED = np.iinfo(np.int32).max

_T5_CONFIGS = {
    "google/flan-t5-large": T5EncoderConfig.flan_t5_large,
    "google/flan-t5-xl": T5EncoderConfig.flan_t5_xl,
}
_NORMS = (LayerNorm, RMSNorm, T5LayerNorm)
SAMPLERS = ("ddim", "dpm", "distilled")
DTYPES = (torch.float32, torch.bfloat16)  # the dtypes both kernels take
# attention implementations of the JAX package that compute kernel 1's
# function (f32 scores and softmax): each runs on the kernel here.  The
# bf16 variants (ops/attention.py BF16_IMPLS) keep their logits in bf16,
# another function, and run as plain torch ops.
ATTN_ON_KERNEL = ("auto", "einsum", "pallas", "flash", "chunked")
ATTN_RING = ("ring",)  # self-attention on the sp ring (parallel/ring_attention.py)
FUSED_CACHE = 32  # fused programs kept per EzAudio (their graphs share one pool)


def check_attn_impl(attn_impl: Optional[str]) -> None:
    """Accept the attention implementations that are ported."""
    if (attn_impl is None or attn_impl in ATTN_ON_KERNEL or attn_impl in BF16_IMPLS
            or attn_impl in ATTN_RING):
        return
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


def check_context_length(model_cfg: dict, max_length: int) -> None:
    """``concat``/``joint`` fusion prefixes exactly ``context_max_length``
    text tokens, and the tokenizer pads to ``max_length``: they must agree
    (the JAX package asserts it at the first call)."""
    if (model_cfg.get("context_dim") is not None
            and model_cfg.get("context_fusion", "cross") in ("concat", "joint")
            and model_cfg.get("context_max_length") != max_length):
        raise ValueError(f"context_fusion={model_cfg['context_fusion']!r} needs "
                         f"context_max_length ({model_cfg.get('context_max_length')}) equal "
                         f"to the tokenizer's max_length ({max_length})")


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, by the JAX package's init rules: convs take
    torch's default U(+-1/sqrt(fan_in)) (weight and bias; with weight norm
    ``weight_v`` so and ``weight_g`` its norm), learned positional tables
    N(0, 0.02), the feed-forward snakes' alpha and beta 1 + N(0, 0.1),
    every other matrix xavier-uniform, every other vector N(0, 0.02); norms
    stay (1, 0).  Nothing JAX zero-initialises is left zero (ROADMAP F6)."""
    done = set()
    for m in module.modules():
        if isinstance(m, _NORMS):
            done.update(id(p) for p in m.parameters())
        elif isinstance(m, nn.modules.conv._ConvNd):
            bound = 1.0 / math.sqrt(m.weight[0].numel())  # torch fan_in
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
                done.add(id(p))
            if "weight_g" in m._parameters:
                v = m.weight_v
                m.weight_g.copy_(v.square().sum(dim=tuple(range(1, v.ndim)),
                                                keepdim=True).sqrt())
        elif isinstance(m, PEWrapper) and m.method == "abs":
            m.abs_pe.normal_(0.0, 0.02, generator=generator)
            done.add(id(m.abs_pe))
        elif isinstance(m, ActProj) and m.fn is None:
            for p in (m.alpha, m.beta):
                p.normal_(1.0, 0.1, generator=generator)
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
        if mesh is not None:
            from ezaudio_tpu_torch.parallel.mesh import check_mesh

            check_mesh(mesh)
        if dtype not in DTYPES:
            raise NotImplementedError(f"dtype {dtype}: float32 and bfloat16 are ported")
        self.device = resolve_device(device)
        self.dtype = torch.float32
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
        check_context_length(cfg.model.to_dict(), cfg.text_encoder.max_length)
        vae_cfg = vae_config if vae_config is not None else load_config(
            MODEL_REGISTRY["vae"]["config"]).to_dict()

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.device(self.device):
            self.dit = maskdit_from_config(cfg.model.to_dict())
            vae = vae_from_config(vae_cfg)
            self.t5 = T5Encoder(self.t5_cfg)
        for m in (self.dit, vae, self.t5):
            init_random_(m, gen).eval().requires_grad_(False)
        # the checkpoints, read on the host and copied into the weights on
        # the device; every component is drawn first, so one without a path
        # keeps the weights a model without paths has at this seed
        if ckpt_path:
            load_state_dict_strict(self.dit, load_torch_checkpoint(ckpt_path, "model"),
                                   ckpt_path)
        if vae_path:
            sd = strip_prefix(load_torch_checkpoint(vae_path, "state_dict"), "autoencoder.")
            load_state_dict_strict(vae, fold_weight_norm(sd), vae_path)
        if t5_path:
            load_state_dict_strict(self.t5, t5_state_dict_from_hf(load_t5_state_dict(t5_path)),
                                   t5_path)
        self.autoencoder = AutoencoderFacade(
            vae, quantization_first=cfg.autoencoder.get("q_first", True))
        self.max_length = cfg.text_encoder.max_length
        self.tokenizer = get_tokenizer(tokenizer_path, self.t5_cfg.vocab_size)
        self.noise_scheduler = DDIMSchedule.from_config(cfg.diff)
        self._uncond = {}
        self._timesteps = {}
        # fused programs by signature, least recently used first; their CUDA
        # graphs share one memory pool (they replay one at a time)
        self._fused = OrderedDict()
        self._graph_pool = None
        self._cast_(dtype)
        self.mesh, self._sharding = None, None
        if mesh is not None:
            self._apply_mesh(mesh)

    def _apply_mesh(self, mesh) -> None:
        """Place the weights on ``mesh``: rank 0's weights everywhere, then
        the DiT by ``dit_param_shardings`` (after the dtype is set)."""
        from ezaudio_tpu_torch.parallel.mesh import replicate
        from ezaudio_tpu_torch.parallel.sharding import shard_dit

        for m in (self.dit, self.t5, self.autoencoder.model):
            replicate(mesh, m)
        self._sharding = shard_dit(mesh, self.dit)
        if self._sharding.wrapped:
            from torch.distributed.fsdp import register_fsdp_forward_method

            register_fsdp_forward_method(self.dit, "forward_backbone")
        self.mesh = mesh

    def _dit_context(self):
        """Around a call of the DiT: FSDP2 cannot gather its weights in
        inference mode, so a wrapped DiT runs under ``no_grad`` instead."""
        if self._sharding is None or not self._sharding.wrapped:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode(False))
        stack.enter_context(torch.no_grad())
        return stack

    @property
    def _world(self) -> int:
        """The data-parallel world: the ways a call's batch splits."""
        from ezaudio_tpu_torch.parallel.mesh import data_world

        return 1 if self.mesh is None else data_world(self.mesh)

    def _pad_rows(self, x, pad: int):
        """``x`` with its last row repeated ``pad`` times."""
        if pad == 0 or x is None:
            return x
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)

    def _shard_rows(self, x):
        """This rank's rows of ``x`` (all of them without a mesh; replicated
        when the rows do not divide the world)."""
        if self.mesh is None:
            return x
        from ezaudio_tpu_torch.parallel.mesh import data_rank, shard_batch

        if isinstance(x, list):
            if len(x) % self._world:
                return x
            k = len(x) // self._world
            return x[data_rank(self.mesh) * k:(data_rank(self.mesh) + 1) * k]
        return shard_batch(self.mesh, x, strict=False)

    def _gather_rows(self, x):
        """Every rank's rows, in order (``x`` itself without a mesh)."""
        if self.mesh is None:
            return x
        from ezaudio_tpu_torch.parallel.mesh import gather_rows

        return gather_rows(self.mesh, x)

    def _cast_(self, dtype: torch.dtype) -> None:
        """The compute dtype of the DiT, T5 and the VAE (``utils.cast_params_``),
        set once, before any call: ``EzAudioControlNet`` builds an f32 base,
        copies its in-blocks, then casts both."""
        if dtype != self.dtype:
            if self._fused or self._uncond:
                raise RuntimeError("the dtype is set before the first call")
            for m in (self.dit, self.t5, self.autoencoder.model):
                cast_params_(m, dtype)
            self.dtype = dtype

    # ------------------------------------------------------------------
    def _tokens(self, texts: Sequence[str]):
        ids, mask = self.tokenizer(list(texts), max_length=self.max_length)
        return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @torch.inference_mode()
    def embed_text(self, texts: Sequence[str]):
        ids, mask = self._tokens(texts)
        return self.t5(ids, mask), mask

    def _uncond_embedding(self, batch: int):
        """Cached empty-prompt embedding (the CFG uncond branch)."""
        if batch not in self._uncond:
            if len(self._uncond) >= 8:
                self._uncond.clear()
            self._uncond[batch] = self.embed_text([""] * batch)
        return self._uncond[batch]

    def _timestep(self, t: int) -> torch.Tensor:
        """Timestep ``t`` as an int64 scalar on the device, made once: the
        DiT reads it in place, and a CUDA graph capture cannot copy a Python
        number to the device."""
        ts = self._timesteps.get(t)
        if ts is None:
            ts = self._timesteps[t] = torch.tensor(int(t), device=self.device)
        return ts

    def _initial_noise(self, shape, initial_latents, generator):
        if initial_latents is None:
            return utils.randn(shape, generator, self.device, self.dtype)
        noise = torch.as_tensor(initial_latents, dtype=self.dtype, device=self.device)
        if noise.shape != shape:
            raise ValueError(f"initial_latents {tuple(noise.shape)}, expected {shape}")
        return noise

    @torch.inference_mode()
    def _generate_latents(self, texts, frames, guidance_scale, guidance_rescale,
                          ddim_steps, eta, random_seed, initial_latents=None, gt=None,
                          gt_mask=None, guidance_interval=None, sampler="ddim",
                          layer_cache=None, cfg_refresh=1, quant=None, attn_impl=None):
        """Sampled latents (B, frames, C).  ``gt`` (B, frames, C) and
        ``gt_mask`` (B, frames, 1) condition MaskDiT for editing; their rows
        repeat across the CFG pair."""
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        B = len(texts)
        if random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)
        gen = torch.Generator(device=self.device).manual_seed(int(random_seed))
        # on a mesh: pad the batch to the data-parallel world, each rank its rows
        pad = (-B) % self._world
        texts = self._shard_rows(list(texts) + [texts[-1]] * pad)
        cond, cond_mask = self.embed_text(texts)
        if guidance_scale:
            uncond, uncond_mask = self._uncond_embedding(len(texts))
            ctx = torch.cat([cond, uncond], dim=0)
            cmask = torch.cat([cond_mask, uncond_mask], dim=0)
        else:
            guidance_scale = None
            ctx, cmask = cond, cond_mask
        shape = (B, frames, self.latent_dim)
        # the request batch's draws, then the padding and the split
        noise = self._shard_rows(self._pad_rows(self._initial_noise(shape, initial_latents,
                                                                    gen), pad))
        step_noise = None
        if self.mesh is not None:
            def step_noise(i):
                draw = utils.randn(shape, gen, self.device, self.dtype)
                return self._shard_rows(self._pad_rows(draw, pad))
        if gt is not None:
            gt = torch.as_tensor(gt, dtype=self.dtype, device=self.device)
            gt_mask = torch.as_tensor(gt_mask, device=self.device).bool()
            gt = self._shard_rows(self._pad_rows(gt, pad))
            gt_mask = self._shard_rows(self._pad_rows(gt_mask, pad))
        with quant_context(quant), attention_impl_context(attn_impl):
            latents = self._denoise(ctx, cmask, noise, ddim_steps, guidance_scale,
                                    guidance_rescale, eta, guidance_interval, sampler,
                                    layer_cache, cfg_refresh, gt=gt, gt_mask=gt_mask,
                                    generator=gen, step_noise=step_noise)
        return self._gather_rows(latents)[:B]

    def _denoise(self, ctx, cmask, noise, steps, guidance_scale, guidance_rescale, eta,
                 guidance_interval=None, sampler="ddim", layer_cache=None, cfg_refresh=1,
                 gt=None, gt_mask=None, generator=None, step_noise=None):
        """The sampler loop over MaskDiT from ``noise``, on the CFG-ordered
        context ``[cond; uncond]`` (or cond alone when ``guidance_scale`` is
        None); shared by the staged path and the fused program.  The DDIM
        eta noise comes from ``generator``, or ``step_noise(i)``."""

        def apply(lat, t, **kw):
            # cond-first CFG order: a single batch (out of band) is ctx[:n]
            n = lat.shape[0]
            if gt is not None:
                r = n // gt.shape[0]
                kw.update(gt=gt.repeat(r, 1, 1), mae_mask_infer=gt_mask.repeat(r, 1, 1))
            with self._dit_context():
                out, _ = self.dit(lat, self._timestep(t), ctx[:n], context_mask=cmask[:n], **kw)
            return out

        steps, schedule = int(steps), self.noise_scheduler
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
                eta=float(eta), guidance_interval=guidance_interval, generator=generator,
                step_noise=step_noise)
        return sample_latents(apply, schedule, noise, steps, guidance_scale=guidance_scale,
                              guidance_rescale=guidance_rescale, eta=float(eta),
                              generator=generator, step_noise=step_noise,
                              guidance_interval=guidance_interval)

    def _decode_device(self, pred, chunk: int = 4):
        """Latents (B, L, C) -> waveform (B, T) on the device; the x480
        decoder inflates activations ~1000x, so <= ``chunk`` clips at once."""
        B = pred.shape[0]
        wav = torch.cat([self.autoencoder.decode(pred[i: i + chunk])
                         for i in range(0, B, chunk)], dim=0)[..., 0]
        return wav.float()

    def _decode(self, pred):
        """Latents (B, L, C) -> waveform (B, T) on the host; on a mesh each
        rank decodes its rows of the batch padded to the world."""
        B = pred.shape[0]
        rows = self._shard_rows(self._pad_rows(pred, (-B) % self._world))
        return self._gather_rows(self._decode_device(rows))[:B].cpu().numpy()

    # ------------------------------------------------------------------
    def _fused_impl(self, steps, guidance_scale, guidance_rescale, eta, guidance_interval,
                    sampler, quant, layer_cache, attn_impl, dtype, B, frames, draw_noise, cfg,
                    chunk, cfg_refresh):
        """The single-dispatch text->waveform program of one signature
        (counterpart of the JAX package's ``_fused_impl``): ``(ids, mask,
        noise, eta_noise) -> waveform (B, T)`` on the device, T5 encode ->
        CFG concat -> sampler loop -> ``scale_shift_re`` -> decode in chunks
        of ``chunk`` clips.  ``noise`` holds the initial latents (drawn when
        ``draw_noise``, else passed in) and ``eta_noise`` the DDIM steps'
        draws: the host wrapper draws both from the call's generator in the
        staged path's order, so both paths sample the same numbers.  The
        empty-prompt embedding is computed here, before any capture, and
        held by the program.  ``attn_impl`` is set around the program;
        ``dtype`` (the model's) is part of the signature and computes
        nothing.  The program reaches this EzAudio through a
        weak reference: ``self._fused`` holds the programs, so a strong one
        would keep a deleted EzAudio's weights and graph pools alive until
        the garbage collector ran (ROADMAP F8)."""
        un_emb, un_mask = self._uncond_embedding(B) if cfg else (None, None)
        ref = weakref.ref(self)

        def core(ids, mask, noise, eta_noise):
            ez = ref()
            with quant_context(quant or "off"), attention_impl_context(attn_impl):
                cond = ez.t5(ids, mask)
                if cfg:
                    ctx = torch.cat([cond, un_emb], dim=0)
                    cmask = torch.cat([mask, un_mask], dim=0)
                else:
                    ctx, cmask = cond, mask
                latents = ez._denoise(
                    ctx, cmask, noise, steps, guidance_scale, guidance_rescale, eta,
                    guidance_interval, sampler, layer_cache, cfg_refresh,
                    step_noise=None if eta_noise is None else eta_noise.__getitem__)
                return ez._decode_device(scale_shift_re(latents, ez.scale, ez.shift), chunk)

        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return GraphProgram(core, self.device, self._graph_pool)

    def _fused_program(self, *key) -> GraphProgram:
        """The cached fused program of signature ``key`` (the arguments of
        :meth:`_fused_impl`), built at first use; at most FUSED_CACHE are
        kept, the least recently used dropped first."""
        prog = self._fused.get(key)
        if prog is None:
            prog = self._fused[key] = self._fused_impl(*key)
            if len(self._fused) > FUSED_CACHE:
                self._fused.popitem(last=False)
        self._fused.move_to_end(key)
        return prog

    def _generate_fused(self, texts, frames, guidance_scale, guidance_rescale, ddim_steps,
                        eta, random_seed, guidance_interval, sampler, initial_latents,
                        quant, layer_cache, attn_impl, cfg_refresh):
        """Host side of the fused path: tokenize, draw, look up (or build)
        the program, one call, one copy of the waveform to the host."""
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        B, steps, eta = len(texts), int(ddim_steps), float(eta)
        if self.mesh is not None and self.device.type == "cuda" and (
                self._sharding.fsdp_names or self._world != self.mesh.size()):
            raise NotImplementedError("fused=True on a CUDA mesh takes dp alone: fsdp, tp "
                                      "and sp run collectives, which a CUDA graph cannot hold")
        gen = torch.Generator(device=self.device).manual_seed(int(random_seed))
        pad = (-B) % self._world
        ids, mask = self._tokens(self._shard_rows(list(texts) + [texts[-1]] * pad))
        cfg = bool(guidance_scale)
        shape = (B, frames, self.latent_dim)
        noise = self._shard_rows(self._pad_rows(self._initial_noise(shape, initial_latents,
                                                                    gen), pad))
        eta_noise = None
        if sampler == "ddim" and eta > 0:
            # the staged DDIM loop's per-step draws, one per step in its order
            eta_noise = torch.stack([
                self._shard_rows(self._pad_rows(utils.randn(shape, gen, self.device,
                                                            self.dtype), pad))
                for _ in range(steps)])
        with quant_context(quant):
            mode = current_quant_mode()
        b = ids.shape[0]
        prog = self._fused_program(
            steps, guidance_scale if cfg else None, guidance_rescale, eta,
            tuple(guidance_interval) if guidance_interval is not None else None, sampler,
            mode, tuple(layer_cache) if layer_cache is not None else None, attn_impl,
            self.dtype, b, frames, initial_latents is None, cfg, min(b, 4), int(cfg_refresh))
        return self._gather_rows(prog(ids, mask, noise, eta_noise))[:B].cpu().numpy()

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

        ``quant='int8'``: dynamic W8A8 int8 products in the DiT's linear
        layers (``ops/quant.py``); T5 and the VAE stay in float.

        ``fused=True``: the whole pipeline as one program (T5, CFG concat,
        sampler loop, re-scale, chunked decode), one CUDA graph per
        signature, captured at its first call and replayed after; on the
        CPU the same program runs eagerly.  It draws the same numbers as
        the staged path and runs the same kernels in the same order, so the
        waveform is the staged one.

        ``attn_impl``: the JAX package's names that compute kernel 1's
        function (``'auto'``, ``'einsum'``, ``'pallas'``, ``'flash'``,
        ``'chunked'``) all run on it; ``'bf16'`` and ``'chunked_bf16'`` run
        the bf16-logit einsum formulation (plain torch); ``'ring'`` runs
        self-attention on the sequence-parallel ring inside
        ``parallel.ring_context(mesh)`` and raises outside one.
        """
        check_attn_impl(attn_impl)
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
        # the fused program decodes the latents as they are; a
        # quantization_first=False codec samples its posterior in decode,
        # which the program does not carry: that takes the staged path
        if fused and self.autoencoder.quantization_first:
            wav = self._generate_fused(
                texts, frames, guidance_scale, guidance_rescale, ddim_steps, eta,
                random_seed, guidance_interval, sampler, initial_latents, quant,
                layer_cache, attn_impl, cfg_refresh)
            return self.sr, (wav if batched else wav[0])
        latents = self._generate_latents(
            texts, frames, guidance_scale, guidance_rescale, ddim_steps, eta,
            random_seed, initial_latents=initial_latents,
            guidance_interval=guidance_interval, sampler=sampler,
            layer_cache=layer_cache, cfg_refresh=cfg_refresh, quant=quant, attn_impl=attn_impl)
        wav = self._decode(scale_shift_re(latents, self.scale, self.shift))
        return self.sr, (wav if batched else wav[0])

    # ------------------------------------------------------------------
    def generate_audio_reranked(
        self,
        text: Union[str, Sequence[str]],
        scorer,
        n_candidates: int = 4,
        text_ids=None,
        return_all: bool = False,
        **generate_kw,
    ):
        """Best-of-K generation: ``n_candidates`` samples per prompt in ONE
        batched ``generate_audio`` call, each scored against its prompt by
        CLAP, the best waveform per prompt returned.

        ``scorer``: a :class:`~ezaudio_tpu_torch.audio.clap.CLAPScorer`.
        ``text_ids``: pre-tokenized CLAP ``input_ids`` of the B prompts,
        needed when the scorer has no tokenizer.  The B prompts are embedded
        once and the B*K waveforms once; the score is their cosine.
        ``return_all=True`` also returns every candidate, (B, K, T), and the
        (B, K) scores.  ``**generate_kw`` goes to :meth:`generate_audio`
        (``random_seed``, samplers, ``layer_cache``, ``guidance_interval``,
        ``fused`` ...); ``initial_latents`` there is (B*K, frames, C).
        """
        batched = not isinstance(text, str)
        texts = list(text) if batched else [text]
        B, K = len(texts), int(n_candidates)
        if K < 1:
            raise ValueError(f"n_candidates must be >= 1, got {n_candidates}")
        sr, wav = self.generate_audio([t for t in texts for _ in range(K)], **generate_kw)
        a = torch.as_tensor(scorer.embed_audio(wav, sr))                   # (B*K, D)
        t = torch.as_tensor(scorer.embed_text(texts if text_ids is None else text_ids))
        scores = torch.einsum("bkd,bd->bk", a.reshape(B, K, -1), t).float().cpu().numpy()
        best = scores.argmax(axis=1)
        wav = wav.reshape(B, K, -1)
        best_wav = wav[np.arange(B), best]
        if not batched:
            best_wav = best_wav[0]
        if return_all:
            return sr, best_wav, wav, scores
        return sr, best_wav

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
        check_attn_impl(attn_impl)
        if not window > overlap >= 0:
            raise ValueError(f"need window > overlap >= 0, got {window}, {overlap}")
        sr = self.sr
        if random_seed is None:
            random_seed = np.random.randint(0, MAX_SEED)
        _, audio = self.generate_audio(
            text, length=min(window, length), guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, ddim_steps=ddim_steps, eta=eta,
            random_seed=random_seed, quant=quant, layer_cache=layer_cache,
            attn_impl=attn_impl)
        step = 0
        while len(audio) < int(length * sr):
            step += 1
            cur_s = len(audio) / sr
            ext = min(window - overlap, length - cur_s)
            _, audio = self.editing_audio(
                text, boundary=overlap, gt_file=audio, mask_start=cur_s, mask_length=ext,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                ddim_steps=ddim_steps, eta=eta, random_seed=random_seed + step,
                quant=quant, layer_cache=layer_cache, attn_impl=attn_impl)
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
        check_attn_impl(attn_impl)
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
            gt=gt_latent, gt_mask=gt_mask, layer_cache=layer_cache, quant=quant,
            attn_impl=attn_impl)
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
