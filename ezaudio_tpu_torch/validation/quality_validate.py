"""Quality-validate the few-step samplers on a model the port trains itself
(counterpart of ``scripts/quality_validate.py``).

A tiny MaskDiT (depth 4, dim 128, 4 heads) is trained on a synthetic
conditional latent distribution (caption class -> tone pattern in latent
space, :func:`make_batch`).  Each sampler then generates from the same
seeds, and the Frechet distance between generated and data latents (the FAD
math of ``audio/metrics.py`` over :func:`features`) and the conditional
accuracy of the dominant latent frequency give a quality table, row for
row the JAX harness's.

    python -m ezaudio_tpu_torch.validation.quality_validate [steps] [--device cpu]

Randomness: the training batches come from ``np.random.default_rng(0)``
as in the JAX harness, so both draw the same rows; the step draws, the
eval noise and the DDIM eta noise come from ``torch.Generator`` seeds where
JAX uses ``PRNGKey(i)``, ``PRNGKey(7)`` and ``PRNGKey(8)`` (torch cannot
reproduce JAX's draws, ROADMAP F1).  Writes a markdown table to stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from ezaudio_tpu_torch.ops import quant as quant_mod
from ezaudio_tpu_torch.ops.attention import attention_impl_context
from ezaudio_tpu_torch.training.optim import make_optimizer
from ezaudio_tpu_torch.training.trainer import make_train_step
from ezaudio_tpu_torch.utils import resolve_device

L, C, Lc, D = 64, 8, 4, 24
N_CLASS = 4
GUIDANCE = 3.0
TRAIN_BATCH = 64
N_EVAL = 256
NOISE_SEED, STEP_NOISE_SEED = 7, 8  # JAX's PRNGKey(7) and PRNGKey(8)

MODEL_CFG = dict(
    mae=False, mae_prob=0.0, mask_ratio=[0.25, 1.0], mask_span=4,
    img_size=L, patch_size=1, in_chans=C, out_chans=C, input_type="1d",
    embed_dim=128, depth=4, num_heads=4, mlp_ratio=2.0,
    qkv_bias=False, qk_scale=None, qk_norm="layernorm",
    norm_layer="layernorm", act_layer="geglu", context_norm=True,
    use_checkpoint=False, time_fusion="ada_sola_bias",
    ada_sola_rank=8, ada_sola_alpha=8, cls_dim=None,
    context_dim=D, context_fusion="cross", context_max_length=None,
    context_pe_method="none", pe_method="none", rope_mode="shared",
    use_conv=True, skip=True, skip_norm=True,
)
DIFF_CFG = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                beta_start=0.00085, beta_end=0.012, prediction_type="v_prediction",
                rescale_betas_zero_snr=True, timestep_spacing="trailing", clip_sample=False)


def make_batch(rng, B):
    """Synthetic conditional latents: class k -> sinusoid bank with
    class-dependent frequencies + small noise; text embedding = one-hot-ish
    class code tiled over Lc tokens."""
    cls = rng.integers(0, N_CLASS, B)
    t = np.arange(L)[None, :, None]
    ch = np.arange(C)[None, None, :]
    freq = (cls[:, None, None] + 1) * (2 * np.pi / L)
    lat = np.sin(freq * t * (1 + ch / C)) + 0.05 * rng.standard_normal((B, L, C))
    txt = np.zeros((B, Lc, D), np.float32)
    txt[np.arange(B), :, cls] = 1.0
    return (lat.astype(np.float32), txt, cls)


def features(lat):
    """Per-sample embedding for Frechet distance: mean/std over time of
    each channel + dominant-frequency energy split."""
    lat = np.asarray(lat, np.float32)
    mean = lat.mean(1)
    std = lat.std(1)
    spec = np.abs(np.fft.rfft(lat, axis=1))
    lo = spec[:, 1:5].mean(1)
    hi = spec[:, 5:16].mean(1)
    return np.concatenate([mean, std, lo, hi], axis=1)


def class_accuracy(out, cls) -> float:
    """Conditional fidelity: the dominant latent frequency -> class."""
    spec = np.abs(np.fft.rfft(np.asarray(out, np.float32).mean(-1), axis=1))
    spec[:, 0] = 0
    khat = np.clip(np.argmax(spec[:, 1:N_CLASS + 1], axis=1), 0, N_CLASS - 1)
    return float((khat == cls).mean())


def schedule() -> DDIMSchedule:
    return DDIMSchedule.from_config(DIFF_CFG)


def seeded_maskdit(model_cfg: dict, seed: int, device) -> torch.nn.Module:
    """A fresh MaskDiT with the modules' own initialisers, drawn on the CPU
    from ``seed`` (the same weights on every device), then moved."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = maskdit_from_config(dict(model_cfg))
    return model.to(device)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_toy(model, sched, steps: int, rng, device, log_every: int = 500,
              tag: str = "step", lr: float = 3e-4, warmup: int = 100) -> list:
    """The JAX harness's teacher loop: AdamW (clip 1, warmup), CFG dropout
    0.1, batch ``TRAIN_BATCH`` from ``rng``; step ``i`` draws from seed
    ``i``.  Returns the losses."""
    model.train().requires_grad_(True)
    step = make_train_step(model, sched, make_optimizer(model, learning_rate=lr, warmup=warmup),
                           cfg_dropout=0.1)
    B = TRAIN_BATCH
    uncond = np.zeros((1, Lc, D), np.float32)
    losses, t0 = [], time.time()
    for i in range(steps):
        lat, txt, _ = make_batch(rng, B)
        batch = to_device({"latents": lat, "text": txt, "text_mask": np.ones((B, Lc), bool),
                           "uncond": uncond, "uncond_mask": np.ones((1, Lc), bool)}, device)
        loss = step(batch, seed=i)["loss"]
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
            print(f"{tag} {i}: loss {losses[-1]:.4f} ({time.time() - t0:.0f}s)", flush=True)
    model.eval().requires_grad_(False)
    return losses


def eval_noise(shape, device) -> torch.Tensor:
    """The shared eval noise (JAX: ``PRNGKey(7)``), drawn on the CPU."""
    g = torch.Generator().manual_seed(NOISE_SEED)
    return torch.randn(*shape, generator=g).to(device)


def step_generator(device) -> torch.Generator:
    """The DDIM eta noise of one row (JAX: ``PRNGKey(8)`` for every row)."""
    return torch.Generator(device=device).manual_seed(STEP_NOISE_SEED)


# The toy table: the mid harness's rows (``quality_validate_mid.row_configs``
# at depth 4, so layer caching at k = 1) without its chunked_bf16 rows.
TOY_ROWS = (
    "DDIM-100 (reference default)", "DDIM-50", "DPM-Solver++(2M)-25", "DPM-Solver++(2M)-10",
    "DDIM-100 + interval(100,900)", "DDIM-100 + interval(300,800)",
    # int8 quality: EVERY linear quantized (threshold dropped to 0 —
    # harsher than the production setting, which skips small layers)
    "DDIM-100 int8 (all linears)",
    "DDIM-100 + layer_cache(k=1,m=2)", "DDIM-100 + layer_cache(k=1,m=4)",
    # the 36x-RT headline recipe: fewer steps x cheaper steps composed
    "DPM-25 + layer_cache(k=1,m=2) (36x recipe)",
)


def configs(sched) -> list:
    """The JAX harness's rows, ``(name, builder, recipe)`` in its order."""
    # imported here: quality_validate_mid imports this module
    from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

    return [c for c in qvm.row_configs(sched, MODEL_CFG["depth"]) if c[0] in TOY_ROWS]


@contextlib.contextmanager
def recipe_context(quant_int8: bool = False, attn_impl: Optional[str] = None):
    """A row's recipe: every linear int8 (``MIN_QUANT_ELEMENTS`` 0) and the
    attention implementation, restored after."""
    prev = quant_mod.MIN_QUANT_ELEMENTS
    if quant_int8:
        quant_mod.MIN_QUANT_ELEMENTS = 0
    try:
        with quant_mod.quant_context("int8" if quant_int8 else None), \
                attention_impl_context(attn_impl), torch.inference_mode():
            yield
    finally:
        quant_mod.MIN_QUANT_ELEMENTS = prev


def precision_line(device) -> str:
    dev = torch.device(device)
    if dev.type != "cuda":
        return "precision: f32 on the CPU"
    return (f"precision: f32, {torch.cuda.get_device_name(dev)}, TF32 matmul "
            f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}, cuDNN TF32 "
            f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}")


def parse_args(argv=None, prog="quality_validate"):
    p = argparse.ArgumentParser(prog=f"python -m ezaudio_tpu_torch.validation.{prog}")
    p.add_argument("steps", nargs="?", type=int, default=3000, help="teacher train steps")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

    args = parse_args(argv)
    device = resolve_device(args.device)
    print(precision_line(device), flush=True)
    sched = schedule()
    model = seeded_maskdit(MODEL_CFG, 0, device)
    rng = np.random.default_rng(0)
    train_toy(model, sched, args.steps, rng, device)

    # ---- evaluation -------------------------------------------------------
    lat_ref, txt_eval, cls_eval = make_batch(rng, N_EVAL)
    feats_ref = features(lat_ref)
    txt = torch.as_tensor(txt_eval, device=device)
    noise = eval_noise((N_EVAL, L, C), device)

    print("\n| sampler | FAD (latent feats) vs data | cond. class acc | s |")
    print("|---|---|---|---|")
    table = {}
    for name, builder, recipe in configs(sched):
        t0 = time.time()
        out = qvm.run_config(model, builder, noise, txt, N_EVAL, **recipe)
        sync(device)
        fad = frechet_audio_distance(features(out), feats_ref)
        acc = class_accuracy(out, cls_eval)
        table[name] = (fad, acc)
        print(f"| {name} | {fad:.3f} | {acc:.2f} | {time.time() - t0:.1f} |", flush=True)
    return table


if __name__ == "__main__":
    main()
