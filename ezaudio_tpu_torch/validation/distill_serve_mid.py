"""Train, distill, save, reload and serve a mid-scale student end to end
(counterpart of ``scripts/distill_serve_mid.py``).

The pipeline, all through the port's public surfaces:
  1. a mid-scale ``EzAudio`` (depth 12 / dim 512 / 8 heads, the production
     Oobleck VAE geometry of ``vae.json``, the tiny T5 of
     ``mid_common.MID_T5``): conditioning is the real prompt -> tokenizer ->
     T5 path, so serving reproduces training's conditioning;
  2. the VAE briefly fitted, the 4-class audio distribution encoded through
     ``ez.autoencoder`` and the DiT teacher trained (``mid_common``);
  3. progressive distillation 16 -> 8 -> 4 with CFG folded in at stage 1
     (guidance 3.0 against the empty prompt's embedding,
     ``diffusion/distill.py``), each stage cached on disk;
  4. ``save_model`` of the student with its metadata (``distilled_steps``,
     ``guidance``, ``latent_mu``, ``latent_sd``), ``load_model`` back;
  5. the teacher (DDIM-100 + CFG 3.0, rescale 0) and the reloaded student
     (``sampler='distilled'``, 4 calls, no CFG pair) served through
     ``GenerationServer`` with the same prompts and seeds; FAD over the
     re-encoded audio's latent features (the reference side passes through
     the same decode -> encode round trip), the conditional accuracy, the
     served audio-s/s and the wall.

Each model is loaded into ``ez.dit`` in place (``load_state_dict``), never
rebound, so the server sees the weights it is asked to serve.  The student
is a deep copy (``distill.student_from_teacher``); the teacher stays frozen.

    python -m ezaudio_tpu_torch.validation.distill_serve_mid [--depth 12] ...
    CPU smoke: --device cpu --depth 2 --dim 64 --frames 50 --train-steps 30
               --distill-steps 20 --n-train 32 --n-eval 16

Each ``DS_*`` knob of the JAX script is the flag of the same name
(``DS_TRAIN_STEPS`` -> ``--train-steps``, ``DS_CKPT`` -> ``--ckpt``, ...).
Caches live under ``--cache-root`` (default ``mid_common.default_cache_root()``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.diffusion.distill import (distill_tables, make_distill_step,
                                                 student_from_teacher)
from ezaudio_tpu_torch.serving import GenerationServer
from ezaudio_tpu_torch.training.model_io import load_model, save_model
from ezaudio_tpu_torch.training.optim import make_optimizer
from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation import mid_common as mc
from ezaudio_tpu_torch.validation.quality_validate import precision_line
from ezaudio_tpu_torch.validation.quality_validate_mid import features, latent_class

STAGES = (8, 4)  # 16 -> 8 -> 4
TEACHER_STEPS = 100  # the served teacher's DDIM steps
DISTILL_SEED0 = 50_000  # distillation step i draws from seed DISTILL_SEED0 + i


def student_apply(model):
    """The student on its own batch: one call, no CFG pair."""
    def apply(x, t, batch):
        t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
        return model(x, t, batch["text"], context_mask=batch.get("text_mask"))[0]
    return apply


def guided_builder(unc_emb: torch.Tensor, unc_mask: torch.Tensor, guidance: float):
    """The guided teacher of stage 1: one call on the pair [prompt; empty
    prompt], ``unc + guidance * (cond - unc)``."""
    def builder(batch, teacher):
        def fn(x, t):
            B = x.shape[0]
            t = torch.as_tensor(t, device=x.device).expand(B)
            ctx = torch.cat([batch["text"], unc_emb.expand(B, *unc_emb.shape[1:])], 0)
            cm = torch.cat([batch["text_mask"], unc_mask.expand(B, *unc_mask.shape[1:])], 0)
            out = teacher(torch.cat([x, x], 0), torch.cat([t, t], 0), ctx, context_mask=cm)[0]
            cond, unc = out.chunk(2, 0)
            return unc + guidance * (cond - unc)
        return fn
    return builder


def plain_builder(batch, teacher):
    """The unguided teacher of later stages (the stage-1 student)."""
    return lambda x, t: student_apply(teacher)(x, t, batch)


def stage_dir(a, n_student: int) -> str:
    return os.path.join(a.cache_root, "ds_stages",
                        f"d{a.depth}_w{a.dim}_L{a.frames}_t{a.train_steps}_ds{a.distill_steps}"
                        f"_b{a.batch}_to{n_student}")


def distill(teacher, data: dict, schedule, a, log_every: int = 500) -> torch.nn.Module:
    """Progressive distillation of ``teacher`` (frozen, untouched) through
    ``STAGES``: each stage's student a deep copy of its teacher, AdamW at lr
    1e-4 with warmup 100, batches of rows from one
    ``np.random.default_rng(7)``; a finished stage is cached under
    :func:`stage_dir` and reused (without its draws from the shared rng).
    Returns the last student, frozen."""
    device = next(teacher.parameters()).device
    unc_emb = torch.as_tensor(data["unc_emb"], device=device)
    unc_mask = torch.as_tensor(data["unc_mask"], device=device)
    rng = np.random.default_rng(7)
    n_train = len(data["m_train"])
    t_model = teacher
    for si, n_student in enumerate(STAGES):
        folder = stage_dir(a, n_student)
        student = student_from_teacher(t_model)
        if os.path.exists(os.path.join(folder, "params.npz")):
            cached, _ = mc._load_params(folder)
            student.load_state_dict(cached)
            print(f"  [distill ->{n_student}] reusing cached stage: {folder}", flush=True)
            t_model = student.eval().requires_grad_(False)
            continue
        builder = guided_builder(unc_emb, unc_mask, mc.GUIDANCE) if si == 0 else plain_builder
        dstep = make_distill_step(student_apply(student), builder, schedule,
                                  make_optimizer(student, learning_rate=1e-4, warmup=100),
                                  distill_tables(schedule, n_student), teacher=t_model)
        t1 = time.time()
        for i in range(a.distill_steps):
            idx = rng.integers(0, n_train, a.batch)
            cls = data["cls_train"][idx]
            batch = {"latents": torch.as_tensor(data["m_train"][idx], device=device),
                     "text": torch.as_tensor(data["cond_emb"][cls], device=device),
                     "text_mask": torch.as_tensor(data["cond_mask"][cls], device=device)}
            loss = dstep(batch, seed=DISTILL_SEED0 + i)["loss"]
            if i % log_every == 0 or i == a.distill_steps - 1:
                print(f"  [distill {16 >> si}->{n_student}] step {i}: loss {float(loss):.5f} "
                      f"({time.time() - t1:.0f}s)", flush=True)
        t_model = student.eval().requires_grad_(False)
        mc._save_params(folder, student.state_dict(),
                        {"stage": n_student, "steps": a.distill_steps})
        print(f"  [distill ->{n_student}] stage cached: {folder}", flush=True)
    return t_model


def save_student(path: str, student, model_cfg: dict, mu: float, sd: float):
    """The student as a ``model_io`` bundle, read back: ``(module, meta)``."""
    save_model(path, "maskdit", {"model": dict(model_cfg)}, student,
               extra_metadata={"distilled_steps": STAGES[-1], "guidance": mc.GUIDANCE,
                               "latent_mu": mu, "latent_sd": sd})
    return load_model(path)


def serve(ez, prompts, length_s: float, serve_batch: int, **server_kw):
    """``prompts`` (request ``i`` seeded ``i``) through one
    ``GenerationServer``: ``(waveforms (n, T), wall s, the server's stats)``."""
    wavs = np.zeros((len(prompts), int(length_s * ez.sr)), np.float32)
    t0 = time.time()
    with GenerationServer(ez, max_batch_size=serve_batch, length=length_s, **server_kw) as srv:
        futs = [srv.submit(p, seed=i) for i, p in enumerate(prompts)]
        for i, f in enumerate(futs):
            _, w = f.result(timeout=3600)
            wavs[i, :len(w)] = w[:wavs.shape[1]]
    return wavs, time.time() - t0, dict(srv.stats)


def score(ez, wavs: np.ndarray, data: dict, feats_ref: np.ndarray, cls: np.ndarray):
    """``(FAD, conditional accuracy)`` of served waveforms of classes
    ``cls``: re-encoded into model space, their latent features against
    ``feats_ref``."""
    m_gen = (mc.encode(ez, wavs) - data["mu"]) / data["sd"]
    return (frechet_audio_distance(features(m_gen), feats_ref),
            float((latent_class(m_gen) == cls).mean()))


TEACHER_ROW = "teacher DDIM-100 + CFG (served)"
STUDENT_ROW = "distilled-4 student from RELOADED ckpt (served)"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m ezaudio_tpu_torch.validation.distill_serve_mid",
        description="Each flag is the JAX script's DS_* knob of the same name.")
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--train-steps", type=int, default=4000)
    p.add_argument("--distill-steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--n-eval", type=int, default=128)
    p.add_argument("--serve-batch", type=int, default=16)
    p.add_argument("--vae-steps", type=int, default=1500)
    p.add_argument("--ckpt", default=None,
                   help="the student bundle (default: <cache-root>/ds_student_ckpt)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--cache-root", default=None,
                   help="caches (default: outside the checkout, mid_common.default_cache_root)")
    a = p.parse_args(argv)
    a.cache_root = a.cache_root or mc.default_cache_root()
    a.ckpt = a.ckpt or os.path.join(a.cache_root, "ds_student_ckpt")
    return a


def main(argv=None, *, vae_config: Optional[dict] = None):
    """Run the pipeline; ``vae_config`` replaces ``vae.json`` (tests run a
    tiny one).  Returns the two served rows ``(name, FAD, acc, audio-s/s,
    wall s)``."""
    a = parse_args(argv)
    device = resolve_device(a.device)
    print(precision_line(device), flush=True)
    walls = {}
    t0 = time.time()
    ez, cfg, model_cfg, _ = mc.build_mid_ezaudio(a.depth, a.dim, a.heads, a.frames,
                                                 device=device, vae_config=vae_config)
    mc.fit_vae(ez, steps=a.vae_steps, cache_root=a.cache_root)
    walls["vae_fit_s"] = time.time() - t0
    length_s = a.frames / ez.latent_sr
    t0 = time.time()
    data = mc.prepare_data(ez, a.frames, a.n_train, a.n_eval, cache_root=a.cache_root)
    walls["data_s"] = time.time() - t0
    mu, sd, cls_eval = data["mu"], data["sd"], data["cls_eval"]
    schedule = DDIMSchedule.from_config(cfg["diff"])
    t0 = time.time()
    teacher = mc.train_teacher(ez, model_cfg, data, a.train_steps, a.batch,
                               cache_root=a.cache_root)
    teacher_sd = {k: v.clone() for k, v in teacher.state_dict().items()}
    walls["teacher_s"] = time.time() - t0

    t0 = time.time()
    student = distill(teacher, data, schedule, a)
    walls["distill_s"] = time.time() - t0
    loaded, meta = save_student(a.ckpt, student, model_cfg, mu, sd)
    print(f"student checkpoint saved+reloaded: {a.ckpt} (metadata {meta})", flush=True)
    del student

    feats_ref = features(mc.roundtrip_latents(ez, data["m_eval"], mu, sd))
    print(f"ref roundtrip feature spread: {float(feats_ref.std(0).mean()):.4f} "
          f"(0 would make FAD degenerate)", flush=True)
    prompts = [mc.PROMPTS[c] for c in cls_eval]

    def serve_and_score(tag, **server_kw):
        wavs, wall, _ = serve(ez, prompts, length_s, a.serve_batch, **server_kw)
        thr = len(prompts) * length_s / wall
        fad, acc = score(ez, wavs, data, feats_ref, cls_eval)
        print(f"| {tag} | {fad:.3f} | {acc:.2f} | {thr:.2f} | {wall:.1f} |", flush=True)
        return tag, fad, acc, thr, wall

    print("\n| served config | FAD (roundtrip latent feats) | cond acc | audio-s/s | wall s |")
    print("|---|---|---|---|---|", flush=True)
    ez.dit.load_state_dict(teacher_sd)
    rows = [serve_and_score(TEACHER_ROW, ddim_steps=TEACHER_STEPS,
                            guidance_scale=mc.GUIDANCE, guidance_rescale=0.0)]
    ez.dit.load_state_dict(loaded.state_dict())
    rows.append(serve_and_score(STUDENT_ROW, sampler="distilled", ddim_steps=STAGES[-1]))
    print("stage walls " + json.dumps(walls), flush=True)
    return rows


if __name__ == "__main__":
    main()
