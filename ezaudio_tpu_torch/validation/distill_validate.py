"""Progressive-distillation validation on a model the port trains itself
(counterpart of ``scripts/distill_validate.py``).

Trains the same tiny conditional MaskDiT as ``quality_validate``, then runs
two halving stages of progressive distillation (16 -> 8 -> 4 student
steps) with CFG distilled into the student, and scores each stage's
samples with the same Frechet-distance harness.  The distilled student
samples with no CFG pair, so its per-step cost is half a guided DDIM
step's: distilled-4 costs ~2 % of DDIM-100 with CFG.

    python -m ezaudio_tpu_torch.validation.distill_validate [teacher_steps] \
        [--distill-steps 4000] [--device cpu]

The training and distillation batches come from one
``np.random.default_rng(0)``, in the JAX harness's order; distillation
step ``i`` draws from seed ``10_000 + i`` (JAX: ``PRNGKey(10_000 + i)``).
Writes a markdown table to stdout.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance
from ezaudio_tpu_torch.diffusion.distill import (distill_tables, make_distill_step,
                                                 student_from_teacher)
from ezaudio_tpu_torch.training.optim import make_optimizer
from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation import quality_validate as qv
from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

# model calls per sample of each row (a CFG pair counts twice)
CALLS = {"teacher DDIM-100 + CFG (reference recipe)": 200,
         "teacher DDIM-16 + CFG": 32,
         "distilled-8 (no CFG pair)": 8,
         "distilled-4 (no CFG pair)": 4}


def student_apply(model):
    def apply(x, t, batch):
        t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
        return model(x, t, batch["text"])[0]
    return apply


def guided_builder(guidance: float):
    """The guided teacher: one call on the cond/uncond pair."""
    def builder(batch, teacher):
        def fn(x, t):
            t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
            ctx = torch.cat([batch["text"], torch.zeros_like(batch["text"])], dim=0)
            cond, unc = teacher(torch.cat([x, x], 0), torch.cat([t, t], 0), ctx)[0].chunk(2, 0)
            return unc + guidance * (cond - unc)
        return fn
    return builder


def plain_builder(batch, teacher):
    """The unguided teacher: later stages distill the already-guided student."""
    return lambda x, t: student_apply(teacher)(x, t, batch)


def distill_stages(teacher, sched, steps: int, batches, seed0: int, guidance: float,
                   log_every: int = 1000, stages=(8, 4)) -> dict:
    """Two halving stages 16 -> 8 -> 4, CFG distilled in at the first;
    ``batches()`` gives one training batch (a dict of tensors: ``latents``
    and ``text``).  Returns ``{n_student: student}``."""
    out, t_model = {}, teacher
    for si, n_student in enumerate(stages):
        tables = distill_tables(sched, n_student)
        student = student_from_teacher(t_model)
        opt = make_optimizer(student, learning_rate=1e-4, warmup=100)
        dstep = make_distill_step(student_apply(student),
                                  guided_builder(guidance) if si == 0 else plain_builder,
                                  sched, opt, tables, teacher=t_model)
        t0 = time.time()
        for i in range(steps):
            loss = dstep(batches(), seed=seed0 + i)["loss"]
            if i % log_every == 0 or i == steps - 1:
                print(f"  [distill {16 >> si}->{n_student}] step {i}: loss {float(loss):.5f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        student.eval().requires_grad_(False)
        out[n_student] = t_model = student
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m ezaudio_tpu_torch.validation.distill_validate")
    p.add_argument("steps", nargs="?", type=int, default=3000, help="teacher train steps")
    p.add_argument("--distill-steps", type=int, default=4000,
                   help="steps of each distillation stage (DISTILL_STEPS)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(qv.precision_line(device), flush=True)
    guidance = qv.GUIDANCE
    sched = qv.schedule()
    teacher = qv.seeded_maskdit(qv.MODEL_CFG, 0, device)
    rng = np.random.default_rng(0)
    qv.train_toy(teacher, sched, args.steps, rng, device, log_every=1000, tag="teacher step")

    def batches():
        lat, txt, _ = qv.make_batch(rng, qv.TRAIN_BATCH)
        return qv.to_device({"latents": lat, "text": txt}, device)

    students = distill_stages(teacher, sched, args.distill_steps, batches, 10_000, guidance)

    # ---- evaluation: the same harness and seeds as quality_validate -------
    lat_ref, txt_eval, cls_eval = qv.make_batch(rng, qv.N_EVAL)
    feats_ref = qv.features(lat_ref)
    txt = torch.as_tensor(txt_eval, device=device)
    noise = qv.eval_noise((qv.N_EVAL, qv.L, qv.C), device)
    rows = {  # name -> (model, builder, CFG pair)
        "teacher DDIM-100 + CFG (reference recipe)": (teacher, qvm.ddim(sched, 100), True),
        "teacher DDIM-16 + CFG": (teacher, qvm.ddim(sched, 16), True),
    }
    for n in (8, 4):
        rows[f"distilled-{n} (no CFG pair)"] = (students[n], qvm.distilled_builder(sched, n),
                                                False)

    print("\n| sampler | FAD (latent feats) vs data | cond. acc | model calls / sample | s |")
    print("|---|---|---|---|---|")
    table = {}
    for name, (model, builder, pair) in rows.items():
        t0 = time.time()
        out = qvm.run_config(model, builder, noise, txt, qv.N_EVAL, pair=pair)
        qv.sync(device)
        fad = frechet_audio_distance(qv.features(out), feats_ref)
        acc = qv.class_accuracy(out, cls_eval)
        table[name] = (fad, acc)
        print(f"| {name} | {fad:.3f} | {acc:.2f} | {CALLS[name]} | {time.time() - t0:.1f} |",
              flush=True)
    return table


if __name__ == "__main__":
    main()
