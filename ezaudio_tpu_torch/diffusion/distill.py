"""Progressive distillation (counterpart of ``ezaudio_tpu/diffusion/distill.py``;
Salimans & Ho, arXiv 2202.00512): a student trained to cover two teacher
DDIM steps with one of its own, then sampled with deterministic DDIM on
the halved grid, with no CFG pair: guidance is distilled into it.  The
student's step m spans the teacher's points ``2m -> 2m+2`` of
``step_tables(2N)``, with the teacher's own alpha values at both ends.

One eta=0 v-prediction DDIM step is affine in the model output,
``x' = A x + B v`` (:func:`_ab`), so the student regresses the closed-form
``v* = (x_target - A x) / B`` (:func:`v_target_from_endpoint`) onto the
teacher's two-step endpoint (:func:`teacher_two_step_target`), computed
without gradient.

In torch a student built from the teacher's own tensors would move the
teacher at every update: :func:`student_from_teacher` deep-copies, and
:func:`make_distill_step` refuses an optimizer that holds a teacher
tensor.  Quantization is off inside the step (int8 ``round`` has no
gradient).  Every draw of step ``n`` comes from a generator seeded from
``(seed, n)``; ``draws=`` takes the JAX package's instead (ROADMAP F1).
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.training.trainer import StepLoop


class DistillTables(NamedTuple):
    """Aligned student/teacher DDIM tables for one halving stage.

    Student step m: ``a_t[m] -> a_prev[m]`` at timestep ``ts[m]``; the
    teacher covers the same span ``a_t[m] -> a_mid[m] -> a_prev[m]`` with
    its intermediate call at ``ts_mid[m]``.
    """

    a_t: np.ndarray
    a_mid: np.ndarray
    a_prev: np.ndarray
    ts: np.ndarray
    ts_mid: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.ts.shape[0]


def distill_tables(schedule: DDIMSchedule, num_student_steps: int) -> DistillTables:
    a_t2, a_prev2, ts2 = schedule.step_tables(2 * num_student_steps)
    return DistillTables(a_t=a_t2[0::2], a_mid=a_t2[1::2], a_prev=a_prev2[1::2],
                         ts=ts2[0::2], ts_mid=ts2[1::2])


def distilled_sample(student_fn: Callable, schedule: DDIMSchedule, noise: torch.Tensor,
                     tables: DistillTables) -> torch.Tensor:
    """Deterministic DDIM on the student's grid, single batch, no CFG."""
    x = noise
    for m in range(tables.num_steps):
        v = student_fn(x, int(tables.ts[m]))
        x = schedule.ddim_step(v, x, float(tables.a_t[m]), float(tables.a_prev[m]),
                               eta=0.0).to(noise.dtype)
    return x


def _ab(a, a_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The affine DDIM coefficients: one eta=0 v-prediction step is
    ``x' = A x + B v``."""
    A = (a_prev * a).sqrt() + ((1.0 - a_prev) * (1.0 - a)).sqrt()
    B = ((1.0 - a_prev) * a).sqrt() - (a_prev * (1.0 - a)).sqrt()
    return A, B


def _table(values: np.ndarray, m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``values[m]`` as f32 on ``like``'s device, shaped (B, 1, ...) to
    broadcast against ``like``."""
    v = torch.as_tensor(values, device=like.device)[m.long()]
    return v.reshape(v.shape + (1,) * (like.ndim - 1)).float()


def teacher_two_step_target(teacher_fn: Callable, schedule: DDIMSchedule, x: torch.Tensor,
                            m: torch.Tensor, tables: DistillTables) -> torch.Tensor:
    """Two teacher DDIM steps across the student's step ``m`` (B,) span."""
    a_t, a_mid, a_prev = (_table(t, m, x) for t in (tables.a_t, tables.a_mid, tables.a_prev))
    v0 = teacher_fn(x, torch.as_tensor(tables.ts, device=x.device)[m.long()])
    x_mid = schedule.ddim_step(v0, x, a_t, a_mid, eta=0.0)
    v1 = teacher_fn(x_mid, torch.as_tensor(tables.ts_mid, device=x.device)[m.long()])
    return schedule.ddim_step(v1, x_mid, a_mid, a_prev, eta=0.0)


def v_target_from_endpoint(x: torch.Tensor, x_target: torch.Tensor, a, a_prev) -> torch.Tensor:
    """The v for which one DDIM step from ``x`` (alpha-bar ``a``) lands
    exactly on ``x_target`` (``a_prev``)."""
    A, B = _ab(a, a_prev)
    return (x_target - A * x) / B


def student_from_teacher(teacher: nn.Module) -> nn.Module:
    """The student a stage starts from: a deep copy of the teacher, in
    train mode with gradients on; the teacher is frozen (eval, no grad)."""
    teacher.eval().requires_grad_(False)
    return copy.deepcopy(teacher).train().requires_grad_(True)


class DistillStep(StepLoop):
    """``step(batch, seed, draws=None) -> {"loss"}`` (and ``"grads"`` with
    ``return_grads``): one distillation step
    of the student whose parameters ``optimizer`` holds.

    ``student_apply(x, t, batch) -> v`` (single batch, no CFG);
    ``teacher_fn_builder(batch[, teacher]) -> teacher_fn(x, t) -> v`` (the
    teacher applies CFG itself: guidance is distilled in).  ``batch``
    carries ``latents`` (the clean x0) and whatever the two closures read.
    draws: ``m`` (B,) int student steps, ``eps`` the noise like ``latents``.
    """

    def __init__(self, student_apply: Callable, teacher_fn_builder: Callable,
                 schedule: DDIMSchedule, optimizer, tables: DistillTables,
                 teacher: Optional[nn.Module] = None):
        if schedule.prediction_type != "v_prediction":
            raise NotImplementedError("the closed-form target is the v-parameterization")
        if teacher is not None:
            held = {p.data_ptr() for p in teacher.parameters()}
            if any(p.data_ptr() in held for p in optimizer.params.values()):
                raise ValueError("the student shares tensors with the teacher: build it "
                                 "with student_from_teacher (a deep copy)")
        self.student_apply, self.builder = student_apply, teacher_fn_builder
        self.schedule, self.optimizer, self.tables = schedule, optimizer, tables
        self.teacher = teacher
        self.params = optimizer.params
        self.step = 0

    def draw(self, generator: torch.Generator, like: torch.Tensor) -> dict:
        B = like.shape[0]
        return dict(m=torch.randint(0, self.tables.num_steps, (B,), generator=generator,
                                    device=like.device),
                    eps=torch.randn(like.shape, generator=generator, device=like.device))

    def loss(self, batch: dict, draws: dict) -> torch.Tensor:
        x0 = batch["latents"].float()
        m, eps = draws["m"], draws["eps"].to(x0.dtype)
        a, a_prev = _table(self.tables.a_t, m, x0), _table(self.tables.a_prev, m, x0)
        x_t = a.sqrt() * x0 + (1.0 - a).sqrt() * eps
        teacher_fn = (self.builder(batch) if self.teacher is None
                      else self.builder(batch, self.teacher))
        with torch.no_grad():
            x_tgt = teacher_two_step_target(teacher_fn, self.schedule, x_t, m, self.tables)
        v_star = v_target_from_endpoint(x_t, x_tgt, a, a_prev)
        ts = torch.as_tensor(self.tables.ts, device=x0.device)[m.long()]
        v = self.student_apply(x_t, ts, batch)
        return (v.float() - v_star).square().mean()

    def draw_for(self, generator: torch.Generator, batch: dict) -> dict:
        return self.draw(generator, batch["latents"])

    def update(self, grads: dict) -> dict:
        self.optimizer.update(grads)
        return {}


def make_distill_step(student_apply, teacher_fn_builder, schedule, optimizer, tables,
                      teacher=None) -> DistillStep:
    return DistillStep(student_apply, teacher_fn_builder, schedule, optimizer, tables, teacher)
