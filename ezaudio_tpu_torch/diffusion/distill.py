"""Sampling with a progressively distilled student, the inference half of
``ezaudio_tpu/diffusion/distill.py`` (Salimans & Ho, arXiv 2202.00512).

A student trained to cover two teacher DDIM steps with one samples with
deterministic DDIM on the halved grid, with no CFG pair: guidance was
distilled into it.  The student's step m spans the teacher's points
``2m -> 2m+2`` of ``step_tables(2N)``, with the teacher's own alpha values
at both ends.  Training a student waits for the training slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule


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
