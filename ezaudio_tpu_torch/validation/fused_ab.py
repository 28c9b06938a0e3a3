"""Staged against fused ``generate_audio`` in one process (counterpart of
``scripts/fused_ab.py``), at the fast recipe and the reference recipe.

Each recipe runs staged, then ``fused=True`` (the whole pipeline as one
CUDA graph per signature, ``api/graphs.py``): one warm call (seed 0, which
captures the fused graph), then 5 timed calls with seeds 0-4, each ending
when the waveform is on the host; the median is the batch's time.  The
script's three lines per recipe follow: ms per batch and audio-s/s per GPU
staged and fused, and the fused delta.  The fused waveform of seed 0 must
equal the staged one (the same kernels on the same inputs in the same
order, ``tests/test_torch_fused.py``); a difference raises.

The model is the script's: s3_xl in bf16 with the tiny T5
(``serving_bench.build_ezaudio``), seeded random weights.

    python -m ezaudio_tpu_torch.validation.fused_ab [--model s3_xl] [--batch 4] \
        [--device cpu]

``--model`` and ``--batch`` are the script's ``BENCH_MODEL`` and
``BENCH_BATCH``; ``--steps`` and ``--length`` cut both recipes' steps and
the clip length (the script's are 25 and 100, and 10 s).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation.quality_validate import precision_line
from ezaudio_tpu_torch.validation.serving_bench import build_ezaudio

PROMPTS = ["a dog barking in the distance", "heavy rain on a tin roof",
           "a car engine starting", "birds chirping in a forest"]
FAST = dict(ddim_steps=25, sampler="dpm", layer_cache=(2, 2), attn_impl="chunked_bf16",
            quant="int8", guidance_interval=(300.0, 800.0))
REF = dict(ddim_steps=100, sampler="ddim")
RECIPES = [("fast+gi recipe", FAST), ("reference recipe", REF)]
REPS = 5


def measure(ez, prompts, fused: bool, length: float, **kw):
    """``(median s of REPS calls, seed 0's waveform)`` after one warm call."""
    kw = dict(length=length, fused=fused, **kw)
    ez.generate_audio(prompts, random_seed=0, **kw)  # warm-up; the fused capture
    times, first = [], None
    for i in range(REPS):
        t0 = time.perf_counter()
        _, wav = ez.generate_audio(prompts, random_seed=i, **kw)
        wav = np.asarray(wav)  # on the host already: generate_audio returns numpy
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = wav
    return statistics.median(times), first


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m ezaudio_tpu_torch.validation.fused_ab")
    p.add_argument("--model", default="s3_xl")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=None,
                   help="both recipes' steps (the script's: 25 and 100)")
    p.add_argument("--length", type=float, default=10.0, help="the clip length, s")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None, *, ez=None) -> list:
    """Both recipes staged and fused; ``ez`` replaces the scripts' model
    (tests pass a tiny one).  Returns one row per recipe."""
    a = parse_args(argv)
    if ez is None:
        ez = build_ezaudio(a.model, resolve_device(a.device))
    print(precision_line(ez.device, ez.dtype), flush=True)
    prompts = (PROMPTS * ((a.batch + 3) // 4))[:a.batch]
    rows = []
    for name, recipe in RECIPES:
        kw = dict(recipe, **({} if a.steps is None else dict(ddim_steps=a.steps)))
        t_staged, w_staged = measure(ez, prompts, False, a.length, **kw)
        t_fused, w_fused = measure(ez, prompts, True, a.length, **kw)
        err = float(np.abs(w_fused - w_staged).max())
        audio = a.batch * a.length
        row = dict(recipe=name, batch=a.batch, steps=kw["ddim_steps"], length_s=a.length,
                   staged_ms=t_staged * 1e3, fused_ms=t_fused * 1e3,
                   staged_audio_s_per_s=audio / t_staged, fused_audio_s_per_s=audio / t_fused,
                   fused_delta=t_staged / t_fused - 1, max_abs_err=err,
                   wav_shape=list(w_fused.shape))
        print(f"[{name}, staged] {row['staged_ms']:.0f} ms/batch{a.batch} = "
              f"{row['staged_audio_s_per_s']:.2f} audio-s/s/GPU")
        print(f"[{name}, FUSED]  {row['fused_ms']:.0f} ms/batch{a.batch} = "
              f"{row['fused_audio_s_per_s']:.2f} audio-s/s/GPU")
        print(f"  fused delta: {row['fused_delta'] * 100:+.1f}% (fused against staged, seed 0: "
              f"max |diff| {err:.3g})", flush=True)
        if not np.isfinite(w_fused).all() or err != 0.0:
            raise AssertionError(f"{name}: the fused waveform differs from the staged one by "
                                 f"{err}")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
