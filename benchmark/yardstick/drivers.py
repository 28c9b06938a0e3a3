"""One driver per traffic kind: set-up, warm-up, the measured (or traced)
window, and the check of what the window produced against the plain
reference.  A driver fills a :class:`Run`, which the metric readers read.

Kinds:

  * ``t2a_closed``: back-to-back ``EzAudio.generate_audio`` calls of
    ``batch`` distinct prompts; the window ends with the first call that
    ends past ``--seconds``.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from yardstick import program, stepwise, traffic as tf
from yardstick import reference as ref
from yardstick.flops import t2a_call_flops
from yardstick.trace import Tracer
from yardstick.weights import make_weights, reference_pipeline


class Run:
    """The record of one run, as the metric readers see it."""

    def __init__(self, ctx: "Context"):
        self.kind = ctx.traffic["kind"]
        self.config, self.traffic = ctx.config, ctx.traffic
        self.setup_s: Optional[float] = None
        self.calls: List[dict] = []      # t2a: start, end, clips, audio_s, flops
        self.counters: Dict[str, object] = {}
        self.trace = None                # TraceSummary of a traced run
        self.checks: Dict[str, tuple] = {}  # name -> (value, limit)
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.setup_parts = ctx.setup_parts  # s from process start to each phase's end


class Context:
    def __init__(self, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float, hooks: Optional[dict] = None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.seconds, self.trace, self.device = float(seconds), bool(trace), torch.device(device)
        self.t_start = t_start
        self.hooks = hooks or {}  # test seams: 'after_build'(program object)
        self.control: Optional[str] = None  # calibration: also read the control in this precision
        self.check_first = False  # calibration: check the window's first call
        self.cuda = self.device.type == "cuda"
        self.setup_parts: Dict[str, float] = {}
        self.mark("imports")

    def mark(self, phase: str) -> None:
        """Note the end of a set-up phase (after the device has caught up)."""
        self.sync()
        self.setup_parts[phase] = time.perf_counter() - self.t_start

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def rng(self, stream: int) -> np.random.Generator:
        """Independent streams of the seed: 0 traffic, 1 the check's sample,
        2 the warm-up's prompts."""
        return np.random.default_rng((self.seed, stream))

    def weights(self):
        return make_weights(self.config, self.seed, self.device)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0


def rel_err(a, b) -> float:
    """``||a - b|| / ||b||`` over float64."""
    a = torch.as_tensor(np.asarray(a), dtype=torch.float64)
    b = torch.as_tensor(np.asarray(b), dtype=torch.float64)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ---------------------------------------------------------------- text-to-audio

def reference_clips(pipe, texts, seed: int, batch: int, rows, frames: int, recipe: dict, device,
                    prec: str = "f32"):
    """The reference's clips of ``rows`` of a ``batch``-prompt call with
    ``random_seed=seed``: the starting noise and each step's eta noise are
    the call's generator's draws for the whole batch, of which the rows
    are kept."""
    C = pipe.config["model"]["out_chans"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = lambda: torch.randn((batch, frames, C), generator=gen, device=device)[rows]  # noqa: E731
    noise = draw()
    with torch.no_grad(), ref.math_mode(prec):
        return pipe.generate(list(texts), noise, recipe, step_noise=lambda i: draw()).cpu()


def run_t2a(ctx: Context) -> Run:
    run, tr, cfg = Run(ctx), ctx.traffic, ctx.config
    rng, pick = ctx.rng(0), ctx.rng(1)
    B, secs, recipe = tr["batch"], float(tr["seconds"]), tr["recipe"]
    kw = dict(program.recipe_kwargs(recipe), length=secs)
    ez = program.build_ezaudio(cfg, ctx.weights(), tr["dtype"], ctx.device)
    ctx.free()
    ctx.mark("build")
    ez = ctx.hooks.get("after_build", lambda o: o)(ez)
    # the call and rows the check compares, drawn before the window
    checked = 0 if ctx.trace or ctx.check_first else int(pick.integers(tr["probe_calls"]))
    rows = np.sort(pick.choice(B, size=tr["check_rows"], replace=False))
    probe = stepwise.Probe(ez) if tr["check"] == "steps" else None
    # the warm-up call also makes the empty prompt's embedding that every
    # later call takes from the program's cache: the probe reads its pass
    with probe.uncond(rows) if probe is not None else contextlib.nullcontext():
        ez.generate_audio(tf.prompts(ctx.rng(2), B), random_seed=0,
                          **dict(kw, ddim_steps=tr["warmup_steps"]))
    ctx.sync()
    run.setup_s = time.perf_counter() - ctx.t_start
    flops = t2a_call_flops(cfg, B, secs, recipe["steps"])
    outputs, rec = [], None
    tracer = Tracer(ctx.trace, ctx.cuda)
    before = program.kernel_launches()
    with tracer.window():
        w0 = time.perf_counter()
        while True:
            texts, seed = tf.prompts(rng, B), tf.seeds(rng, 1)[0]
            on = probe is not None and len(run.calls) == checked
            t0 = time.perf_counter()
            with probe.on(rows) if on else contextlib.nullcontext():
                _, wav = ez.generate_audio(texts, random_seed=seed, **kw)
            t1 = time.perf_counter()
            run.calls.append(dict(start=t0 - w0, end=t1 - w0, clips=B, audio_s=B * secs,
                                  flops=flops))
            outputs.append((texts, seed, wav))
            if on:
                rec = probe.record(wav[rows])
            if (len(run.calls) >= tr["trace_calls"]) if ctx.trace else (
                    t1 - w0 >= ctx.seconds and len(run.calls) > checked):
                break
    run.trace = tracer.summary
    run.counters["launches"] = _delta(before, program.kernel_launches())
    run.memory_peak_bytes = ctx.peak()
    run.attempted = B * len(run.calls)
    run.failed = sum(int(not np.isfinite(row).all()) for _, _, wav in outputs for row in wav)
    del ez, probe
    ctx.free()
    texts, seed, wav = outputs[checked]
    _check_t2a(ctx, run, texts, seed, wav, rows, rec, pick)
    return run


def _draws(seed: int, batch: int, frames: int, C: int, rows, n: int, device):
    """The first ``n`` draws of a call's generator seeded ``seed``, each for
    the whole batch, of which ``rows`` are kept: the starting latents, then
    each DDIM step's eta noise."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [torch.randn((batch, frames, C), generator=gen, device=device)[rows]
            for _ in range(n)]


def _check_t2a(ctx: Context, run: Run, texts, seed, wav, rows, rec, pick) -> None:
    """``clip``: the rows' clips against the reference's; ``steps``: the
    step-wise check of the probed call (:mod:`stepwise`)."""
    tr, cfg = ctx.traffic, ctx.config
    frames = int(float(tr["seconds"]) * cfg["autoencoder"]["latent_sr"])
    rows_t = torch.as_tensor(rows, device=ctx.device)
    texts = [texts[r] for r in rows]
    recipe = tr["recipe"]
    if tr["check"] == "steps":
        draws = _draws(seed, tr["batch"], frames, cfg["model"]["out_chans"], rows_t,
                       recipe["steps"] + 1, ctx.device)
        sample = stepwise.step_sample(pick, recipe["steps"], tr["check_steps_sampled"])
        _stepwise(ctx, run, rec, texts, draws[0], draws[1:], recipe, sample)
        return
    pipe = reference_pipeline(cfg, ctx.weights(), ctx.device)
    want = reference_clips(pipe, texts, seed, tr["batch"], rows_t, frames, recipe, ctx.device)
    err = max(rel_err(wav[r], want[i]) for i, r in enumerate(rows))
    run.checks["wave_rel_err"] = (err, tr["limits"]["wave_rel_err"])
    del pipe
    ctx.free()
    if ctx.control:
        pipe = reference_pipeline(cfg, ctx.weights(), ctx.device, ctx.control)
        got = reference_clips(pipe, texts, seed, tr["batch"], rows_t, frames, recipe,
                              ctx.device, ctx.control)
        run.counters["control.wave_rel_err"] = max(rel_err(got[i], want[i])
                                                   for i in range(len(rows)))
        del pipe
        ctx.free()


def _stepwise(ctx: Context, run: Run, rec, texts, noise, step_noise, recipe: dict,
              sample) -> None:
    """The step-wise numbers of the record ``rec`` of the rows' ``texts``,
    starting latents and eta noise by step; a missing record reads inf."""
    limits = ctx.traffic["limits"]
    if rec is None:
        for k in stepwise.NUMBERS:
            run.checks[k] = (math.inf, limits[k])
        return
    pipe = reference_pipeline(ctx.config, ctx.weights(), ctx.device)
    fol = stepwise.Follower(pipe, recipe, texts, noise, step_noise, rec["context"])
    for k, v in stepwise.check(rec, fol, sample).items():
        run.checks[k] = (v, limits[k])
    if ctx.control:
        ctl = reference_pipeline(ctx.config, ctx.weights(), ctx.device, ctx.control)
        c = stepwise.Follower(ctl, recipe, texts, noise, step_noise, rec["context"])
        for k, v in stepwise.check(rec, fol, sample, control=c).items():
            run.counters[f"control.{k}"] = v
        del ctl, c
    del pipe, fol
    ctx.free()


DRIVERS = {"t2a_closed": run_t2a}


def _delta(before: dict, after: dict) -> dict:
    return {k: {d: after[k].get(d, 0) - before[k].get(d, 0) for d in after[k]} for k in after}


def run_cell(ctx: Context) -> Run:
    kind = ctx.traffic["kind"]
    if kind not in DRIVERS:
        raise ValueError(f"traffic kind {kind!r}: one of {sorted(DRIVERS)}")
    return DRIVERS[kind](ctx)
