#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ezaudio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # build + torch.profiler breakdown of
                                     # the main path (5 steps), no checks

Phases, each fatal on failure:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from ``ezaudio_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, TF32 off: max error against the stated tolerance, the median
     time of kernel, plain version and (attention) SDPA as a yardstick;
  4. the main path: ``EzAudio("s3_l", device="cuda")`` on seeded random
     weights, f32, ``generate_audio`` at its defaults (10 s, 100 DDIM steps,
     CFG 5, rescale 0.75, eta 1) for 1 and for 4 prompts; the kernels'
     launch counters must show both kernels on that path;
  5. the whole path on the card (kernels) against the CPU (plain versions)
     on the same weights and initial latents: s3_l at full width, depth 2,
     1 s, 3 steps, eta 0;
  6. editing on the same EzAudio: ``editing_audio`` at its defaults
     (CFG 3.5, rescale 0, 100 steps, eta 1) on a seeded 10 s clip, mask
     [4 s, 7 s), boundary 2 s (clamped to half the mask: a 6 s window);
  7. long generation: ``generate_long(length=20, window=10, overlap=2)``,
     one generate and two outpainting edits;
  8. the fast samplers, 10 s, 1 prompt: DPM-Solver++ at 25 steps; DPM +
     ``layer_cache=(2, 2)`` + ``guidance_interval`` + ``cfg_refresh=2`` at 25;
     DDIM + ``layer_cache=(2, 2)`` at 100; ``sampler='distilled'`` at 8;
  9. card against CPU on the same weights and draws, s3_l at full width,
     depth 4 (layer caching needs 1 <= k < depth/2): ``editing_audio`` at
     eta 0, and DPM + ``layer_cache`` + ``guidance_interval`` + ``cfg_refresh``;
 10. the launches of each path, a ``{"kernels": [...]}`` line (launches
     summed over the paths of phases 4-8), the card's name and power limit,
     and last ``{"ok": true, "device": {...}}``.

Every path of phases 4 and 6-8 is driven with the launch counters set to
0 just before it and read just after, and must launch each kernel exactly
as often as its model calls and decodes imply; every ResidualUnit shape
those paths give the kernel must be among the shapes of phase 3.

It exits non-zero, with no result line, when CUDA is unavailable or the
port's sources are missing.  Bounds use the H100 SXM data-sheet peaks:
3.35 TB/s, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 (tensor cores); an f32
product costs three TF32 products (3xTF32), so f32 work is bounded at
495 / 3 TFLOP/s.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
# f32 at the f32-accurate tensor-core rate: the kernels compute every f32
# product as three TF32 products (3xTF32, csrc/mma_tf32.cuh), which is as
# accurate as f32 at these tolerances and 2.5x the 67 TFLOP/s of the CUDA
# cores.  One TF32 product is not accurate enough (tests/test_torch_chip_smoke.py).
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# Attention agreement with the plain version.  f32: every element within
# ATTN_F32_ATOL (sums in another order).  bf16: both sides round p to bf16,
# and a p summed in another order now and then lands on the other side of a
# rounding boundary, which moves its row's outputs by one bf16 ulp of p
# (<= 2^-8) times |v|.  So bf16 passes when every element is within
# 2^-8 * max|v| plus one output ulp, and at most BF16_OFF_SHARE of the
# elements are beyond one output ulp (2^-7 |plain| + 1e-5).
# tests/test_torch_chip_smoke.py shows that a kernel that rounds p as the
# plain version does passes, and that one that keeps p in f32, accumulates
# in bf16 or drops a key tile fails.
ATTN_F32_ATOL = 1e-4
BF16_OFF_SHARE = 1e-3
RESUNIT_TOL = 1e-4
PIPE_REL_TOL = 1e-3
PIPE_MIN_CORR = 0.9999


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# (B, H, Lq, Lk, head_dim, key mask); B = 2 is one prompt's CFG pair.
ATTN_CASES = [(2, 16, 500, 500, 64, False),   # s3_l self-attention
              (2, 16, 500, 100, 64, True),    # s3_l cross-attention, T5 padding
              (2, 16, 500, 100, 72, True)]    # s3_xl cross-attention (head_dim 72)
# (B, L, C, dilation): the four decoder blocks of one 10 s clip, which are
# also the encoder's blocks of a 10 s window in reverse order.
RESUNIT_CASES = ([(1, 5000, 512, d) for d in (1, 3, 9)]
                 + [(1, 30000, 256, 9), (1, 120000, 128, 9)]
                 + [(1, 240000, 128, d) for d in (1, 3, 9)]
                 + [(2, 1001, 256, 9)]        # many tiles, ragged last tile
                 # encode and decode of phase 6's 6 s window and of phase 7's
                 # last 3 s window: an editing window is padded to 480 samples,
                 # not to the kernel's 64-row tile, so most of these are ragged
                 + [(1, 144000, 128, 1), (1, 72000, 128, 3), (1, 18000, 256, 9),
                    (1, 3000, 512, 1), (1, 36000, 128, 9), (1, 9000, 256, 3),
                    (1, 1500, 512, 9)])


def attention_agreement(got, want, v):
    """``(ok, max_abs_err, share of elements beyond one output ulp)`` of
    the kernel's ``got`` against the plain version's ``want``."""
    import torch

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        tight = loose = ATTN_F32_ATOL
        max_share = 0.0
    else:
        tight = 2.0 ** -7 * want.float().abs() + 1e-5
        loose = tight + 2.0 ** -8 * v.float().abs().max()
        max_share = BF16_OFF_SHARE
    share = (~(diff <= tight)).float().mean().item()  # NaN counts as off
    ok = bool((diff <= loose).all()) and share <= max_share
    return ok, diff.max().item(), share


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_attention(dev, gen, cases=ATTN_CASES):
    import torch
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention

    rows = []
    for (B, H, Lq, Lk, D, masked) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen).to(dtype)
                       for L in (Lq, Lk, Lk))
            mask = None
            if masked:  # T5-style padding: 23 and 100 valid keys
                lens = torch.tensor([23, Lk], device=dev)
                mask = torch.arange(Lk, device=dev)[None, :] < lens[:, None]
            got = fused_attention(q, k, v, key_mask=mask)
            want = attention_plain(q, k, v, key_mask=mask)
            sync(dev)
            ok, err, share = attention_agreement(got, want, v)
            sdpa_mask = None if mask is None else mask[:, None, None, :]
            ms = time_ms(lambda: fused_attention(q, k, v, key_mask=mask))
            plain_ms = time_ms(lambda: attention_plain(q, k, v, key_mask=mask))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask))
            elt = q.element_size()
            nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * elt + (B * Lk if masked else 0)
            bms, by = bound_ms(nbytes, 4.0 * B * H * Lq * Lk * D, dname)
            row = dict(shape=[B, H, Lq, Lk, D], dtype=dname, masked=masked,
                       max_abs_err=err, off_ulp_share=share,
                       ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
            log("attention " + json.dumps(row))
            if not ok:
                raise AssertionError(f"attention {row['shape']} {dname}: err {err}, "
                                     f"{share} of the elements beyond one ulp")
            rows.append(row)
    return rows


def resunit_args(dev, gen, B, L, C):
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    x = rnd(B, L, C)
    w7 = rnd(7, C, C, scale=(7 * C) ** -0.5)
    w1 = rnd(C, C, scale=C ** -0.5)
    b7, b1 = rnd(C, scale=0.1), rnd(C, scale=0.1)
    snk = [rnd(C, scale=0.1).exp() for _ in range(4)]
    return [x, w7, b7, w1, b1, *snk]


def check_resunit(dev, gen, cases=RESUNIT_CASES):
    from ezaudio_tpu_torch.ops.kernels.resunit import (fused_residual_unit,
                                                       residual_unit_plain)

    rows = []
    for B, L, C, d in cases:
        args = resunit_args(dev, gen, B, L, C)
        got = fused_residual_unit(*args, d)
        want = residual_unit_plain(*args, d)
        sync(dev)
        err = (got - want).abs().max().item()
        ms = time_ms(lambda: fused_residual_unit(*args, d), reps=3, iters=3)
        plain_ms = time_ms(lambda: residual_unit_plain(*args, d), reps=3, iters=3)
        nbytes = (2 * B * L * C + 8 * C * C + 6 * C) * 4
        bms, by = bound_ms(nbytes, 2.0 * B * L * C * C * 8, "float32")
        row = dict(shape=[B, L, C], dilation=d, dtype="float32", max_abs_err=err,
                   tol=RESUNIT_TOL, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bms, bound_by=by)
        log("resunit " + json.dumps(row))
        if not err <= RESUNIT_TOL:
            raise AssertionError(f"resunit {row['shape']} d={d}: err {err}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
def reset_counters():
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    fused_attention.launches = 0
    fused_residual_unit.launches = 0


def read_counters():
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    return fused_attention.launches, fused_residual_unit.launches


def build_ezaudio(dev="cuda", config=None):
    """``EzAudio("s3_l")`` (or ``config``) on seeded random weights."""
    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    t0 = time.perf_counter()
    ez = EzAudio("s3_l", config=config, device=dev, seed=0)
    sync(dev)
    log(f"main: EzAudio('s3_l') built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in ez.dit.parameters()) / 1e9:.3f} B DiT params")
    return ez


def want_attention(depth: int, steps: int, layer_cache=None) -> int:
    """Attention launches of one sampler run: each full call runs depth + 1
    blocks, each cached call the 2k blocks around the deep cache, and every
    block launches self- and cross-attention once (a CFG pair is one call)."""
    full, cached, k = steps, 0, 0
    if layer_cache is not None:
        k, interval = layer_cache
        cached = (steps // interval) * (interval - 1)
        full = steps - cached
    return 2 * (full * (depth + 1) + cached * 2 * k)


@contextlib.contextmanager
def resunit_shapes(seen: set):
    """Add the (L, C) of every ResidualUnit the codec gives the kernel's
    wrapper to ``seen``."""
    from ezaudio_tpu_torch.codecs import oobleck_fast

    orig = oobleck_fast.fused_residual_unit

    def record(x, *args):
        seen.add(tuple(x.shape[1:]))
        return orig(x, *args)

    oobleck_fast.fused_residual_unit = record
    try:
        yield
    finally:
        oobleck_fast.fused_residual_unit = orig


def uncovered_shapes(paths, cases=RESUNIT_CASES):
    """The ResidualUnit (L, C) of the paths that phase 3 does not hold
    against the plain version."""
    checked = {(L, C) for _, L, C, _ in cases}
    return sorted({tuple(s) for p in paths for s in p["resunit_shapes"]} - checked)


def run_path(name, dev, fn, want_attn, want_res, audio_s, want_len):
    """Drive one path with the counters set to 0 just before it and read
    just after; check its launches and output.  ``audio_s`` is the seconds
    of audio the call generates, or a function of the ResidualUnit shapes
    the call gave the kernel (an edit: its window, the longest of them)."""
    import numpy as np
    import torch

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    seen = set()
    reset_counters()
    with resunit_shapes(seen):
        t0 = time.perf_counter()
        wav = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    if callable(audio_s):
        audio_s = audio_s(seen)
    row = dict(path=name, wav_shape=list(wav.shape), wall_s=wall, audio_s=audio_s,
               audio_s_per_s=audio_s / wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
               attention_launches=attn, resunit_launches=res,
               resunit_shapes=sorted(seen, reverse=True),
               wav_abs_max=float(np.abs(wav).max()), wav_std=float(wav.std()))
    log(f"{name} " + json.dumps(row))
    if wav.shape[-1] != want_len or not np.isfinite(wav).all():
        raise AssertionError(f"{name}: output {wav.shape}, finite={np.isfinite(wav).all()}")
    if attn != want_attn or res != want_res:
        raise AssertionError(f"{name}: launch counts {attn}, {res}: want {want_attn}, {want_res}")
    return row


def main_path(ez, length=10.0):
    """Phase 4: ``generate_audio`` at its defaults for 1 and 4 prompts."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    prompts = ["a dog barking in the rain", "footsteps on gravel",
               "a violin playing a slow melody", "thunder rolling in the distance"]
    rows = []
    for n in (1, 4):
        row = run_path(f"main[{n}]", ez.device,
                       lambda: ez.generate_audio(prompts[:n], length=length,
                                                 random_seed=1234)[1],
                       2 * (depth + 1) * 100, want_res, n * length, n_samples)
        if row["wav_shape"] != [n, n_samples]:
            raise AssertionError(f"main path output {row['wav_shape']}")
        rows.append(row)
    return rows


def seeded_clip(sr: int, seconds: float):
    """A seeded test clip: two tones and noise."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    noise = np.random.default_rng(0).standard_normal(t.shape)
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1375 * t)
            + 0.05 * noise).astype(np.float32)


def edit_paths(ez, length=10.0, long_steps=100):
    """Phases 6 and 7: ``editing_audio`` at its defaults on a ``length`` s
    clip (mask [0.4, 0.7) of it, boundary 0.2 of it), and
    ``generate_long`` to twice ``length`` in windows of ``length``."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    per_encode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.encoder.modules())
    clip = seeded_clip(ez.sr, length)
    edit = dict(boundary=0.2 * length, mask_start=0.4 * length, mask_length=0.3 * length)
    rows = [run_path("editing", ez.device,
                     lambda: ez.editing_audio("a dog barking", gt_file=clip,
                                              random_seed=7, **edit)[1],
                     2 * (depth + 1) * 100, per_encode + per_decode,
                     lambda seen: max(L for L, _ in seen) / ez.sr, len(clip))]
    log(f"long: {long_steps} steps per call")
    rows.append(run_path(
        "long", ez.device,
        lambda: ez.generate_long("rain on a tin roof", length=2 * length, window=length,
                                 overlap=0.2 * length, ddim_steps=long_steps,
                                 random_seed=11)[1],
        3 * 2 * (depth + 1) * long_steps, per_decode + 2 * (per_encode + per_decode),
        2 * length, int(2 * length * ez.sr)))
    return rows


SAMPLER_RUNS = [
    ("dpm", dict(sampler="dpm", ddim_steps=25)),
    ("dpm_cache_band_refresh", dict(sampler="dpm", ddim_steps=25, layer_cache=(2, 2),
                                    guidance_interval=(300, 800), cfg_refresh=2)),
    ("ddim_cache", dict(ddim_steps=100, layer_cache=(2, 2))),
    ("distilled", dict(sampler="distilled", ddim_steps=8)),
]


def sampler_paths(ez, length=10.0, runs=SAMPLER_RUNS):
    """Phase 8: each fast sampler once, ``length`` s, 1 prompt."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    rows = []
    for name, kw in runs:
        want = want_attention(depth, kw["ddim_steps"], kw.get("layer_cache"))
        rows.append(run_path(
            name, ez.device,
            lambda: ez.generate_audio("a dog barking in the rain", length=length,
                                      random_seed=5, **kw)[1],
            want, per_decode, length, n_samples))
    return rows


def card_vs_cpu(gen, dev="cuda", cfg=None):
    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config

    if cfg is None:
        cfg = get_model_config("s3_l").to_dict()
        cfg["model"]["depth"] = 2
    gpu = EzAudio(config=cfg, device=dev, seed=3)
    cpu = EzAudio(config=cfg, device="cpu", seed=3)
    for a, b in ((gpu.dit, cpu.dit), (gpu.t5, cpu.t5),
                 (gpu.autoencoder.model, cpu.autoencoder.model)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})
    noise = torch.randn(2, gpu.latent_sr, gpu.latent_dim, generator=gen, device=dev).cpu()
    kw = dict(length=1.0, ddim_steps=3, eta=0.0, random_seed=0, initial_latents=noise)
    prompts = ["a dog barking in the rain", "wind through trees"]
    reset_counters()
    _, wg = gpu.generate_audio(prompts, **kw)
    attn, res = read_counters()
    _, wc = cpu.generate_audio(prompts, **kw)
    # the sampled latents alone, to place any disagreement before or after decode
    lat_args = (prompts, gpu.latent_sr, 5, 0.75, 3, 0.0, 0)
    lg = gpu._generate_latents(*lat_args, initial_latents=noise).cpu().numpy()
    lc = cpu._generate_latents(*lat_args, initial_latents=noise).numpy()
    lat_rel = float(np.abs(lg - lc).max() / np.abs(lc).max())
    err = float(np.abs(wg - wc).max())
    scale = float(np.abs(wc).max())
    corr = float(np.corrcoef(wg.ravel(), wc.ravel())[0, 1])
    row = dict(shape=list(wg.shape), latent_rel_err=lat_rel, max_abs_err=err,
               ref_abs_max=scale, rel_err=err / scale, corr=corr, rel_tol=PIPE_REL_TOL,
               min_corr=PIPE_MIN_CORR, attention_launches=attn, resunit_launches=res)
    log("card_vs_cpu " + json.dumps(row))
    if not (np.isfinite(wg).all() and lat_rel <= PIPE_REL_TOL
            and err <= PIPE_REL_TOL * scale and corr > PIPE_MIN_CORR):
        raise AssertionError("card and CPU disagree")
    if attn == 0 or res == 0:
        raise AssertionError("reduced pipeline did not reach both kernels")
    return row


@contextlib.contextmanager
def same_draws():
    """Every draw of the port (``utils.randn``) from a CPU generator seeded
    by its call index, then moved to the device: card and CPU runs get the
    same initial latents and VAE posterior noise."""
    import torch

    from ezaudio_tpu_torch import utils

    orig, count = utils.randn, [0]

    def randn(shape, generator, device, dtype=torch.float32):
        count[0] += 1
        g = torch.Generator().manual_seed(1000 + count[0])
        return torch.randn(tuple(shape), generator=g, dtype=dtype).to(device)

    utils.randn = randn
    try:
        yield
    finally:
        utils.randn = orig


def agreement(name, got, want, extra):
    """Card (``got``) against CPU (``want``): max error within PIPE_REL_TOL
    of the CPU output's range and correlation above PIPE_MIN_CORR."""
    import numpy as np

    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    corr = float(np.corrcoef(got.ravel(), want.ravel())[0, 1])
    row = dict(extra, shape=list(got.shape), max_abs_err=err, ref_abs_max=scale,
               rel_err=err / scale, corr=corr, rel_tol=PIPE_REL_TOL, min_corr=PIPE_MIN_CORR)
    log(f"{name} " + json.dumps(row))
    if not (np.isfinite(got).all() and err <= PIPE_REL_TOL * scale and corr > PIPE_MIN_CORR):
        raise AssertionError(f"{name}: card and CPU disagree")
    return row


def card_vs_cpu_fast(dev="cuda", cfg=None, length=1.0):
    """Phase 9: card against CPU, s3_l at full width and depth 4, the same
    weights and draws: (a) ``editing_audio`` at eta 0 (hard paste) on a
    clip of 1.5 ``length`` seconds, compared over its edit window; (b) DPM +
    ``layer_cache=(1, 2)`` + ``guidance_interval`` + ``cfg_refresh=2`` for
    ``length`` seconds."""
    import copy

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("s3_l").to_dict())
    cfg["model"]["depth"] = 4
    gpu = EzAudio(config=cfg, device=dev, seed=4)
    cpu = EzAudio(config=cfg, device="cpu", seed=4)
    for a, b in ((gpu.dit, cpu.dit), (gpu.t5, cpu.t5),
                 (gpu.autoencoder.model, cpu.autoencoder.model)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})

    def both(fn):
        """``fn(ez)`` on the card, then on the CPU, with the same draws;
        the outputs and the card run's launches."""
        outs = []
        for ez in (gpu, cpu):
            reset_counters()
            with same_draws():
                outs.append(fn(ez))
            if ez is gpu:
                launches = read_counters()
        return outs, dict(attention_launches=launches[0], resunit_launches=launches[1])

    clip = seeded_clip(gpu.sr, 1.5 * length)
    (wg, wc), launches = both(lambda ez: ez.editing_audio(
        "a dog barking", gt_file=clip, boundary=0.25 * length, mask_start=0.5 * length,
        mask_length=0.5 * length, ddim_steps=3, eta=0.0, random_seed=3)[1])
    lo, hi = round(0.25 * length * gpu.sr), round(1.25 * length * gpu.sr)  # the window
    rows = [agreement("card_vs_cpu_edit", wg[lo:hi], wc[lo:hi], launches)]
    if launches["attention_launches"] == 0 or launches["resunit_launches"] == 0:
        raise AssertionError("card_vs_cpu_edit did not reach both kernels")

    (wg, wc), launches = both(lambda ez: ez.generate_audio(
        ["wind through trees", "a dog barking"], length=length, ddim_steps=6, sampler="dpm",
        layer_cache=(1, 2), guidance_interval=(300, 800), cfg_refresh=2, random_seed=0)[1])
    rows.append(agreement("card_vs_cpu_dpm_cache", wg, wc, launches))
    if (launches["attention_launches"] != want_attention(4, 6, (1, 2))
            or launches["resunit_launches"] == 0):
        raise AssertionError(f"card_vs_cpu_dpm_cache launches {launches}")
    return rows


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_fwd" in n:
        return "attention kernel"
    if "resunit_fwd" in n:
        return "resunit kernel"
    if any(s in n for s in ("gemm", "cutlass", "cublas", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if "conv" in n or "cudnn" in n:
        return "conv (cuDNN)"
    return "elementwise / other"


def profile(steps: int = 5, out_dir: str = "chiprun_out") -> None:
    """Device-time breakdown of the main path (s3_l, 10 s, ``steps`` DDIM
    steps) with torch.profiler: time per kernel class, busy share of the
    wall time, and the top kernels (written to ``out_dir``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    ez = EzAudio("s3_l", device="cuda", seed=0)
    os.makedirs(out_dir, exist_ok=True)
    for n in (1, 4):
        prompts = ["a dog barking in the rain"] * n
        ez.generate_audio(prompts, ddim_steps=2, random_seed=0)  # warm up
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ez.generate_audio(prompts, ddim_steps=steps, random_seed=0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_class, kernels = {}, []
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            t = (e.self_cuda_time_total if t is None else t) / 1e3  # ms
            by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + t
            kernels.append((t, e.count, e.key))
        busy = sum(by_class.values())
        row = dict(prompts=n, ddim_steps=steps, wall_ms=wall_ms, device_busy_ms=busy,
                   busy_share=busy / wall_ms, ms_by_class=by_class)
        log("profile " + json.dumps(row))
        kernels.sort(reverse=True)
        with open(os.path.join(out_dir, f"profile_{n}prompt.txt"), "w") as f:
            f.write(json.dumps(row) + "\n")
            for t, cnt, key in kernels[:40]:
                f.write(f"{t:10.3f} ms {cnt:7d}x  {key[:150]}\n")


# ---------------------------------------------------------------------------
def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from ezaudio_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 3

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} sources compiled in {time.perf_counter() - t0:.2f} s "
        f"into {_build.build_dir()}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}] {line.strip()}")

    if "--profile" in argv:
        profile()
        log("profile: done; no result line")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = check_attention("cuda", gen)
    res_rows = check_resunit("cuda", gen)
    ez = build_ezaudio()
    paths = main_path(ez)
    card_vs_cpu(gen)
    paths += edit_paths(ez)
    paths += sampler_paths(ez)
    del ez
    torch.cuda.empty_cache()
    card_vs_cpu_fast()
    missing = uncovered_shapes(paths)
    if missing:
        raise AssertionError(f"ResidualUnit shapes of the paths not checked in phase 3: {missing}")
    launches = [sum(p["attention_launches"] for p in paths),
                sum(p["resunit_launches"] for p in paths)]
    log("launches " + json.dumps({p["path"]: [p["attention_launches"], p["resunit_launches"]]
                                  for p in paths}))

    a = attn_rows[0]   # s3_l self-attention, f32: the main path's shape
    r = next(x for x in res_rows if x["shape"] == [1, 240000, 128] and x["dilation"] == 9)
    kernels = [
        dict(name="attention", route="cuda",
             source="ezaudio_tpu_torch/csrc/attention.cu",
             replaces="ezaudio_tpu/ops/pallas/attention.py:36", launches=launches[0],
             shape=a["shape"], dtype=a["dtype"], max_abs_err=a["max_abs_err"],
             ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], library_ms=a["library_ms"]),
        dict(name="resunit", route="cuda",
             source="ezaudio_tpu_torch/csrc/resunit.cu",
             replaces="ezaudio_tpu/ops/pallas/resunit.py:69", launches=launches[1],
             shape=r["shape"] + [r["dilation"]], dtype=r["dtype"],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
