#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ezaudio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # build + torch.profiler breakdown of
                                     # the main path (5 steps), staged and
                                     # fused, f32 and bf16, no checks

Phases, each fatal on failure:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from ``ezaudio_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, f32 and bf16, TF32 and cuBLAS's reduced-precision bf16
     reductions off: max error against the stated tolerance, the median
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
 10. ``fused=True`` at phase 4's recipe for 1 and 4 prompts on the same
     EzAudio: the first call (eager warm-up, CUDA graph capture and
     instantiation, one replay), then two replays; the waveform must equal
     phase 4's within FUSED_TOL and each replay must launch the kernels as
     often as a staged call does;
 11. ``quant="int8"``, 1 prompt, 100 steps, staged and fused: every
     (M, K, N) of the int8 products the DiT gave, ``int8_dot`` on the card
     against its plain version on the CPU (bit-equal), the staged launches
     equal to the f32 path's, fused int8 equal to staged int8;
 12. a ``GenerationServer`` (DPM 25 steps, batches of up to 4, length
     buckets 5 s and 10 s): four 10 s and two 4 s requests and phase 6's
     edit; fewer generate batches than generate requests, two served
     waveforms against their solo calls and the edit against the direct
     call; then the same requests twice with ``fused=True`` (the first pass
     captures a graph per signature, the second replays them), each equal
     to the staged server's waveforms;
 13. the energy ControlNet: ``EzAudioControlNet("energy", device="cuda")``
     on seeded random weights (a fresh base EzAudio; the ControlNet's 12
     in-blocks copied from it), ``generate_audio`` on a 10 s clip in 0.5 s
     bursts at its defaults (DDIM 50 steps, CFG 3.5, eta 1), with DPM 25,
     with ``quant="int8"``, and with DPM at conditioning scale 0, which
     must differ from scale 1;
 14. the ControlNet path on the card against the CPU on the same weights
     and draws: energy config at full width, depth 4, a 1 s clip, 3 steps,
     eta 0;
 15. a ``GenerationServer(cn.base, controlnet=cn)`` (DPM 25): two 10 s
     generate requests and one ControlNet request; one ControlNet request
     counted and its waveform equal to the direct call within FUSED_TOL;
 16. s3_l in bf16: ``EzAudio("s3_l", dtype=torch.bfloat16)`` on phase 4's
     seeded weights, ``generate_audio`` at its defaults for 1 and 4 prompts
     and ``fused=True`` for 1 (first call and two replays, equal to staged
     within FUSED_TOL); every launch a bf16 launch; the distance and
     correlation of each waveform to phase 4's f32 one are printed, not
     checked;
 17. bf16 on the card against bf16 on the CPU (the plain versions), the same
     weights and initial latents: s3_l at full width, depth 4, 1 s, 3 DDIM
     steps, eta 0: no farther from the CPU's bf16 output than
     BF16_REF_FACTOR times the CPU's bf16-to-f32 distance, and correlated
     above BF16_PIPE_MIN_CORR;
 18. the checkpoint round trip: phase 13's f32 models written in the
     reference formats to a temporary directory (DiT and ControlNet
     ``{"model": ...}``, the VAE ``{"state_dict": {"autoencoder." ...}}``
     with ``weight_g``/``weight_v``, T5 in HF names), loaded by
     ``EzAudio(ckpt_path=, vae_path=, t5_path=)`` and
     ``EzAudioControlNet(controlnet_path=)``: a short f32 generate and
     ControlNet call equal the writer's within CKPT_REL_TOL of the range;
 19. s3_xl in bf16 at full width and depth (embed 1152, depth 28,
     FLAN-T5-XL): ``generate_audio`` at its defaults for 1 prompt, every
     launch a bf16 launch;
 20. CLAP reranking on phase 4's EzAudio: ``CLAPScorer`` at the
     ``laion/clap-htsat-unfused`` widths (HTSAT embed 96, depths 2/2/6/2;
     RoBERTa-base; projection 512) on seeded weights,
     ``generate_audio_reranked`` on 1 prompt with 4 candidates at the
     reference recipe (seeded CLAP ids padded to 32, some rows shorter),
     the scoring timed alone; the candidates scored again by the CPU scorer:
     embeddings within CLAP_EMBED_ATOL, the same choice unless the CPU's
     top two are within CLAP_TIE;
 21. a ``GenerationServer(ez, clap_scorer=)`` (DPM 25, ``fused=True`` in its
     recipe): one ``submit_reranked`` (run staged) and one plain request;
     the rerank equal to the direct call by phase 12's rule, one rerank
     request counted;
 22. ``Conditioner('vc', sr=24000)`` at ContentVec-base widths (conv 7 x
     512, 12 layers at 768) on a seeded 10 s clip: (1, 500, 768), one frame
     per latent frame; wall (median of 5) and peak; the CPU extractor on the
     same weights within VC_REL_TOL of its range;
 23. (after phase 3) the kernels' gradients at the train step's shapes
     (batch 8, f32): kernel 1's autograd gradients through its wrapper
     against the plain twin's, s3_l self-attention and T5-masked
     cross-attention and against SDPA's, with the backward's time (the
     plain recompute), its bound and SDPA's forward and backward; kernel
     2's nine gradients at one encoder shape; each output's kernel
     ``grad_fn``;
 24. training s3_l at full width: ``train_cli.main`` on 16 seeded 10 s,
     24 kHz clips and a CSV in a temporary directory, batch 8, 6 steps,
     warmup 2, CFG dropout 0.1, ``use_checkpoint`` (full remat); every
     step exactly 100 attention launches (50 forward, 50 recomputed) and
     12 ResidualUnit launches (the batch's encode), all f32; per-step
     wall (median of steps 2-6), samples/s, audio-s trained per s, model
     TFLOP/s (``train_flops``), peak memory and the losses printed; then
     the trainer is deleted (memory checked back), the step-6 checkpoint
     removed, and the restart from step 4 must give steps 5-6's losses
     within RESUME_REL_TOL;
 25. one train step on the card under each remat policy (full, dots,
     off) against one on the CPU: s3_l widths at depth 2, the same
     weights, batch (2) and injected draws: loss, grad norm, every
     gradient and every updated parameter within the limits of
     ``train_step_agreement``, the attention launches each policy
     implies, and a non-zero gradient on the q, k and v projections of
     every attention (ROADMAP F11);
 26. the launches of each path, a ``{"kernels": [...]}`` line (launches
     summed over the paths of phases 4-8, 10-13, 15, 16, 19-21 and 24),
     the card's name and power limit, and last ``{"ok": true, "device":
     {...}}``.

Every path of phases 4, 6-8, 11-13, 15, 16, 19-21 and 24 is driven with the launch
counters set to 0 just before it and read just after, and must launch each
kernel exactly as often as its model calls and decodes imply; the bf16
paths count every launch by dtype (``launches_by_dtype``), so a path that
ran a kernel in f32 fails.  A fused call runs as a CUDA graph whose replays
do not pass through the kernels' Python wrappers: its launches are those
its capture recorded, times its replays.  Every ResidualUnit shape and
dtype the paths give the kernel must be among those of phase 3.  Each
model is deleted before the next is built, and the allocated memory must
fall back to within MEM_SLACK_GIB of its value before the build (no
``gc.collect()``); each phase prints its seconds.

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
# fused against staged on the card: the same kernels on the same inputs in
# the same order, so equal; the limit leaves room for a library routine
# that chooses another algorithm inside a graph
FUSED_TOL = 1e-5
# bf16 on the card against bf16 on the CPU: the rule of
# tests/test_torch_bf16.py.  The card may be no farther from the CPU's bf16
# output than BF16_REF_FACTOR times the CPU's bf16 distance from its own f32
# output on the same weights and inputs, and correlate above
# BF16_PIPE_MIN_CORR.  Summing in another order alone moves a bf16 output by
# about 5 % of its range here (the CPU with 8 and with 3 threads, PERF.md
# §6), so a fixed share of the range near that spread cannot separate a
# fault from rounding; the kernels' own bf16 functions are held in phase 3.
BF16_REF_FACTOR = 2.0
BF16_PIPE_MIN_CORR = 0.99
# a model loaded from the files written of it: the DiT, T5 and the
# ControlNet load bit for bit; the VAE's weight norm, folded again, rounds
CKPT_REL_TOL = 1e-4
# a deleted model's memory: allocated bytes back within this of their
# value before it was built
MEM_SLACK_GIB = 0.1
# ContentVec features, card against CPU in f32: within this share of the
# CPU output's range
VC_REL_TOL = 1e-4


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


def graph_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median device time of one call of ``fn``, replayed from a CUDA graph
    of ``iters`` calls: no host launch cost (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
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
              (2, 16, 500, 500, 72, False),   # s3_xl self-attention (head_dim 72)
              (2, 16, 500, 100, 72, True)]    # s3_xl cross-attention
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
                    (1, 1500, 512, 9)]
                 # decode of phase 12's 5 s length bucket, two clips
                 + [(2, 2500, 512, 9), (2, 15000, 256, 3), (2, 60000, 128, 1)])
# the VAE encode of a training batch (phase 24): 8 clips of 10 s through
# the encoder's four blocks, each with dilations 1, 3 and 9
RESUNIT_TRAIN_CASES = [(8, L, C, d)
                       for L, C in ((240000, 128), (120000, 128), (30000, 256), (5000, 512))
                       for d in (1, 3, 9)]
RESUNIT_CASES += RESUNIT_TRAIN_CASES
# bf16: the decoder blocks of one 10 s clip, the shapes of phases 16 and 19
RESUNIT_BF16_CASES = ([(1, 5000, 512, d) for d in (1, 3, 9)]
                      + [(1, 30000, 256, 9), (1, 120000, 128, 9)]
                      + [(1, 240000, 128, d) for d in (1, 3, 9)])


def bf16_agreement(got, want, slack=None):
    """``(ok, max_abs_err, share of elements beyond one output ulp)`` of a
    bf16 ``got`` against ``want``: every element within one bf16 ulp of
    ``|want|`` (2^-7 |want| + 1e-5) plus ``slack`` (default: one more
    ulp), and at most BF16_OFF_SHARE of the elements beyond one ulp."""
    diff = (got.float() - want.float()).abs()
    tight = 2.0 ** -7 * want.float().abs() + 1e-5
    loose = tight + (tight if slack is None else slack)
    share = (~(diff <= tight)).float().mean().item()  # NaN counts as off
    ok = bool((diff <= loose).all()) and share <= BF16_OFF_SHARE
    return ok, diff.max().item(), share


def resunit_bf16_slack(x, w7, b7, w1, b1, a1, be1, a2, be2, dilation):
    """The bf16 ResidualUnit's allowance beyond one output ulp: where a
    snake2 output ``g``, summed in another order, rounds to the other
    side, every output of its row moves by one bf16 ulp of ``g`` times a
    weight of ``W1``: 2^-7 max|g| max|W1|, ``g`` computed in f32."""
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.activations import snake_beta_vae

    h = snake_beta_vae(x.float(), a1.float(), be1.float())
    acc = F.conv1d(h.transpose(1, 2), w7.float().permute(2, 1, 0), b7.float(),
                   padding=3 * dilation, dilation=dilation).transpose(1, 2)
    g = snake_beta_vae(acc, a2.float(), be2.float())
    return 2.0 ** -7 * g.abs().max().item() * w1.float().abs().max().item()


def attention_agreement(got, want, v):
    """``(ok, max_abs_err, share of elements beyond one output ulp)`` of
    the kernel's ``got`` against the plain version's ``want``."""
    import torch

    if got.dtype != torch.float32:
        return bf16_agreement(got, want, 2.0 ** -8 * v.float().abs().max())
    diff = (got - want).abs()
    share = (~(diff <= ATTN_F32_ATOL)).float().mean().item()
    return share == 0.0, diff.max().item(), share


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


def check_resunit(dev, gen, cases=RESUNIT_CASES, dtype="float32"):
    """Kernel 2 against its plain version at ``cases``: f32 within
    RESUNIT_TOL; bf16 (x and weights bf16, snake parameters f32) by
    :func:`bf16_agreement` with :func:`resunit_bf16_slack`."""
    import torch

    from ezaudio_tpu_torch.ops.kernels.resunit import (fused_residual_unit,
                                                       residual_unit_plain)

    rows = []
    for B, L, C, d in cases:
        args = resunit_args(dev, gen, B, L, C)
        args = [a.to(getattr(torch, dtype)) for a in args[:5]] + args[5:]
        got = fused_residual_unit(*args, d)
        want = residual_unit_plain(*args, d)
        sync(dev)
        if dtype == "float32":
            err = (got - want).abs().max().item()
            ok, tol = err <= RESUNIT_TOL, RESUNIT_TOL
        else:
            tol = resunit_bf16_slack(*args, d)
            ok, err, share = bf16_agreement(got, want, tol)
        ms = time_ms(lambda: fused_residual_unit(*args, d), reps=3, iters=3)
        plain_ms = time_ms(lambda: residual_unit_plain(*args, d), reps=3, iters=3)
        elt = args[0].element_size()
        nbytes = (2 * B * L * C + 8 * C * C + 2 * C) * elt + 4 * C * 4
        bms, by = bound_ms(nbytes, 2.0 * B * L * C * C * 8, dtype)
        row = dict(shape=[B, L, C], dilation=d, dtype=dtype, max_abs_err=err,
                   tol=tol, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bms, bound_by=by)
        log("resunit " + json.dumps(row))
        if not ok:
            raise AssertionError(f"resunit {row['shape']} d={d} {dtype}: err {err}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
def reset_counters():
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    for fn in (fused_attention, fused_residual_unit):
        fn.launches = 0
        fn.launches_by_dtype = {}


def read_counters():
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    return fused_attention.launches, fused_residual_unit.launches


def read_dtype_counters():
    """``{"<kernel>.<dtype>": launches}`` since the last reset."""
    from ezaudio_tpu_torch.api.graphs import kernel_launches_by_dtype

    return kernel_launches_by_dtype()


def want_by_dtype(attn, res, dtype):
    """The launches by dtype of a path whose every launch is in ``dtype``."""
    want = {"attention": attn, "resunit": res}
    return {f"{k}.{dtype}": n for k, n in want.items() if n}


def build_ezaudio(dev="cuda", config=None, model="s3_l", dtype="float32"):
    """``EzAudio(model)`` (or ``config``) on seeded random weights."""
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    t0 = time.perf_counter()
    ez = EzAudio(model, config=config, device=dev, seed=0, dtype=getattr(torch, dtype))
    sync(dev)
    log(f"main: EzAudio({model!r}, {dtype}) built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in ez.dit.parameters()) / 1e9:.3f} B DiT params, "
        f"{mem_gib(torch.cuda.memory_allocated)} GiB allocated")
    return ez


def check_freed(what, before_gib):
    """A deleted model's memory is back (ROADMAP F8): allocated within
    MEM_SLACK_GIB of ``before_gib``, with no garbage collection (cuBLAS's
    cached workspaces released first)."""
    import torch

    # cuBLAS keeps a workspace per stream it ran on (a graph capture's too):
    # the library's cache, not the model's memory
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.backends.cuda.cufft_plan_cache.clear()  # cuFFT's plans (CLAP's STFT), likewise
    now = mem_gib(torch.cuda.memory_allocated)
    log(f"freed {what}: {now:.3f} GiB allocated after del, {before_gib:.3f} before the build")
    if now > before_gib + MEM_SLACK_GIB:
        raise AssertionError(f"{what}: {now:.3f} GiB still allocated after del, "
                             f"{before_gib:.3f} before the build")


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def want_attention(depth: int, steps: int, layer_cache=None, controlnet=False) -> int:
    """Attention launches of one sampler run: each full call runs depth + 1
    blocks (and, with ``controlnet``, the ControlNet's depth // 2), each
    cached call the 2k blocks around the deep cache, and every block
    launches self- and cross-attention once (a CFG pair is one call)."""
    full, cached, k = steps, 0, 0
    if layer_cache is not None:
        k, interval = layer_cache
        cached = (steps // interval) * (interval - 1)
        full = steps - cached
    blocks = depth + 1 + (depth // 2 if controlnet else 0)
    return 2 * (full * blocks + cached * 2 * k)


@contextlib.contextmanager
def resunit_shapes(seen: set, full: bool = False):
    """Add the (L, C) of every ResidualUnit the codec gives the kernel's
    wrapper to ``seen``; with ``full``, its (B, L, C, dilation)."""
    from ezaudio_tpu_torch.codecs import oobleck_fast

    orig = oobleck_fast.fused_residual_unit

    def record(x, *args):
        # (L, C) for f32 inputs, (L, C, "bfloat16") for bf16 ones
        dt = str(x.dtype).rsplit(".", 1)[-1]
        if full:
            seen.add(tuple(x.shape) + (int(args[-1]),))
        else:
            seen.add(tuple(x.shape[1:]) + (() if dt == "float32" else (dt,)))
        return orig(x, *args)

    oobleck_fast.fused_residual_unit = record
    try:
        yield
    finally:
        oobleck_fast.fused_residual_unit = orig


def uncovered_shapes(paths, cases=RESUNIT_CASES, bf16_cases=RESUNIT_BF16_CASES):
    """The ResidualUnit (L, C) of the paths (``(L, C, "bfloat16")`` for a
    bf16 one) that phase 3 does not hold against the plain version."""
    checked = ({(L, C) for _, L, C, _ in cases}
               | {(L, C, "bfloat16") for _, L, C, _ in bf16_cases})
    return sorted({tuple(s) for p in paths for s in p["resunit_shapes"]} - checked)


def run_path(name, dev, fn, want_attn, want_res, audio_s, want_len, dtype=None):
    """Drive one path with the counters set to 0 just before it and read
    just after; check its launches and output.  ``audio_s`` is the seconds
    of audio the call generates, or a function of the ResidualUnit shapes
    the call gave the kernel (an edit: its window, the longest of them).
    With ``dtype``, every launch must be a launch on ``dtype`` inputs."""
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
    by_dtype = read_dtype_counters()
    if callable(audio_s):
        audio_s = audio_s(seen)
    row = dict(path=name, wav_shape=list(wav.shape), wall_s=wall, audio_s=audio_s,
               audio_s_per_s=audio_s / wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
               attention_launches=attn, resunit_launches=res, launches_by_dtype=by_dtype,
               resunit_shapes=sorted(seen, reverse=True),
               wav_abs_max=float(np.abs(wav).max()), wav_std=float(wav.std()))
    log(f"{name} " + json.dumps(row))
    if wav.shape[-1] != want_len or not np.isfinite(wav).all():
        raise AssertionError(f"{name}: output {wav.shape}, finite={np.isfinite(wav).all()}")
    if attn != want_attn or res != want_res:
        raise AssertionError(f"{name}: launch counts {attn}, {res}: want {want_attn}, {want_res}")
    if dtype is not None and by_dtype != want_by_dtype(attn, res, dtype):
        raise AssertionError(f"{name}: launches by dtype {by_dtype}, want all {dtype}")
    row["wav"] = wav  # kept for the comparisons of later phases, not logged
    return row


PROMPTS = ["a dog barking in the rain", "footsteps on gravel",
           "a violin playing a slow melody", "thunder rolling in the distance"]


def main_path(ez, length=10.0):
    """Phase 4: ``generate_audio`` at its defaults for 1 and 4 prompts."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    rows = []
    for n in (1, 4):
        row = run_path(f"main[{n}]", ez.device,
                       lambda: ez.generate_audio(PROMPTS[:n], length=length,
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


def burst_clip(sr: int, seconds: float):
    """``seeded_clip`` in 0.5 s on/off bursts: an energy condition that is
    not flat."""
    import numpy as np

    clip = seeded_clip(sr, seconds)
    on = (np.arange(len(clip)) // int(0.5 * sr)) % 2 == 0
    return (clip * on).astype(np.float32)


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


def last_program(ez):
    """The fused program ``ez`` ran last."""
    return next(reversed(ez._fused.values()))


def mem_gib(fn):
    import torch

    return fn() / 2**30 if torch.cuda.is_available() else None


def fused_run(name, ez, fn, want_attn, want_res, audio_s, replays=2, like=None,
              dtype=None):
    """A fused call's first run (warm-up, capture, instantiation, one
    replay) and ``replays`` more, each checked: equal output across
    replays, the capture's launches equal to a staged call's (with
    ``dtype``, every one on ``dtype`` inputs), the output within FUSED_TOL
    of ``like`` (the staged waveform).  Launches are those of one replay
    times the replays."""
    import numpy as np
    import torch

    cuda = torch.device(ez.device).type == "cuda"
    sync(ez.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem_before = mem_gib(torch.cuda.memory_allocated)
    reset_counters()
    seen = set()
    with resunit_shapes(seen):
        t0 = time.perf_counter()
        wav = fn()
        sync(ez.device)
        first_s = time.perf_counter() - t0
    prog = last_program(ez)
    mem_after = mem_gib(torch.cuda.memory_allocated)
    peak_first = mem_gib(torch.cuda.max_memory_allocated)
    walls = []
    for _ in range(replays):
        t0 = time.perf_counter()
        again = fn()
        sync(ez.device)
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(again, wav):
            raise AssertionError(f"{name}: a replay gave another waveform")
    per = dict(prog.launches) if cuda else None
    per_dtype = dict(prog.launches_by_dtype) if cuda else read_dtype_counters()
    calls = prog.replays if cuda else 1 + replays
    err = None if like is None else float(np.abs(wav - like).max())
    row = dict(path=name, wav_shape=list(wav.shape), first_call_s=first_s,
               **{k: v for k, v in prog.timings.items()}, replay_s=walls,
               audio_s=audio_s, audio_s_per_s=audio_s / statistics.median(walls),
               mem_before_gib=mem_before, mem_after_capture_gib=mem_after,
               peak_first_call_gib=peak_first, launches_per_replay=per,
               launches_by_dtype=per_dtype, replays=calls,
               max_abs_err_vs_staged=err, tol=FUSED_TOL,
               resunit_shapes=sorted(seen, reverse=True))
    log(f"{name} " + json.dumps(row))
    if not np.isfinite(wav).all():
        raise AssertionError(f"{name}: output not finite")
    if err is not None and not err <= FUSED_TOL:
        raise AssertionError(f"{name}: fused and staged differ by {err}")
    if cuda and per != {"attention": want_attn, "resunit": want_res}:
        raise AssertionError(f"{name}: launches per replay {per}: want {want_attn}, {want_res}")
    if not cuda and read_counters() != (want_attn * calls, want_res * calls):
        raise AssertionError(f"{name}: eager launches {read_counters()}")
    if dtype is not None and per_dtype != want_by_dtype(
            *((want_attn, want_res) if cuda else (want_attn * calls, want_res * calls)), dtype):
        raise AssertionError(f"{name}: launches by dtype {per_dtype}, want all {dtype}")
    row.update(attention_launches=want_attn * calls, resunit_launches=want_res * calls,
               wav=wav)
    return row


def fused_paths(ez, staged, length=10.0, replays=2):
    """Phase 10: ``fused=True`` at the main path's recipe for 1 and 4
    prompts; ``staged`` holds phase 4's rows (their waveforms)."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    rows = []
    for n, like in zip((1, 4), staged):
        rows.append(fused_run(
            f"fused[{n}]", ez,
            lambda: ez.generate_audio(PROMPTS[:n], length=length, random_seed=1234,
                                      fused=True)[1],
            2 * (depth + 1) * 100, want_res, n * length, replays, like["wav"]))
    return rows


@contextlib.contextmanager
def int8_shapes(seen: set):
    """Add the (M, K, N) of every int8 product of the DiT to ``seen``."""
    from ezaudio_tpu_torch.ops import quant

    orig = quant.int8_matmul

    def record(a, b):
        seen.add((a.shape[0], a.shape[1], b.shape[0]))
        return orig(a, b)

    quant.int8_matmul = record
    try:
        yield
    finally:
        quant.int8_matmul = orig


def check_int8(dev, gen, shapes):
    """``int8_dot`` on the card against its plain version (the CPU's
    float64 product) on the same inputs, at each (M, K, N): bit-equal.
    Times of what a quantized linear runs per call (``int8_linear`` on the
    cached int8 weight: quantize the rows, ``torch._int_mm``, rescale) and
    of the f32 product it replaces (TF32 off): back to back from the host
    (``*_ms``) and replayed from a CUDA graph (``*_graph_ms``, device
    time alone)."""
    import torch

    from ezaudio_tpu_torch.ops.quant import int8_dot, int8_linear, quantize_symmetric

    rows = []
    for M, K, N in sorted(shapes):
        x = torch.randn(M, K, device=dev, generator=gen)
        w = torch.randn(K, N, device=dev, generator=gen) * K ** -0.5
        got = int8_dot(x, w)
        want = int8_dot(x.cpu(), w.cpu())
        equal = bool(torch.equal(got.cpu(), want))
        wq, ws = quantize_symmetric(w.t().contiguous(), -1)
        row = dict(shape=[M, K, N], bit_equal=equal,
                   max_abs_err=(got.cpu() - want).abs().max().item(),
                   int8_ms=time_ms(lambda: int8_linear(x, wq, ws)),
                   f32_matmul_ms=time_ms(lambda: x @ w),
                   int8_graph_ms=graph_ms(lambda: int8_linear(x, wq, ws)),
                   f32_matmul_graph_ms=graph_ms(lambda: x @ w))
        log("int8 " + json.dumps(row))
        if not equal:
            raise AssertionError(f"int8_dot {row['shape']}: card and plain differ")
        rows.append(row)
    return rows


def int8_paths(ez, gen, f32_row, length=10.0):
    """Phase 11: ``quant='int8'`` at the main path's recipe, 1 prompt,
    staged (launches as the f32 path's) and fused (equal to staged), and
    ``int8_dot`` against its plain version at every shape of the run."""
    import numpy as np

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    shapes = set()

    def call(**kw):
        return ez.generate_audio(PROMPTS[:1], length=length, random_seed=1234,
                                 quant="int8", **kw)[1]

    with int8_shapes(shapes):
        row = run_path("int8[1]", ez.device, call, 2 * (depth + 1) * 100, want_res,
                       length, n_samples)
    f32 = f32_row["wav"]
    row.update(int8_shapes=sorted(shapes),
               vs_f32_max_abs=float(np.abs(row["wav"] - f32).max()),
               vs_f32_corr=float(np.corrcoef(row["wav"].ravel(), f32.ravel())[0, 1]))
    log("int8[1] shapes " + json.dumps({k: row[k] for k in
                                        ("int8_shapes", "vs_f32_max_abs", "vs_f32_corr")}))
    if not any(m <= 16 for m, _, _ in shapes):
        raise AssertionError("int8: no product with 16 rows or fewer (the time MLPs)")
    int8_rows = check_int8(ez.device, gen, shapes)
    fused = fused_run("fused_int8[1]", ez, lambda: call(fused=True), 2 * (depth + 1) * 100,
                      want_res, length, 1, row["wav"])
    return [row, fused], int8_rows


def latency_stats(lat):
    import numpy as np

    return dict(p50_s=float(np.percentile(lat, 50)), max_s=float(np.max(lat)))


def served_paths(ez, fused=False, clip_s=10.0, steps=25, lengths=(10.0,) * 4 + (4.0,) * 2,
                 name=None):
    """Phase 12: a GenerationServer (DPM, ``steps`` steps, batches of up to
    4, length buckets 5 s and 10 s) given the ``lengths`` requests and phase
    6's edit at once; every future resolves; fewer generate batches than
    generate requests; returns the row and the results.  With ``fused``,
    a signature met for the first time is warmed up and captured, one met
    before is replayed."""
    import numpy as np

    from ezaudio_tpu_torch.serving import GenerationServer

    depth = ez.params_cfg.model.depth
    clip = seeded_clip(ez.sr, clip_s)
    edit = dict(boundary=0.2 * clip_s, mask_start=0.4 * clip_s, mask_length=0.3 * clip_s)
    name = name or ("served_fused" if fused else "served")
    buckets = [0.5 * max(lengths), max(lengths)]
    srv = GenerationServer(ez, max_batch_size=4, max_wait_ms=100, length=max(lengths),
                           length_buckets=buckets, ddim_steps=steps, sampler="dpm",
                           fused=fused)
    seen = set()
    reset_counters()
    replays_before = {k: p.replays for k, p in ez._fused.items()}
    sync(ez.device)
    with resunit_shapes(seen), srv:
        t0 = time.perf_counter()
        futs, submitted = [], []
        for i, length in enumerate(lengths):
            submitted.append(time.perf_counter())
            futs.append(srv.submit(PROMPTS[i % 4], seed=100 + i, length=length))
        submitted.append(time.perf_counter())
        futs.append(srv.submit_edit("a dog barking", gt_file=clip, seed=7, **edit))
        done, outs = [], []
        for f in futs:
            outs.append(f.result(timeout=600))
            done.append(time.perf_counter())
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    stats = dict(srv.stats)
    gen_batches = stats["batches"] - stats["edit_requests"]
    lat = [d - s for d, s in zip(done, submitted)]
    # every generate batch holds <= 4 clips: one decode call of 12 units;
    # an edit encodes and decodes its window
    per_call, edits = 2 * (depth + 1) * steps, stats["edit_requests"]
    if not fused or ez.device.type != "cuda":  # no graphs: every call runs eagerly
        want = (per_call * stats["batches"], 12 * gen_batches + 24 * edits)
        launches = (attn, res)
    else:
        # the generate batches replay graphs: the counters see the edits
        # and each new program's warm-up and capture, the replays come from
        # the captures' records
        new = [k for k in ez._fused if k not in replays_before]
        ran = {k: p for k, p in ez._fused.items() if p.replays != replays_before.get(k, 0)}
        if any(p.launches != {"attention": per_call, "resunit": 12} for p in ran.values()):
            raise AssertionError(f"{name}: launches per replay "
                                 f"{[p.launches for p in ran.values()]}")
        replayed = sum(p.replays - replays_before.get(k, 0) for k, p in ran.items())
        want = (per_call * (edits + 2 * len(new)), 24 * edits + 24 * len(new))
        launches = (per_call * (edits + replayed), 24 * edits + 12 * replayed)
    row = dict(path=name, requests=len(futs), wall_s=wall, **latency_stats(lat),
               audio_s=float(sum(lengths)) + 0.6 * clip_s, stats=stats,
               attention_launches=launches[0], resunit_launches=launches[1],
               resunit_shapes=sorted(seen, reverse=True),
               wav_shapes=[list(np.shape(w)) for _, w in outs])
    log(f"{name} " + json.dumps(row))
    if (attn, res) != want:
        raise AssertionError(f"{name}: counters {attn}, {res}: want {want}")
    if gen_batches >= len(lengths):
        raise AssertionError(f"{name}: {gen_batches} generate batches for "
                             f"{len(lengths)} requests")
    for (sr, w), length in zip(outs, list(lengths) + [clip_s]):
        if w.shape != (int(length * sr),) or not np.isfinite(w).all():
            raise AssertionError(f"{name}: output {w.shape} for {length} s")
    row["outs"] = [w for _, w in outs]
    row["requests_made"] = dict(lengths=list(lengths), edit=edit, clip=clip, steps=steps)
    return row


def served_checks(ez, staged, *fused):
    """Phase 12's comparisons: two served waveforms (a 10 s and a 4 s
    request) against their solo calls, the served edit against the direct
    call, and each fused server's waveforms against the staged server's."""
    import numpy as np

    req = staged["requests_made"]
    lengths, steps = req["lengths"], req["steps"]
    rows = []
    for i in (0, len(lengths) - 1):
        bucket = max(lengths) if lengths[i] > 0.5 * max(lengths) else 0.5 * max(lengths)
        _, solo = ez.generate_audio(PROMPTS[i % 4], length=bucket, ddim_steps=steps,
                                    sampler="dpm", random_seed=100 + i)
        got = staged["outs"][i]
        rows.append(agreement(f"served_vs_solo[{i}]", got, solo[: got.shape[0]],
                              dict(length=lengths[i], bucket=bucket)))
    _, direct = ez.editing_audio("a dog barking", gt_file=req["clip"], random_seed=7,
                                 ddim_steps=steps, **req["edit"])
    rows.append(agreement("served_edit_vs_direct", staged["outs"][-1], direct, {}))
    for run in fused:
        err = max(float(np.abs(a - b).max()) for a, b in zip(run["outs"], staged["outs"]))
        row = dict(max_abs_err=err, tol=FUSED_TOL)
        log(f"{run['path']}_vs_served " + json.dumps(row))
        if not err <= FUSED_TOL:
            raise AssertionError(f"{run['path']} and served differ by {err}")
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


def build_controlnet(dev="cuda", config=None, seed=0):
    """``EzAudioControlNet("energy")`` (or ``config``) on seeded random
    weights: the base EzAudio, then the ControlNet from ``seed + 1`` with
    the base's embedders and in-blocks copied in."""
    import torch

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet

    t0 = time.perf_counter()
    cn = EzAudioControlNet("energy", config=config, device=dev, seed=seed)
    sync(dev)
    log(f"controlnet: EzAudioControlNet('energy') built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in cn.controlnet.parameters()) / 1e9:.3f} B ControlNet params, "
        f"{mem_gib(torch.cuda.memory_allocated)} GiB allocated")
    return cn


@contextlib.contextmanager
def controlnet_window(seconds: float):
    """``EzAudioControlNet.generate_audio`` pads or crops every clip to
    ``WINDOW_SECONDS`` (10): set it to ``seconds`` inside."""
    from ezaudio_tpu_torch.api import controlnet

    orig = controlnet.WINDOW_SECONDS
    controlnet.WINDOW_SECONDS = seconds
    try:
        yield
    finally:
        controlnet.WINDOW_SECONDS = orig


CONTROLNET_PROMPT = "a dog barking in the rain"
# (name, generate_audio arguments); the first is the call at its defaults:
# DDIM 50 steps, CFG 3.5, rescale 0, eta 1, conditioning scale 1
CONTROLNET_RUNS = [
    ("controlnet", {}),
    ("controlnet_dpm", dict(sampler="dpm", ddim_steps=25)),
    ("controlnet_int8", dict(quant="int8")),
    ("controlnet_dpm_scale0", dict(sampler="dpm", ddim_steps=25, conditioning_scale=0.0)),
]


def controlnet_paths(cn, clip_s=10.0, runs=CONTROLNET_RUNS):
    """Phase 13: ``generate_audio`` on a ``clip_s`` s burst clip at its
    defaults, with DPM-Solver++ at 25 steps, with ``quant='int8'``, and
    with DPM at conditioning scale 0; each run's launches, length and
    finiteness checked; scale 1 and scale 0 must differ by more than 100
    times the card-against-CPU limit of the output's range."""
    import numpy as np

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    base = cn.base
    depth = base.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in base.autoencoder.model.decoder.modules())
    clip = burst_clip(base.sr, clip_s)
    rows = []
    for name, kw in runs:
        steps = kw.get("ddim_steps", 50)
        rows.append(run_path(
            name, cn.device,
            lambda: cn.generate_audio(CONTROLNET_PROMPT, clip, random_seed=21, **kw)[1],
            want_attention(depth, steps, controlnet=True), per_decode, clip_s, len(clip)))
    on, off = (next(r["wav"] for r in rows if r["path"] == p)
               for p in ("controlnet_dpm", "controlnet_dpm_scale0"))
    gap = dict(max_abs_diff=float(np.abs(on - off).max()), ref_abs_max=float(np.abs(on).max()),
               min_rel_diff=100 * PIPE_REL_TOL)
    gap["rel_diff"] = gap["max_abs_diff"] / gap["ref_abs_max"]
    log("controlnet_scale1_vs_scale0 " + json.dumps(gap))
    if not gap["rel_diff"] > gap["min_rel_diff"]:
        raise AssertionError(f"conditioning scale 1 and 0 barely differ: {gap}")
    return rows


def controlnet_card_vs_cpu(dev="cuda", cfg=None, clip_s=1.0):
    """Phase 14: the ControlNet path on the card (kernels) against the CPU
    (plain versions), energy config at full width and depth 4, a ``clip_s``
    s burst clip (the window set to it), 3 DDIM steps at eta 0, the same
    weights and draws."""
    import copy

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.config import get_model_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("energy").to_dict())
    cfg["model"]["depth"] = 4
    gpu = EzAudioControlNet(config=cfg, device=dev, seed=5)
    cpu = EzAudioControlNet(config=cfg, device="cpu", seed=5)
    for a, b in ((gpu.base.dit, cpu.base.dit), (gpu.base.t5, cpu.base.t5),
                 (gpu.base.autoencoder.model, cpu.base.autoencoder.model),
                 (gpu.controlnet, cpu.controlnet)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})
    clip = burst_clip(gpu.base.sr, clip_s)
    outs = []
    with controlnet_window(clip_s):
        for cn in (gpu, cpu):
            reset_counters()
            with same_draws():
                outs.append(cn.generate_audio(CONTROLNET_PROMPT, clip, ddim_steps=3, eta=0.0,
                                              random_seed=3)[1])
            if cn is gpu:
                attn, res = read_counters()
    row = agreement("controlnet_card_vs_cpu", outs[0], outs[1],
                    dict(attention_launches=attn, resunit_launches=res))
    if (attn, res) != (want_attention(4, 3, controlnet=True), 12):
        raise AssertionError(f"controlnet_card_vs_cpu launches {attn}, {res}")
    return row


def controlnet_served(cn, clip_s=10.0, steps=25, lengths=(10.0, 10.0)):
    """Phase 15: a ``GenerationServer(cn.base, controlnet=cn)`` (DPM,
    ``steps`` steps, batches of up to 4) given the ``lengths`` generate
    requests and one ControlNet request at once; launches and lengths
    checked, one ControlNet request counted, and the served ControlNet
    waveform equal to the direct call within FUSED_TOL."""
    import numpy as np

    from ezaudio_tpu_torch.serving import GenerationServer

    base = cn.base
    depth = base.params_cfg.model.depth
    clip = burst_clip(base.sr, clip_s)
    srv = GenerationServer(base, controlnet=cn, max_batch_size=4, max_wait_ms=100,
                           length=max(lengths), ddim_steps=steps, sampler="dpm")
    seen = set()
    reset_counters()
    sync(base.device)
    with resunit_shapes(seen), srv:
        t0 = time.perf_counter()
        futs = [srv.submit(PROMPTS[i % 4], seed=200 + i, length=length)
                for i, length in enumerate(lengths)]
        futs.append(srv.submit_controlnet(CONTROLNET_PROMPT, clip, seed=21))
        outs, lat = [], []
        for f in futs:
            outs.append(f.result(timeout=600)[1])
            lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    stats = dict(srv.stats)
    n_cn = stats["controlnet_requests"]
    gen_batches = stats["batches"] - n_cn
    want = (want_attention(depth, steps) * gen_batches
            + want_attention(depth, steps, controlnet=True) * n_cn,
            12 * (gen_batches + n_cn))
    _, direct = cn.generate_audio(CONTROLNET_PROMPT, clip, sampler="dpm", ddim_steps=steps,
                                  random_seed=21)
    err = float(np.abs(outs[-1] - direct).max())
    row = dict(path="controlnet_served", requests=len(futs), wall_s=wall,
               **latency_stats(lat), audio_s=float(sum(lengths)) + clip_s, stats=stats,
               attention_launches=attn, resunit_launches=res,
               resunit_shapes=sorted(seen, reverse=True),
               wav_shapes=[list(np.shape(w)) for w in outs],
               controlnet_vs_direct_max_abs_err=err, tol=FUSED_TOL)
    log("controlnet_served " + json.dumps(row))
    if n_cn != 1:
        raise AssertionError(f"controlnet_served: {n_cn} ControlNet requests counted")
    if (attn, res) != want:
        raise AssertionError(f"controlnet_served: counters {attn}, {res}: want {want}")
    for w, length in zip(outs, list(lengths) + [clip_s]):
        if w.shape != (int(length * base.sr),) or not np.isfinite(w).all():
            raise AssertionError(f"controlnet_served: output {w.shape} for {length} s")
    if not err <= FUSED_TOL:
        raise AssertionError(f"controlnet_served: served and direct differ by {err}")
    return row


def vs_f32(name, got, f32):
    """Phase 16's printed comparison of a bf16 waveform with the f32 one
    at the same seed (no limit: another precision)."""
    import numpy as np

    row = dict(max_abs_diff=float(np.abs(got - f32).max()),
               ref_abs_max=float(np.abs(f32).max()),
               corr=float(np.corrcoef(got.ravel(), f32.ravel())[0, 1]))
    log(f"{name}_vs_f32 " + json.dumps(row))
    return row


def bf16_paths(ez, f32_rows, length=10.0, replays=2):
    """Phase 16: the bf16 ``ez`` at the main path's recipe, 1 and 4 prompts
    staged and 1 prompt fused (equal to staged); ``f32_rows`` are phase 4's
    rows, whose waveforms the bf16 ones are printed against."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    rows = []
    for n, f32 in zip((1, 4), f32_rows):
        row = run_path(f"bf16_main[{n}]", ez.device,
                       lambda: ez.generate_audio(PROMPTS[:n], length=length,
                                                 random_seed=1234)[1],
                       want_attention(depth, 100), want_res, n * length, n_samples,
                       dtype="bfloat16")
        row["vs_f32"] = vs_f32(row["path"], row["wav"], f32["wav"])
        rows.append(row)
    rows.append(fused_run(
        "bf16_fused[1]", ez,
        lambda: ez.generate_audio(PROMPTS[:1], length=length, random_seed=1234,
                                  fused=True)[1],
        want_attention(depth, 100), want_res, length, replays, rows[0]["wav"], "bfloat16"))
    return rows


def bf16_card_vs_cpu(gen, dev="cuda", cfg=None, length=1.0):
    """Phase 17: bf16 on the card (kernels) against bf16 on the CPU (plain
    versions), s3_l at full width and depth 4, the same weights and initial
    latents, ``length`` s, 3 DDIM steps, eta 0; the CPU's f32 output on the
    f32 weights the bf16 ones were cast from is the yardstick.  Every card
    launch bf16."""
    import copy

    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("s3_l").to_dict())
    cfg["model"]["depth"] = 4
    cpu32 = EzAudio(config=cfg, device="cpu", seed=6)
    cpu = EzAudio(config=cfg, device="cpu", seed=6, dtype=torch.bfloat16)
    gpu = EzAudio(config=cfg, device=dev, seed=6, dtype=torch.bfloat16)
    for a, b in ((cpu.dit, gpu.dit), (cpu.t5, gpu.t5),
                 (cpu.autoencoder.model, gpu.autoencoder.model)):
        b.load_state_dict(a.state_dict())
    frames = int(length * gpu.latent_sr)
    noise = torch.randn(2, frames, gpu.latent_dim, generator=gen, device=dev).cpu()
    kw = dict(length=length, ddim_steps=3, eta=0.0, random_seed=0, initial_latents=noise)
    prompts = ["a dog barking in the rain", "wind through trees"]
    reset_counters()
    _, wg = gpu.generate_audio(prompts, **kw)
    attn, res = read_counters()
    by_dtype = read_dtype_counters()
    _, wc = cpu.generate_audio(prompts, **kw)
    _, w32 = cpu32.generate_audio(prompts, **kw)
    err, ref = float(np.abs(wg - wc).max()), float(np.abs(wc - w32).max())
    scale = float(np.abs(wc).max())
    corr = float(np.corrcoef(wg.ravel(), wc.ravel())[0, 1])
    row = dict(shape=list(wg.shape), max_abs_err=err, bf16_vs_f32_max_abs=ref,
               ref_abs_max=scale, rel_err=err / scale, bf16_vs_f32_rel=ref / scale, corr=corr,
               bf16_vs_f32_corr=float(np.corrcoef(wc.ravel(), w32.ravel())[0, 1]),
               ref_factor=BF16_REF_FACTOR, min_corr=BF16_PIPE_MIN_CORR,
               attention_launches=attn, resunit_launches=res, launches_by_dtype=by_dtype)
    log("bf16_card_vs_cpu " + json.dumps(row))
    if not (np.isfinite(wg).all() and 0 < ref and err <= BF16_REF_FACTOR * ref
            and corr > BF16_PIPE_MIN_CORR):
        raise AssertionError("bf16: card and CPU disagree")
    if (attn, res) != (want_attention(4, 3), 12) or by_dtype != want_by_dtype(attn, res,
                                                                             "bfloat16"):
        raise AssertionError(f"bf16_card_vs_cpu launches {by_dtype}")
    return row


def unfold_weight_norm(sd):
    """A folded VAE state dict in the reference's weight-norm form: each
    conv weight W as ``weight_v`` = W times a fixed positive scale per
    first-axis channel and ``weight_g`` = ||W|| over the other axes."""
    import torch

    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 3:
            c = 1.0 + 0.5 * torch.sin(torch.arange(v.shape[0], dtype=v.dtype,
                                                   device=v.device))[:, None, None]
            out[k + "_v"] = v * c
            out[k + "_g"] = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        else:
            out[k] = v
    return out


def write_checkpoints(cn, d):
    """``cn``'s base and ControlNet in the reference formats under ``d``."""
    import torch

    base = cn.base
    host = {k: v.cpu() for k, v in base.t5.state_dict().items()}
    t5 = {"shared.weight": host.pop("embed_tokens.weight")}
    t5.update({"encoder." + k: v for k, v in host.items()})
    vae = unfold_weight_norm(base.autoencoder.model.state_dict())
    files = dict(
        ckpt_path=("dit.pt", {"model": base.dit.state_dict()}),
        vae_path=("vae.pt", {"state_dict": {"autoencoder." + k: v.cpu()
                                            for k, v in vae.items()}}),
        t5_path=("t5.pt", t5),
        controlnet_path=("controlnet.pt", {"model": cn.controlnet.state_dict()}))
    paths = {}
    for key, (name, obj) in files.items():
        paths[key] = os.path.join(d, name)
        torch.save(obj, paths[key])
    return paths


def checkpoint_round_trip(cn, length=2.0, steps=5):
    """Phase 18: ``cn`` (f32, seeded) written in the reference formats to a
    temporary directory, loaded back through ``EzAudio(ckpt_path=,
    vae_path=, t5_path=)`` and ``EzAudioControlNet(controlnet_path=)`` onto
    the same device; a ``length`` s DDIM call (eta 0, given initial
    latents) and a ControlNet DPM call (the window set to ``length``) equal
    the writer's within CKPT_REL_TOL of the range."""
    import tempfile

    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    base = cn.base
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_checkpoints(cn, d)
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths.values()) / 2**30
        t0 = time.perf_counter()
        ez = EzAudio(config=base.params_cfg.to_dict(), device=base.device,
                     **{k: paths[k] for k in ("ckpt_path", "vae_path", "t5_path")})
        cn2 = EzAudioControlNet(base=ez, controlnet_path=paths["controlnet_path"])
        sync(base.device)
        load_s = time.perf_counter() - t0
    on_device = all(t.device.type == base.device.type
                    for m in (ez.dit, ez.t5, ez.autoencoder.model, cn2.controlnet)
                    for t in m.state_dict().values())
    frames = int(length * base.latent_sr)
    noise = torch.randn(1, frames, base.latent_dim, generator=torch.Generator().manual_seed(8))
    kw = dict(length=length, ddim_steps=steps, eta=0.0, random_seed=0, initial_latents=noise)
    want = base.generate_audio(PROMPTS[0], **kw)[1]
    got = ez.generate_audio(PROMPTS[0], **kw)[1]
    clip = burst_clip(base.sr, length)
    with controlnet_window(length):
        ckw = dict(sampler="dpm", ddim_steps=steps, random_seed=21)
        cwant = cn.generate_audio(CONTROLNET_PROMPT, clip, **ckw)[1]
        cgot = cn2.generate_audio(CONTROLNET_PROMPT, clip, **ckw)[1]
    errs = [float(np.abs(a - b).max()) / float(np.abs(b).max())
            for a, b in ((got, want), (cgot, cwant))]
    row = dict(files_gib=size, write_s=write_s, load_s=load_s, weights_on_device=on_device,
               generate_rel_err=errs[0], controlnet_rel_err=errs[1], rel_tol=CKPT_REL_TOL)
    log("checkpoint_round_trip " + json.dumps(row))
    if not (on_device and all(e <= CKPT_REL_TOL for e in errs)
            and np.isfinite(got).all() and np.isfinite(cgot).all()):
        raise AssertionError(f"checkpoint round trip: {row}")
    return row


def s3_xl_path(dev="cuda", config=None, length=10.0):
    """Phase 19: s3_xl in bf16 at full width and depth, ``generate_audio``
    at its defaults for 1 prompt; every launch bf16."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    ez = build_ezaudio(dev, config=config, model="s3_xl", dtype="bfloat16")
    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    return run_path("s3_xl_bf16[1]", ez.device,
                    lambda: ez.generate_audio(PROMPTS[:1], length=length, random_seed=1234)[1],
                    want_attention(depth, 100), want_res, length, n_samples, dtype="bfloat16")


# ---------------------------------------------------------------------------
# Phases 20-22: CLAP reranking and the HuBERT (ContentVec) conditioner
CLAP_IDS_LENGTHS = (32, 20, 11, 7)


def clap_ids(vocab: int = 50265, pad: int = 1, lengths=CLAP_IDS_LENGTHS, seed: int = 0):
    """Seeded RoBERTa ids (len(lengths), max(lengths)): BOS 0, random
    tokens, and each row shorter than the longest padded with the pad id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), max(lengths)), pad, np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(3, vocab, n)
        ids[b, 0] = 0
    return ids


def build_scorer(dev="cuda", cfg=None):
    """``CLAPScorer(cfg)`` (``laion/clap-htsat-unfused`` widths by default)
    on seeded random weights."""
    import torch

    from ezaudio_tpu_torch.audio.clap import CLAPScorer

    t0 = time.perf_counter()
    scorer = CLAPScorer(cfg, device=dev)
    sync(dev)
    log(f"rerank: CLAPScorer built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in scorer.model.parameters()) / 1e6:.1f} M params, "
        f"{mem_gib(torch.cuda.memory_allocated)} GiB allocated")
    return scorer


def rerank_path(ez, scorer, ids, row=2, n_candidates=4, length=10.0):
    """Phase 20: ``generate_audio_reranked`` on 1 prompt at the reference
    recipe, ``n_candidates`` candidates in one batched call, scored against
    CLAP ids row ``row``; then the scoring alone, timed."""
    import numpy as np

    from ezaudio_tpu_torch.audio.clap import prepare_clap_audio
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    out = {}

    def call():
        sr, best, allw, scores = ez.generate_audio_reranked(
            PROMPTS[:1], scorer, n_candidates=n_candidates, text_ids=ids[row:row + 1],
            return_all=True, length=length, random_seed=1234)
        out.update(sr=sr, all=allw[0], scores=scores[0])
        return best[0]

    res = run_path(f"rerank[1x{n_candidates}]", ez.device, call, want_attention(depth, 100),
                   per_decode * -(-n_candidates // 4), length, n_samples)
    if out["all"].shape != (n_candidates, n_samples) or not np.isfinite(out["scores"]).all():
        raise AssertionError(f"rerank: candidates {out['all'].shape}, scores {out['scores']}")
    sr, wavs, dev = out["sr"], out["all"], ez.device

    def wall_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    feats = prepare_clap_audio(wavs, sr, device=scorer.device)
    res.update(out, row=row, score_ms=dict(
        embed_audio=wall_ms(lambda: scorer.embed_audio(wavs, sr)),
        prepare_audio=wall_ms(lambda: prepare_clap_audio(wavs, sr, device=scorer.device)),
        audio_tower=wall_ms(lambda: scorer.model(input_features=feats)),
        embed_text=wall_ms(lambda: scorer.embed_text(ids[row:row + 1]))))
    log("rerank_scores " + json.dumps(dict(scores=out["scores"].tolist(),
                                           score_ms=res["score_ms"])))
    return res


CLAP_EMBED_ATOL = 1e-4  # card against CPU, unit embeddings
CLAP_TIE = 2e-4         # the choice may differ where the CPU's top two are this close
CLAP_SCORE_ATOL = 2e-4  # card against CPU, the candidates' scores


def clap_agreement(name, got_audio, want_audio, got_text, want_text, got_scores, want_scores):
    """Card (``got_*``) against CPU (``want_*``): both embeddings within
    CLAP_EMBED_ATOL; the same best candidate per prompt unless the CPU's
    top two scores are within CLAP_TIE (a tie the card may break the other
    way); the scores within CLAP_SCORE_ATOL."""
    import numpy as np

    got_audio, want_audio, got_text, want_text, got_scores, want_scores = (
        np.asarray(x, np.float64) for x in (got_audio, want_audio, got_text, want_text,
                                           got_scores, want_scores))
    err_a = float(np.abs(got_audio - want_audio).max())
    err_t = float(np.abs(got_text - want_text).max())
    top2 = np.sort(want_scores, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > CLAP_TIE
    same = got_scores.argmax(-1) == want_scores.argmax(-1)
    err_s = float(np.abs(got_scores - want_scores).max())
    row = dict(audio_max_abs_err=err_a, text_max_abs_err=err_t, atol=CLAP_EMBED_ATOL,
               scores_max_abs_err=err_s, scores_atol=CLAP_SCORE_ATOL,
               top_two_gap=(top2[..., 1] - top2[..., 0]).tolist(),
               card_choice=got_scores.argmax(-1).tolist(),
               cpu_choice=want_scores.argmax(-1).tolist(), decided=decided.tolist(),
               tie=CLAP_TIE)
    log(f"{name} " + json.dumps(row))
    if not (np.isfinite(got_audio).all() and np.isfinite(got_text).all()
            and err_a <= CLAP_EMBED_ATOL and err_t <= CLAP_EMBED_ATOL):
        raise AssertionError(f"{name}: card and CPU embeddings disagree")
    if not np.all(same | ~decided):
        raise AssertionError(f"{name}: card and CPU choose different candidates")
    if not err_s <= CLAP_SCORE_ATOL:
        raise AssertionError(f"{name}: card and CPU scores disagree")
    return row


def clap_card_vs_cpu(scorer, res, ids):
    """Phase 20's check: the card's candidates scored again by the port's
    CPU ``CLAPScorer`` on the same weights."""
    import torch

    from ezaudio_tpu_torch.audio.clap import CLAPScorer

    cpu = CLAPScorer(scorer.cfg, device="cpu",
                     weights={k: v.cpu() for k, v in scorer.model.state_dict().items()})
    got_a = scorer.embed_audio(res["all"], res["sr"]).cpu()
    want_a = cpu.embed_audio(res["all"], res["sr"])
    got_t, want_t = scorer.embed_text(ids).cpu(), cpu.embed_text(ids)
    row = res["row"]
    want_scores = torch.einsum("kd,d->k", want_a, want_t[row])
    return clap_agreement("rerank_card_vs_cpu", got_a, want_a, got_t, want_t, res["scores"],
                          want_scores)


def served_rerank(ez, scorer, ids, row=2, steps=25, length=10.0):
    """Phase 21: a ``GenerationServer(ez, clap_scorer=scorer)`` whose recipe
    (DPM, ``steps`` steps) has ``fused=True`` given one ``submit_reranked``
    (4 candidates) and one plain request: the rerank runs staged and equals
    the direct call (phase 12's rule), one rerank request is counted, and
    the counters show the staged rerank plus the plain request's program."""
    import numpy as np

    from ezaudio_tpu_torch.serving import GenerationServer

    depth = ez.params_cfg.model.depth
    text_ids = ids[row:row + 1]
    srv = GenerationServer(ez, clap_scorer=scorer, max_batch_size=4, max_wait_ms=100,
                           length=length, ddim_steps=steps, sampler="dpm", fused=True)
    seen = set()
    replays_before = {k: p.replays for k, p in ez._fused.items()}
    reset_counters()
    sync(ez.device)
    with resunit_shapes(seen), srv:
        t0 = time.perf_counter()
        fut_r = srv.submit_reranked(PROMPTS[0], n_candidates=4, seed=31, text_ids=text_ids)
        fut_g = srv.submit(PROMPTS[1], seed=32)
        (sr, wav), lat = fut_r.result(timeout=600), [time.perf_counter() - t0]
        plain = fut_g.result(timeout=600)[1]
        lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    stats = dict(srv.stats)
    per_call = want_attention(depth, steps)
    new = [k for k in ez._fused if k not in replays_before]
    replayed = sum(p.replays - replays_before.get(k, 0) for k, p in ez._fused.items())
    if ez.device.type != "cuda":  # no graphs: the plain request runs eagerly
        want, launches = (2 * per_call, 24), (attn, res)
    else:  # its program's warm-up and capture pass the counters, replays do not
        want = (per_call * (1 + 2 * len(new)), 12 * (1 + 2 * len(new)))
        launches = (per_call * (1 + replayed), 12 * (1 + replayed))
    row_ = dict(path="served_rerank", requests=2, wall_s=wall, **latency_stats(lat),
                audio_s=2 * length, stats=stats, attention_launches=launches[0],
                resunit_launches=launches[1], resunit_shapes=sorted(seen, reverse=True),
                new_programs=len(new), replays=replayed)
    log("served_rerank " + json.dumps(row_))
    if stats["rerank_requests"] != 1:
        raise AssertionError(f"served_rerank: {stats['rerank_requests']} rerank requests")
    if (attn, res) != want:
        raise AssertionError(f"served_rerank: counters {attn}, {res}: want {want}")
    n = int(length * sr)
    for w in (wav, plain):
        if w.shape != (n,) or not np.isfinite(w).all():
            raise AssertionError(f"served_rerank: output {w.shape} for {length} s")
    _, direct = ez.generate_audio_reranked(PROMPTS[0], scorer, n_candidates=4,
                                           text_ids=text_ids, random_seed=31, length=length,
                                           ddim_steps=steps, sampler="dpm")
    row_["vs_direct"] = agreement("served_rerank_vs_direct", wav, direct, {})
    return row_


def vc_frames(cfg, sr: int, seconds: float) -> int:
    """ContentVec frames of ``seconds`` at ``sr``: resampled to 16 kHz,
    padded by 40 samples on each side, through the conv stack."""
    n = -(-int(seconds * sr) * 16000 // sr) + 80
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


def check_vc_shape(feats, cfg, sr: int, seconds: float, latent_sr: int = 50):
    """One ContentVec frame per latent frame: (1, seconds * latent_sr,
    hidden_size)."""
    want = (1, vc_frames(cfg, sr, seconds), cfg.hidden_size)
    if tuple(feats.shape) != want or want[1] != round(seconds * latent_sr):
        raise AssertionError(f"vc: features {tuple(feats.shape)}, want {want} "
                             f"({seconds * latent_sr:g} latent frames)")


def vc_path(dev="cuda", cfg=None, sr=24000, seconds=10.0, reps=5, latent_sr=50):
    """Phase 22: ``Conditioner('vc', sr=sr)`` (ContentVec-base widths by
    default) on a seeded clip: shape, wall (median of ``reps``), peak; then
    the port's CPU extractor on the same weights, within VC_REL_TOL of the
    CPU output's range."""
    import warnings

    import numpy as np
    import torch

    from ezaudio_tpu_torch.models.conditioners import Conditioner
    from ezaudio_tpu_torch.models.hubert import VoiceConversionExtractor

    with warnings.catch_warnings(record=True) as caught:  # random weights: it warns
        warnings.simplefilter("always")
        cond = Conditioner("vc", sr=sr, hubert_config=cfg, device=dev)
    log(f"vc: {sum(p.numel() for p in cond.fn.model.parameters()) / 1e6:.1f} M params; "
        f"warned: {[str(w.message)[:40] for w in caught]}")
    clip = seeded_clip(sr, seconds)[None]
    cuda = torch.device(dev).type == "cuda"
    feats = cond(clip)  # warm-up
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        feats = cond(clip)
        sync(dev)
        times.append(time.perf_counter() - t0)
    check_vc_shape(feats, cond.fn.cfg, sr, seconds, latent_sr)
    cpu = VoiceConversionExtractor(sr, cond.fn.cfg, device="cpu", weights={
        k: v.cpu() for k, v in cond.fn.model.state_dict().items()})
    got, want = feats.float().cpu().numpy(), cpu(clip).numpy()
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    row = dict(path="vc", shape=list(got.shape), wall_s=statistics.median(times),
               wall_s_all=times, peak_mem_gib=mem_gib(torch.cuda.max_memory_allocated)
               if cuda else None, max_abs_err=err, ref_abs_max=scale, rel_err=err / scale,
               rel_tol=VC_REL_TOL)
    log("vc " + json.dumps(row))
    if not (np.isfinite(got).all() and err <= VC_REL_TOL * scale):
        raise AssertionError("vc: card and CPU features disagree")
    return row


# ---------------------------------------------------------------------------
# Training (phases 23-25).  (B, H, Lq, Lk, head_dim, key mask) of the train
# step at batch 8: s3_l self-attention and T5-masked cross-attention.
TRAIN_BATCH = 8
ATTN_GRAD_CASES = [(TRAIN_BATCH, 16, 500, 500, 64, False),
                   (TRAIN_BATCH, 16, 500, 100, 64, True)]
RESUNIT_GRAD_CASE = (TRAIN_BATCH, 30000, 256, 3)  # the encoder's third block
# A kernel wrapper's gradients against the plain twin's on the same inputs:
# the backward is the plain twin's vjp in both, so they agree to rounding.
# Each gradient within KERNEL_GRAD_TOL of its largest entry, and none zero
# where the plain twin's is not (a detached output).
KERNEL_GRAD_TOL = 1e-6
# Since that backward is the plain twin's vjp at the saved inputs, the
# comparison above checks only which inputs were saved.  SDPA's gradients
# on the same q, k, v and output gradient are an independent witness: f32
# products summed in another order (TF32 off), each gradient within
# SDPA_GRAD_TOL of its largest entry.
SDPA_GRAD_TOL = 1e-4
# The train step, card against CPU (s3_l widths, depth 2): the loss and the
# grad norm within TRAIN_REL_TOL; each gradient within TRAIN_GRAD_TOL of its
# largest entry (f32 sums in another order over batch, tokens and heads),
# or of GRAD_FLOOR times the largest entry of all gradients where a
# tensor's own gradient is rounding noise around an exact 0 (the bias of
# the cross-attention's key norm shifts every score of a row alike, which
# the softmax ignores: its gradient reads ~3e-11 against a largest entry of
# all gradients of ~0.05, and differs by as much); the updated parameters
# within 2 lr everywhere (Adam's first step moves a parameter by
# lr g / (|g| + eps): a gradient near 0 may take either sign) and, where
# |g| > ADAM_STABLE_GRAD, within 1e-3 lr (the ratio moves by eps dg / g^2
# < 1e-3 for dg < 1e-5) plus two f32 ulps of the parameter (its rounding).
TRAIN_REL_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
ADAM_STABLE_GRAD = 1e-4
# a resumed run's losses against the uninterrupted run's, relative
RESUME_REL_TOL = 1e-5


def grad_agreement(got: dict, want: dict, tol: float, floor: float = 0.0):
    """``(ok, rows)``: each gradient of ``got`` within ``tol`` of the
    largest entry of ``want``'s (or of ``floor`` times the largest entry of
    all of them, where that is more), and none all zero where ``want``'s
    is above that floor."""
    scales = {n: w.float().abs().max().item() for n, w in want.items()}
    least = floor * max(scales.values(), default=0.0)
    rows = {}
    for name, w in want.items():
        g = got[name].float().cpu()
        w = w.float().cpu()
        scale = scales[name]
        err = (g - w).abs().max().item() if g.shape == w.shape else float("inf")
        zero = g.abs().max().item() == 0.0 and scale > least
        rows[name] = dict(max_abs_err=err, scale=scale,
                          rel_err=err / max(scale, least, 1e-30), zero=zero)
    ok = all(r["rel_err"] <= tol and not r["zero"] for r in rows.values())
    return ok, rows


def qkv_grads_nonzero(grads: dict):
    """The q, k and v projection weights of every attention with their
    gradient's largest entry: a detached attention output leaves exactly
    these at 0 (ROADMAP F11)."""
    names = [n for n in grads if any(f"attn.to_{x}.weight" in n for x in "qkv")]
    return {n: grads[n].abs().max().item() for n in names}


def _grad_failures(rows, tol=KERNEL_GRAD_TOL):
    return {n: r for n, r in rows.items() if r["zero"] or not r["rel_err"] <= tol}


def check_attention_grad(dev, gen, cases=ATTN_GRAD_CASES):
    """Phase 23, kernel 1: the autograd gradients through the kernel's
    wrapper against those through the plain twin and SDPA's, the output's
    ``grad_fn``; the backward's time (the plain recompute and its vjp), its
    bound and SDPA's forward and backward."""
    import torch
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention

    rows = []
    for (B, H, Lq, Lk, D, masked) in cases:
        q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen).requires_grad_()
                   for L in (Lq, Lk, Lk))
        g = torch.randn(B, H, Lq, D, device=dev, generator=gen)
        mask = None
        if masked:  # T5-style padding
            lens = torch.tensor([23 if i % 2 == 0 else Lk for i in range(B)], device=dev)
            mask = torch.arange(Lk, device=dev)[None, :] < lens[:, None]
        o = fused_attention(q, k, v, key_mask=mask)
        if o.grad_fn is None or type(o.grad_fn).__name__ != "FusedAttentionBackward":
            raise AssertionError(f"attention {B, H, Lq, Lk, D}: output has no kernel grad_fn")
        got = dict(zip("qkv", torch.autograd.grad(o, (q, k, v), g, retain_graph=True)))
        want = dict(zip("qkv", torch.autograd.grad(attention_plain(q, k, v, mask), (q, k, v), g)))
        sync(dev)
        ok, grads = grad_agreement(got, want, KERNEL_GRAD_TOL)
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
            return torch.autograd.grad(out, (q, k, v), g)

        ok_sdpa, by_sdpa = grad_agreement(got, dict(zip("qkv", sdpa_fwd_bwd())), SDPA_GRAD_TOL)

        bwd_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True),
                         reps=3, iters=3)
        lib_ms = time_ms(sdpa_fwd_bwd, reps=3, iters=3)
        # the backward reads q, k, v and the output's gradient once and
        # writes the three gradients; its products: the scores again, dV,
        # dP, dQ and dK
        nbytes = 2 * (2 * Lq + 2 * Lk) * B * H * D * 4 + (B * Lk if masked else 0)
        bms, by = bound_ms(nbytes, 10.0 * B * H * Lq * Lk * D, "float32")
        row = dict(kind="attention_backward", shape=[B, H, Lq, Lk, D], masked=masked,
                   grads={n: {k2: r[k2] for k2 in ("rel_err", "scale")} for n, r in grads.items()},
                   sdpa_rel_err={n: r["rel_err"] for n, r in by_sdpa.items()},
                   backward_ms=bwd_ms, bound_ms=bms, bound_by=by,
                   library_fwd_bwd_ms=lib_ms, grad_fn=type(o.grad_fn).__name__)
        log("attention_grad " + json.dumps(row))
        if not ok:
            raise AssertionError(f"attention gradients {row['shape']}: {_grad_failures(grads)}")
        if not ok_sdpa:
            raise AssertionError(f"attention gradients {row['shape']} against SDPA's: "
                                 f"{_grad_failures(by_sdpa, SDPA_GRAD_TOL)}")
        rows.append(row)
    return rows


def check_resunit_grad(dev, gen, case=RESUNIT_GRAD_CASE):
    """Phase 23, kernel 2: the nine autograd gradients through the kernel's
    wrapper against those through the plain twin at one encoder shape."""
    import torch

    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit, residual_unit_plain

    B, L, C, d = case
    args = [a.requires_grad_() for a in resunit_args(dev, gen, B, L, C)]
    g = torch.randn(B, L, C, device=dev, generator=gen)
    y = fused_residual_unit(*args, d)
    if y.grad_fn is None or type(y.grad_fn).__name__ != "FusedResidualUnitBackward":
        raise AssertionError("resunit: output has no kernel grad_fn")
    names = ["x", "w7", "b7", "w1", "b1", "a1", "be1", "a2", "be2"]
    got = dict(zip(names, torch.autograd.grad(y, args, g)))
    want = dict(zip(names, torch.autograd.grad(residual_unit_plain(*args, d), args, g)))
    sync(dev)
    ok, grads = grad_agreement(got, want, KERNEL_GRAD_TOL)
    row = dict(kind="resunit_backward", shape=[B, L, C], dilation=d,
               grads={n: r["rel_err"] for n, r in grads.items()},
               grad_fn=type(y.grad_fn).__name__)
    log("resunit_grad " + json.dumps(row))
    if not ok:
        raise AssertionError(f"resunit gradients: {_grad_failures(grads)}")
    return row


def write_training_set(root, clips=16, seconds=10.0, sr=24000, seed=0):
    """``clips`` seeded clips (a tone in bursts over noise, each its own
    pitch) as f32 wav files and a manifest; returns the manifest's path."""
    import csv

    import numpy as np

    from ezaudio_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    rows = []
    for i in range(clips):
        wav = (0.3 * np.sin(2 * np.pi * (110 + 40 * i) * t) * (np.floor(t * (2 + i % 3)) % 2)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        save_wav(os.path.join(root, "audio", f"{i}.wav"), wav, sr)
        rows.append(dict(audio_path=f"{i}.wav", caption=PROMPTS[i % len(PROMPTS)], split="train",
                         audio_length=seconds, absolute_index=i, fine_tune_data=True))
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return meta


def training_config(root, cfg, meta, batch, seconds, sr, warmup=2):
    """``cfg`` (s3_l's) with ``opt:`` and ``data:`` blocks; returns its path."""
    cfg = dict(cfg, opt=dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
                             adam_epsilon=1e-8, warmup=warmup, grad_clip=1.0, snr_gamma=None,
                             batch_size=batch, accumulation_steps=1),
               data=dict(train=dict(data_dir=os.path.join(root, "audio"), meta_dir=meta,
                                    subset="train", seg_length=seconds, sr=sr, mono=True)))
    cfg["text_encoder"] = dict(cfg["text_encoder"], cfg=0.1)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def train_attention_launches(model_cfg: dict) -> int:
    """Attention launches of one train step: self- and cross-attention in
    each of the depth + 1 blocks, twice with remat (forward and the
    backward's recompute); the backward itself launches none."""
    return 2 * (model_cfg["depth"] + 1) * (2 if model_cfg.get("use_checkpoint") else 1)


# The linears that see the text tokens, and those that see one token per
# sample; every other linear or conv of the DiT sees the latent frames.
TEXT_LINEARS = ("context_embed.", "cross_attn.to_k", "cross_attn.to_v")
SAMPLE_LINEARS = ("time_embed.", "time_ada", "adaln.lora_")


def train_flops(model, batch: int, frames: int, text_len: int, remat: bool = True) -> float:
    """The model FLOPs of one train step of the MaskDiT ``model``: 2 per
    weight of a linear or conv and per token it sees (the frames; the text
    tokens for ``TEXT_LINEARS``; one per sample for ``SAMPLE_LINEARS``),
    and attention's products, 4 B H Lq Lk D per call.  Each forward FLOP
    counts once for the forward, twice for the backward and, with full
    remat, once more inside the blocks for their recompute.  Biases,
    norms, elementwise work, the VAE and T5 are not counted."""
    from torch import nn

    from ezaudio_tpu_torch.models.blocks import Attention

    total = 0.0
    for name, mod in model.named_modules():
        times = 4 if remat and ("_blocks." in name or "mid_block." in name) else 3
        if isinstance(mod, (nn.Linear, nn.modules.conv._ConvNd)):
            seen = (text_len if any(s in name for s in TEXT_LINEARS)
                    else 1 if any(s in name for s in SAMPLE_LINEARS) else frames)
            total += times * 2.0 * mod.weight.numel() * batch * seen
        elif isinstance(mod, Attention):
            keys = text_len if name.endswith("cross_attn") else frames
            total += times * 4.0 * batch * mod.num_heads * frames * keys * mod.head_dim
    return total


def training_path(dev="cuda", cfg=None, clips=16, batch=TRAIN_BATCH, seconds=10.0, steps=6,
                  resume_at=4, sr=24000, t5_config=None, vae_config=None):
    """Phase 24: ``train_cli.main`` on a seeded dataset of ``clips`` clips,
    batch ``batch``, ``steps`` steps, warmup 2, CFG dropout 0.1, the
    model config's remat; the per-step launches checked.  Then the trainer
    is deleted, the checkpoint after ``steps`` removed, and a restart from
    step ``resume_at`` must give the uninterrupted run's last losses."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.models.udit import resolve_remat_policy
    from ezaudio_tpu_torch.training import train_cli

    cfg = cfg if cfg is not None else get_model_config("s3_l").to_dict()
    m = cfg["model"]
    want_attn = train_attention_launches(m)
    cuda = torch.device(dev).type == "cuda"
    frames = int(seconds * cfg["autoencoder"]["latent_sr"])
    root = tempfile.mkdtemp(prefix="ezaudio_train_")
    try:
        meta = write_training_set(root, clips, seconds, sr)
        path = training_config(root, cfg, meta, batch, seconds, sr)

        def run(max_steps, record):
            state = {"t": None}
            shapes = set()

            def on_step(step, metrics):
                sync(dev)
                now = time.perf_counter()
                attn, res = read_counters()
                record.append(dict(step=step, loss=metrics["loss"].item(),
                                   grad_norm=metrics["grad_norm"].item(),
                                   wall_s=now - state["t"], attention_launches=attn,
                                   resunit_launches=res,
                                   launches_by_dtype=read_dtype_counters()))
                reset_counters()
                state["t"] = time.perf_counter()

            argv = ["--config-name", path, "--max-steps", str(max_steps),
                    "--save-every-step", str(resume_at), "--log-step", "1",
                    "--log-dir", os.path.join(root, "logs"),
                    "--save-dir", os.path.join(root, "ckpts"), "--random-seed", "0"]
            if not cuda:
                argv += ["--device", dev]
            with resunit_shapes(shapes, full=True):
                reset_counters()
                state["t"] = time.perf_counter()
                trainer = train_cli.main(argv, t5_config=t5_config, vae_config=vae_config,
                                         on_step=on_step)
            n = sum(p.numel() for p in trainer.model.parameters())
            udit = trainer.model.model
            flops = train_flops(trainer.model, batch, frames, cfg["text_encoder"]["max_length"],
                                remat=udit.use_checkpoint
                                and resolve_remat_policy(udit.remat_policy) == "full")
            del trainer  # its memory is checked back by the caller
            return n, flops, shapes

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        first, resumed = [], []
        n_params, flops, shapes = run(steps, first)
        peak = mem_gib(torch.cuda.max_memory_allocated) if cuda else None
        shutil.rmtree(os.path.join(root, "ckpts", cfg.get("model_name", "model"), str(steps)))
        run(steps, resumed)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    walls = [r["wall_s"] for r in first[1:]]
    wall = statistics.median(walls)
    row = dict(path="train", card=card_line() if cuda else "cpu", batch=batch, clip_s=seconds,
               steps=steps, dit_params=n_params,
               step_wall_s=wall, step_wall_s_all=[r["wall_s"] for r in first],
               samples_per_s=batch / wall, audio_s_per_s=batch * seconds / wall,
               flops_per_step=flops, flop_rule="train_flops: per module, by the tokens each sees",
               model_tflops=flops / wall / 1e12, peak_mem_gib=peak,
               losses=[r["loss"] for r in first], grad_norms=[r["grad_norm"] for r in first],
               resumed_losses=[r["loss"] for r in resumed],
               launches_per_step=[[r["attention_launches"], r["resunit_launches"]] for r in first],
               resunit_batch_shapes=sorted(shapes))
    log("train " + json.dumps(row))
    want_dtype = want_by_dtype(want_attn, 12, "float32")
    for r in first + resumed:
        if (r["attention_launches"], r["resunit_launches"]) != (want_attn, 12):
            raise AssertionError(f"train step {r['step']}: launches {r['attention_launches']}, "
                                 f"{r['resunit_launches']}: want {want_attn}, 12")
        if r["launches_by_dtype"] != want_dtype:
            raise AssertionError(f"train step {r['step']}: launches by dtype "
                                 f"{r['launches_by_dtype']}, want {want_dtype}")
    if len(first) != steps or not np.isfinite(row["losses"]).all():
        raise AssertionError(f"train: losses {row['losses']}")
    if [r["step"] for r in resumed] != list(range(resume_at + 1, steps + 1)):
        raise AssertionError(f"train: the restart ran steps {[r['step'] for r in resumed]}")
    tail = np.array(row["losses"][resume_at:])
    if not np.allclose(row["resumed_losses"], tail, rtol=RESUME_REL_TOL, atol=0):
        raise AssertionError(f"train: resumed losses {row['resumed_losses']}, want {tail}")
    row.update(attention_launches=sum(r["attention_launches"] for r in first + resumed),
               resunit_launches=sum(r["resunit_launches"] for r in first + resumed),
               resunit_shapes=sorted({s[1:3] for s in shapes}, reverse=True))
    return row


def train_step_card_vs_cpu(gen, dev="cuda", cfg=None, batch=2, text_len=100,
                           policies=("full", "dots", "off")):
    """Phase 25: one train step on the card under each remat policy of
    ``policies`` and one on the CPU (full remat), all from the same
    weights, batch and draws (s3_l widths, depth 2).  Each card step is
    held to the CPU's: loss, grad norm, every gradient, every updated
    parameter, the attention launches its policy implies, and a non-zero
    gradient on the q, k and v projections of every attention."""
    import copy

    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.trainer import Trainer

    if cfg is None:
        cfg = get_model_config("s3_l").to_dict()
        cfg["model"]["depth"] = 2
    cfg = copy.deepcopy(cfg)
    m = cfg["model"]
    schedule = DDIMSchedule.from_config(cfg["diff"])
    lr = 1e-4
    opt = dict(learning_rate=lr, warmup=0, grad_clip=1.0, weight_decay=0.01, snr_gamma=5.0)
    cpu_gen = torch.Generator().manual_seed(25)
    with torch.device(dev):
        first = maskdit_from_config(m)
    init_random_(first, gen)
    weights = {k: v.cpu() for k, v in first.state_dict().items()}
    del first
    frames, C = m["img_size"], m["out_chans"]
    ctx = m["context_dim"]
    text_mask = torch.ones(batch, text_len, dtype=torch.bool)
    text_mask[0, 23:] = False
    uncond_mask = torch.zeros(1, text_len, dtype=torch.bool)
    uncond_mask[0, :1] = True
    host = dict(latents=torch.randn(batch, frames, C, generator=cpu_gen),
                text=torch.randn(batch, text_len, ctx, generator=cpu_gen), text_mask=text_mask,
                uncond=torch.randn(1, text_len, ctx, generator=cpu_gen), uncond_mask=uncond_mask)

    def remat(policy):
        return dict(m, use_checkpoint=policy != "off",
                    remat_policy="full" if policy == "off" else policy)

    def step(policy, device):
        with torch.device(device):
            model = maskdit_from_config(remat(policy))
        model.load_state_dict(weights)
        trainer = Trainer.create(model.train(), schedule, opt)
        draws = trainer.step_fn.draw(torch.Generator().manual_seed(26), batch, frames, C, "cpu")
        draws["cfg"][:] = torch.tensor([0.05] + [0.9] * (batch - 1))  # one sample drops its text
        reset_counters()
        res = trainer.step_fn({k: v.to(device) for k, v in host.items()}, seed=0,
                              draws={k: v.to(device) for k, v in draws.items()},
                              return_grads=True)
        sync(device)
        return dict(loss=res["loss"].item(), grad_norm=res["grad_norm"].item(),
                    grads={k: v.cpu() for k, v in res["grads"].items()},
                    params={k: v.detach().cpu() for k, v in model.named_parameters()},
                    launches=read_counters())

    cpu = step("full", "cpu")
    rows, bad = [], []
    for policy in policies:
        row, failed = train_step_agreement(step(policy, dev), cpu, lr, m["depth"],
                                           train_attention_launches(remat(policy)))
        row.update(path="train_step_card_vs_cpu", remat=policy, depth=m["depth"], batch=batch)
        log("train_card_vs_cpu " + json.dumps(row))
        rows.append(row)
        bad += [f"remat {policy}: {b}" for b in failed]
    if bad:
        raise AssertionError("train step, card against CPU: " + "; ".join(bad))
    return rows


def train_step_agreement(g: dict, c: dict, lr: float, depth: int, want_attn: int):
    """Phase 25's limits on the card's step ``g`` against the CPU's ``c``
    (each: ``loss``, ``grad_norm``, ``grads``, updated ``params`` and the
    card's ``launches``): ``(row, failures)``."""
    ok_grads, rows = grad_agreement(g["grads"], c["grads"], TRAIN_GRAD_TOL, GRAD_FLOOR)
    worst = max(rows, key=lambda n: rows[n]["rel_err"])
    qkv = qkv_grads_nonzero(g["grads"])
    param_err, stable_err = 0.0, 0.0  # the latter in units of its limit
    for n, p in g["params"].items():
        d = (p - c["params"][n]).abs()
        param_err = max(param_err, d.max().item())
        stable = c["grads"][n].abs() > ADAM_STABLE_GRAD
        if stable.any():
            limit = 1e-3 * lr + 2.0 ** -22 * c["params"][n].abs()
            stable_err = max(stable_err, (d / limit)[stable].max().item())
    row = dict(loss=[g["loss"], c["loss"]], grad_norm=[g["grad_norm"], c["grad_norm"]],
               worst_grad=dict(rows[worst], name=worst), n_grads=len(rows),
               param_max_abs_err=param_err, param_stable_err_share_of_limit=stable_err, lr=lr,
               qkv_grads=len(qkv), qkv_min_grad=min(qkv.values(), default=0.0),
               launches=list(g["launches"]), want_attention_launches=want_attn)
    bad = []
    if not abs(g["loss"] - c["loss"]) <= TRAIN_REL_TOL * abs(c["loss"]):
        bad.append("loss")
    if not abs(g["grad_norm"] - c["grad_norm"]) <= TRAIN_REL_TOL * c["grad_norm"]:
        bad.append("grad_norm")
    if not ok_grads:
        bad.append("gradients " + str(sorted(n for n, r in rows.items()
                                             if r["zero"] or not r["rel_err"] <= TRAIN_GRAD_TOL)))
    if not (param_err <= 2 * lr and stable_err <= 1.0):
        bad.append("updated parameters")
    if len(qkv) != 3 * 2 * (depth + 1) or not min(qkv.values(), default=0.0) > 0:
        bad.append(f"q/k/v gradients {qkv}")
    if g["launches"][0] != want_attn:
        bad.append(f"attention launches {g['launches'][0]}, want {want_attn}")
    return row, bad


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
    steps), f32 then bf16, staged and ``fused=True`` (a replay of its
    graph), and of one s3_l train step, with torch.profiler: time per
    kernel class, busy share of the wall time, and the top kernels
    (written to ``out_dir``)."""
    os.makedirs(out_dir, exist_ok=True)
    for dtype in ("float32", "bfloat16"):
        profile_dtype(steps, out_dir, dtype)
    profile_train(out_dir)


def _breakdown(prof, wall_ms, out_path, **info):
    """Log a profile's device ms by kernel class and busy share; write the
    top kernels to ``out_path``."""
    import torch

    by_class, kernels = {}, []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3  # ms
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + t
        kernels.append((t, e.count, e.key))
    busy = sum(by_class.values())
    row = dict(info, wall_ms=wall_ms, device_busy_ms=busy, busy_share=busy / wall_ms,
               ms_by_class=by_class)
    log("profile " + json.dumps(row))
    kernels.sort(reverse=True)
    with open(out_path, "w") as f:
        f.write(json.dumps(row) + "\n")
        for t, cnt, key in kernels[:40]:
            f.write(f"{t:10.3f} ms {cnt:7d}x  {key[:150]}\n")
    return row


def profile_train(out_dir: str, batch: int = TRAIN_BATCH) -> dict:
    """Device-time breakdown of one s3_l train step (batch ``batch`` x 10 s,
    full remat, f32) on seeded latents and text embeddings: the step alone,
    without the data, the VAE encode and T5 of ``train_cli``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.trainer import Trainer

    cfg = get_model_config("s3_l").to_dict()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        dit = maskdit_from_config(cfg["model"])
    init_random_(dit, gen)
    trainer = Trainer.create(dit.train(), DDIMSchedule.from_config(cfg["diff"]),
                             dict(learning_rate=1e-4, warmup=2))
    lens = torch.tensor([23 + 9 * i for i in range(batch)], device="cuda")
    batch_ = dict(latents=torch.randn(batch, 500, 128, device="cuda", generator=gen),
                  text=torch.randn(batch, 100, 1024, device="cuda", generator=gen),
                  text_mask=torch.arange(100, device="cuda")[None] < lens[:, None],
                  uncond=torch.randn(1, 100, 1024, device="cuda", generator=gen),
                  uncond_mask=torch.arange(100, device="cuda")[None] < 1)
    for _ in range(2):
        trainer.train_step(batch_, 0)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch_, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _breakdown(prof, wall_ms, os.path.join(out_dir, "profile_train.txt"),
                      path="train_step", batch=batch, remat="full", dtype="float32")


def profile_dtype(steps: int, out_dir: str, dtype: str) -> None:
    """:func:`profile` for one dtype, on a model of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    ez = EzAudio("s3_l", device="cuda", seed=0, dtype=getattr(torch, dtype))
    for n, fused in ((1, False), (1, True), (4, False), (4, True)):
        prompts = ["a dog barking in the rain"] * n
        # warm up; the fused warm-up captures the profiled call's graph
        ez.generate_audio(prompts, ddim_steps=steps if fused else 2, random_seed=0,
                          fused=fused)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ez.generate_audio(prompts, ddim_steps=steps, random_seed=0, fused=fused)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        tag = ("_fused" if fused else "") + ("" if dtype == "float32" else f"_{dtype}")
        _breakdown(prof, wall_ms, os.path.join(out_dir, f"profile_{n}prompt{tag}.txt"),
                   prompts=n, fused=fused, dtype=dtype, ddim_steps=steps)


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

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs sum in f32, as the JAX package's bf16 products do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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
    with phase("3 kernels"):
        attn_rows = check_attention("cuda", gen)
        res_rows = check_resunit("cuda", gen)
        res_rows += check_resunit("cuda", gen, RESUNIT_BF16_CASES, "bfloat16")
    with phase("23 kernel gradients"):
        check_attention_grad("cuda", gen)
        check_resunit_grad("cuda", gen)
    before = mem_gib(torch.cuda.memory_allocated)
    ez = build_ezaudio()
    with phase("4 main"):
        paths = main_path(ez)
    f32_main = paths[:2]
    with phase("5 card_vs_cpu"):
        card_vs_cpu(gen)
    with phase("6-7 editing, long"):
        paths += edit_paths(ez)
    with phase("8 samplers"):
        paths += sampler_paths(ez)
    with phase("9 card_vs_cpu_fast"):
        card_vs_cpu_fast()
    with phase("10 fused"):
        paths += fused_paths(ez, f32_main)
    with phase("11 int8"):
        int8_rows, _ = int8_paths(ez, gen, paths[0])
    with phase("12 served"):
        served = served_paths(ez)
        served_fused = served_paths(ez, fused=True)  # captures
        served_replay = served_paths(ez, fused=True, name="served_fused_replay")
        served_checks(ez, served, served_fused, served_replay)
    paths += int8_rows + [served, served_fused, served_replay]

    before_clap = mem_gib(torch.cuda.memory_allocated)
    scorer, ids = build_scorer(), clap_ids()
    with phase("20 rerank"):
        rerank = rerank_path(ez, scorer, ids)
        clap_card_vs_cpu(scorer, rerank, ids)
    with phase("21 served rerank"):
        paths += [rerank, served_rerank(ez, scorer, ids)]
    del scorer
    check_freed("CLAP scorer", before_clap)
    del ez  # no gc: nothing holds it in a cycle (ROADMAP F8)
    check_freed("s3_l f32", before)

    ez = build_ezaudio(dtype="bfloat16")
    with phase("16 s3_l bf16"):
        paths += bf16_paths(ez, f32_main)
    del ez
    check_freed("s3_l bf16", before)
    with phase("17 bf16 card_vs_cpu"):
        bf16_card_vs_cpu(gen)

    cn = build_controlnet()
    with phase("13 controlnet"):
        paths += controlnet_paths(cn)
    with phase("14 controlnet card_vs_cpu"):
        controlnet_card_vs_cpu()
    with phase("15 controlnet served"):
        paths.append(controlnet_served(cn))
    with phase("18 checkpoint round trip"):
        checkpoint_round_trip(cn)
    del cn
    check_freed("energy ControlNet", before)
    with phase("19 s3_xl bf16"):
        paths.append(s3_xl_path())
    check_freed("s3_xl bf16", before)
    with phase("22 vc"):
        vc_path()
    check_freed("ContentVec", before)
    with phase("24 train"):
        train = training_path()
        paths.append(train)
    check_freed("s3_l trainer", before)
    missing = sorted(set(train["resunit_batch_shapes"]) - set(RESUNIT_CASES))
    if missing:
        raise AssertionError(f"ResidualUnit shapes of the training path not in phase 3: {missing}")
    with phase("25 train step card_vs_cpu"):
        train_step_card_vs_cpu(gen)
    check_freed("train step card_vs_cpu", before)

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
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
