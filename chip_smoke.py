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
  6. a ``{"kernels": [...]}`` line, then the card's name and power limit,
     and last ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result line, when CUDA is unavailable or the
port's sources are missing.  Bounds use the H100 SXM data-sheet peaks:
3.35 TB/s, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 (tensor cores); an f32
product costs three TF32 products (3xTF32), so f32 work is bounded at
495 / 3 TFLOP/s.
"""

from __future__ import annotations

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
# (B, L, C, dilation): the four decoder blocks of one 10 s clip.
RESUNIT_CASES = ([(1, 5000, 512, d) for d in (1, 3, 9)]
                 + [(1, 30000, 256, 9), (1, 120000, 128, 9)]
                 + [(1, 240000, 128, d) for d in (1, 3, 9)]
                 + [(2, 1001, 256, 9)])       # many tiles, ragged last tile


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


def main_path(dev="cuda", config=None, length=10.0):
    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    t0 = time.perf_counter()
    ez = EzAudio("s3_l", config=config, device=dev, seed=0)
    sync(dev)
    log(f"main: EzAudio('s3_l') built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in ez.dit.parameters()) / 1e9:.3f} B DiT params")
    depth = ez.params_cfg.model.depth
    want_attn = 2 * (depth + 1) * 100  # self + cross per block per step
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    cuda = torch.device(dev).type == "cuda"
    prompts = ["a dog barking in the rain", "footsteps on gravel",
               "a violin playing a slow melody", "thunder rolling in the distance"]
    results, totals = [], [0, 0]
    reset_counters()
    for n in (1, 4):
        attn0, res0 = read_counters()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        sr, wav = ez.generate_audio(prompts[:n], length=length, random_seed=1234)
        sync(dev)
        wall = time.perf_counter() - t0
        attn, res = read_counters()
        attn, res = attn - attn0, res - res0
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        row = dict(prompts=n, wav_shape=list(wav.shape), wall_s=wall,
                   audio_s_per_s=n * length / wall, peak_mem_gib=peak,
                   attention_launches=attn, resunit_launches=res,
                   wav_abs_max=float(np.abs(wav).max()), wav_std=float(wav.std()))
        log("main " + json.dumps(row))
        if wav.shape != (n, n_samples) or not np.isfinite(wav).all():
            raise AssertionError(f"main path output {wav.shape}, finite={np.isfinite(wav).all()}")
        if attn != want_attn or res != want_res:
            raise AssertionError(f"launch counts {attn}, {res}: want {want_attn}, {want_res}")
        results.append(row)
    totals = list(read_counters())
    del ez
    if cuda:
        torch.cuda.empty_cache()
    return results, totals


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
    _, launches = main_path()
    card_vs_cpu(gen)

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
