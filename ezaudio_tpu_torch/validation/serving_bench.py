"""Serving under Poisson load (counterpart of ``scripts/serving_bench.py``):
sustained throughput and latency of ``GenerationServer``.

For each offered rate, requests arrive with exponential gaps (a
``np.random.default_rng(0)`` shared by the rates); request ``n`` takes
prompt ``n mod 8`` and seed ``n``.  Each line reports the requests served
in the window, the achieved req/s and audio-s/s, the p50/p99 latency from
submission to result (per length with ``--mixed``), the batches and the
slot fill: the share of batch slots that served a request rather than
padding (``stats["padded_slots"]``); last, the p50 latency of the first
and the last third of the requests, which climbs over the window once the
offered rate passes what the server can serve (its saturation point).

The model is the script's: s3_xl in bf16 with a tiny T5 (vocab 512,
``d_model`` the DiT's context width, 2 layers, 8 heads) on seeded random
weights.  Before the first rate every batch bucket x length bucket is
warmed with the per-slot starting noise the server passes, so a fused
server captures its graphs then and replays them in the window.  Every
request is awaited: one that failed in the server raises here.

    python -m ezaudio_tpu_torch.validation.serving_bench [rates ...] \
        [--recipe fast|default] [--seconds 60] [--max-batch 8] [--mixed] \
        [--fused | --ab] [--device cpu]

``--recipe fast`` is DPM-25 + ``layer_cache=(2, 2)`` + ``chunked_bf16`` +
int8, ``default`` DDIM-100 (``SERVE_RECIPE``); ``--mixed`` alternates 5 s
and 10 s requests served through two length buckets (``SERVE_MIXED``);
``--fused`` serves one CUDA graph per batch x length bucket
(``SERVE_FUSED``); ``--ab`` runs staged, then fused, in one process
(``SERVE_AB``).  ``--steps`` and ``--length`` cut the recipe's steps and
the clip length (the script's are 25 or 100, and 10 s).
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

import numpy as np
import torch

from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation.quality_validate import precision_line

PROMPTS = [
    "a dog barking in the distance", "heavy rain on a tin roof",
    "a car engine starting", "birds chirping in a forest",
    "footsteps on gravel", "a phone ringing in another room",
    "waves crashing on a beach", "an espresso machine steaming milk",
]
RECIPES = {
    "fast": dict(ddim_steps=25, sampler="dpm", layer_cache=(2, 2), attn_impl="chunked_bf16",
                 quant="int8"),
    "default": dict(ddim_steps=100),
}
RESULT_TIMEOUT_S = 600.0  # the longest a request may take once the window closes


def build_ezaudio(model: str = "s3_xl", device=None):
    """The scripts' model: ``model`` in bf16 with the tiny T5 (vocab 512,
    ``d_model`` the model's context width, ``d_kv`` 64, ``d_ff`` twice
    ``d_model``, 2 layers, 8 heads), seeded random weights."""
    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig

    d = get_model_config(model).model.context_dim
    t5 = T5EncoderConfig(vocab_size=512, d_model=d, d_kv=64, d_ff=2 * d, num_layers=2,
                         num_heads=8)
    return EzAudio(model_name=model, t5_config=t5, dtype=torch.bfloat16, device=device)


def recipe_kwargs(recipe: str, steps: Optional[int] = None) -> dict:
    kw = dict(RECIPES[recipe])
    if steps is not None:
        kw["ddim_steps"] = steps
    return kw


def warm(ez, server, lengths, kw: dict) -> int:
    """One call per batch bucket x length bucket, with the per-slot starting
    noise the server passes (a fused program keys on drawn against given
    noise), so the window never pays a capture.  Returns the calls."""
    calls = 0
    for b in server.buckets:
        for L in lengths:
            lat = torch.stack([server._slot_noise(i, L) for i in range(b)])
            ez.generate_audio([PROMPTS[i % len(PROMPTS)] for i in range(b)], random_seed=0,
                              length=L, guidance_scale=5.0, guidance_rescale=0.75,
                              initial_latents=lat, **kw)
            calls += 1
    return calls


def load_point(server, rps: float, window: float, lengths, mixed: bool, rng, tag: str) -> dict:
    """Poisson arrivals at ``rps`` for ``window`` seconds, then every
    request awaited; the row the script prints, as a dict."""
    lat = {L: [] for L in lengths}
    by_order = {}  # request index -> latency
    lock = threading.Lock()
    done = threading.Semaphore(0)

    def finished(fut, t0, L, n):
        with lock:
            by_order[n] = time.perf_counter() - t0
            lat[L].append(by_order[n])
        done.release()

    server.stats.update(batches=0, padded_slots=0)
    futures, n_sent, audio_s = [], 0, 0.0
    t_end = time.perf_counter() + window
    while time.perf_counter() < t_end:
        time.sleep(rng.exponential(1.0 / rps))
        t0 = time.perf_counter()
        L = lengths[n_sent % len(lengths)] if mixed else lengths[0]
        f = server.submit(PROMPTS[n_sent % len(PROMPTS)], seed=n_sent, length=L)
        f.add_done_callback(lambda fut, t0=t0, L=L, n=n_sent: finished(fut, t0, L, n))
        futures.append(f)
        n_sent += 1
        audio_s += L
    for f in futures:
        f.result(timeout=RESULT_TIMEOUT_S)  # a request that failed raises here
    for _ in futures:  # the callbacks run after result() returns
        if not done.acquire(timeout=RESULT_TIMEOUT_S):
            raise TimeoutError("a finished request's callback did not run")
    all_lat = np.array(sorted(v for vs in lat.values() for v in vs))
    served = len(all_lat)
    pad = server.stats["padded_slots"]
    # the latency trend over the window: a server past saturation queues,
    # and its last third of requests waits longer than its first
    ordered = [by_order[n] for n in sorted(by_order)]
    third = max(1, served // 3)
    row = dict(recipe=tag, mixed=mixed, offered_rps=rps, window_s=window, sent=n_sent,
               served=served, req_per_s=served / window, audio_s_per_s=audio_s / window,
               p50_s=float(np.percentile(all_lat, 50)), p99_s=float(np.percentile(all_lat, 99)),
               per_length={L: dict(p50_s=float(np.percentile(v, 50)),
                                   p99_s=float(np.percentile(v, 99)), n=len(v))
                           for L, v in sorted(lat.items()) if v},
               batches=server.stats["batches"], padded_slots=pad,
               slot_fill=served / max(1, served + pad),
               p50_first_third_s=float(np.median(ordered[:third])),
               p50_last_third_s=float(np.median(ordered[-third:])))
    per_len = "  ".join(f"{L:.0f}s: p50 {s['p50_s']:.2f}s p99 {s['p99_s']:.2f}s (n={s['n']})"
                        for L, s in row["per_length"].items())
    print(f"[{tag}{'/mixed' if mixed else ''}] offered {rps:.2f} req/s: served {served} in "
          f"{window:.0f}s ({row['req_per_s']:.2f} req/s = {row['audio_s_per_s']:.1f} "
          f"audio-s/s), p50 {row['p50_s']:.2f}s p99 {row['p99_s']:.2f}s | {per_len} | "
          f"{row['batches']} batches, slot-fill {row['slot_fill']:.0%} | p50 first/last third "
          f"{row['p50_first_third_s']:.2f}/{row['p50_last_third_s']:.2f}s", flush=True)
    return row


def run_variant(ez, kw: dict, rates, window: float, max_batch: int, mixed: bool, lengths,
                tag: str) -> list:
    from ezaudio_tpu_torch.serving import GenerationServer

    server = GenerationServer(ez, max_batch_size=max_batch, max_wait_ms=200.0,
                              length=max(lengths), length_buckets=lengths, **kw)
    with server:
        print(f"warming batch buckets {server.buckets} x lengths {list(lengths)} "
              f"({tag} recipe)...", flush=True)
        t0 = time.perf_counter()
        calls = warm(ez, server, lengths, kw)
        print(f"warmed {calls} buckets in {time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.default_rng(0)
        return [load_point(server, rps, window, lengths, mixed, rng, tag) for rps in rates]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m ezaudio_tpu_torch.validation.serving_bench",
        description="Each flag is the JAX script's SERVE_* knob of the same name.")
    p.add_argument("rates", nargs="*", type=float, default=[0.5, 1.0, 2.0],
                   help="offered loads, requests per second")
    p.add_argument("--recipe", choices=sorted(RECIPES), default="fast")
    p.add_argument("--seconds", type=float, default=60.0, help="the window of each rate")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--mixed", action="store_true", help="half-length and full-length requests")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--fused", action="store_true", help="one CUDA graph per bucket")
    mode.add_argument("--ab", action="store_true", help="staged, then fused, in one process")
    p.add_argument("--steps", type=int, default=None, help="the recipe's steps (25 or 100)")
    p.add_argument("--length", type=float, default=10.0, help="a full-length request, s")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if not a.rates or min(a.rates) <= 0:
        p.error("every rate must be positive")
    return a


def main(argv=None, *, ez=None) -> list:
    """Run every variant at every rate; ``ez`` replaces the scripts' model
    (tests pass a tiny one).  Returns the rows, one per variant and rate."""
    a = parse_args(argv)
    if ez is None:
        ez = build_ezaudio("s3_xl", resolve_device(a.device))
    print(precision_line(ez.device, ez.dtype), flush=True)
    lengths = (a.length / 2, a.length) if a.mixed else (a.length,)
    variants = [False, True] if a.ab else [a.fused]
    rows = []
    for fused in variants:
        kw = dict(recipe_kwargs(a.recipe, a.steps), fused=fused)
        rows += run_variant(ez, kw, a.rates, a.seconds, a.max_batch, a.mixed, lengths,
                            f"{a.recipe}{'/fused' if fused else ''}")
    return rows


if __name__ == "__main__":
    main()
