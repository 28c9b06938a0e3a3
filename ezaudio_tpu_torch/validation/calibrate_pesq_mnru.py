"""Fit the native PESQ disturbance scales to the published MNRU
characteristic (counterpart of ``scripts/calibrate_pesq_mnru.py``).

Anchor: ITU-T P.862's score on MNRU-degraded speech (P.810 speech-correlated
noise at Q dB) is about linear over Q in [10, 35] (slope ~0.1 MOS/dB,
crossing ~2.9 at Q = 25), saturating toward 4.5 above Q ~ 45
(:func:`anchor_mos`; the ITU conformance tables are not distributable, hence
the documented +-0.35 MOS bound rather than a bit-exact claim).

The port's perceptual model (``audio/quality.py``) replaces the ITU 42-band
tables with analytic Bark/threshold forms, so its combined disturbance sits
on a compressed scale; this fits the power-law recalibration (alpha, beta) in

    MOS(Q) ~= 4.5 - alpha * (0.1 d_s(Q) + 0.0309 d_a(Q))^beta

by log-linear least squares over a grid of MNRU conditions on deterministic
synthetic speech, and prints the fit beside the baked-in ``PESQ_CAL`` with
its residual table.  The perceptual model is host numpy, as JAX's; re-run
after any change to it.

    python -m ezaudio_tpu_torch.validation.calibrate_pesq_mnru [--qs 10,15,...] [--n-refs 4]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ezaudio_tpu_torch.audio import quality as Q
from ezaudio_tpu_torch.audio.effects import mnru
from ezaudio_tpu_torch.utils import resolve_device

FS = 8000
QS = (10, 15, 20, 25, 30, 35)
N_REFS = 4
BOUND = 0.35  # the documented worst residual, MOS


def anchor_mos(q) -> float:
    """The published characteristic: 0.0985 Q + 0.463 on [10, 35] (1.45 at
    10, 2.92 at 25, 3.91 at 35)."""
    return float(np.clip(0.0985 * q + 0.463, 1.0, 4.5))


def parse_args(argv=None, prog="calibrate_pesq_mnru"):
    p = argparse.ArgumentParser(prog=f"python -m ezaudio_tpu_torch.validation.{prog}")
    p.add_argument("--qs", default=",".join(str(q) for q in QS),
                   help="the MNRU grid, comma-separated Q in dB")
    p.add_argument("--n-refs", type=int, default=N_REFS, help="synthetic speech references")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; the perceptual models run on the host")
    a = p.parse_args(argv)
    a.qs = tuple(float(q) if "." in q else int(q) for q in a.qs.split(","))
    return a


def main(argv=None) -> dict:
    """Fit and print; returns ``{"cal": (alpha, beta), "rows": [(Q, anchor,
    calibrated, residual)], "worst": float}``."""
    a = parse_args(argv)
    resolve_device(a.device)
    refs = [Q.synthetic_speech(4.0, FS, seed=s) for s in range(a.n_refs)]
    rows = []  # (q, combined raw drop): _components gives the raw d_s, d_a
    for q in a.qs:
        for i, r in enumerate(refs):
            _, d_s, d_a = Q.pesq(mnru(r, q, seed=100 + i), r, FS, _components=True)
            rows.append((q, 0.1 * d_s + 0.0309 * d_a))

    D = np.array([d for _, d in rows])
    need = np.array([4.5 - anchor_mos(q) for q, _ in rows])
    A = np.stack([np.ones_like(D), np.log(D)], 1)
    coef, *_ = np.linalg.lstsq(A, np.log(need), rcond=None)
    alpha, beta = float(np.exp(coef[0])), float(coef[1])
    print(f"fitted PESQ_CAL = ({alpha:.4f}, {beta:.4f})   [baked in: {Q.PESQ_CAL}]")

    print("\n| Q (dB) | anchor MOS | calibrated pesq | residual |")
    print("|---|---|---|---|")
    table, worst = [], 0.0
    for q in a.qs:
        mos = float(np.mean([4.5 - alpha * d ** beta for qq, d in rows if qq == q]))
        res = mos - anchor_mos(q)
        worst = max(worst, abs(res))
        table.append((q, anchor_mos(q), mos, res))
        print(f"| {q} | {anchor_mos(q):.2f} | {mos:.2f} | {res:+.2f} |")
    print(f"\nworst residual: {worst:.3f} MOS (documented bound: {BOUND})")
    return {"cal": (alpha, beta), "rows": table, "worst": worst}


if __name__ == "__main__":
    main()
