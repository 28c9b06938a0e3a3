"""Fit the native NSIM -> MOS mapping to the published MNRU characteristic
(counterpart of ``scripts/calibrate_nsim_mnru.py``).

ViSQOL's exact NSIM -> MOS mapping is a trained SVR shipped only inside
Google's binary, so bit-exact parity is out of reach.  What the ViSQOL
papers give is its shape, a saturating sigmoid from the NSIM axis onto the
MOS scale, and the metric family's behaviour on standard degradations.  The
anchor is the PESQ calibration's (``calibrate_pesq_mnru.anchor_mos``): MNRU
(ITU-T P.810) speech-correlated noise has a published, about linear
subjective-MOS-against-Q law over Q in [10, 35].

This measures ``audio/quality.py::visqol_nsim`` on MNRU-degraded synthetic
speech over a Q grid, fits the logistic

    MOS(nsim) = 1 + span / (1 + exp(-k (nsim - c)))

to the anchor by least squares (scipy), identity pinned at 4.55, and prints
the fit beside the baked-in ``NSIM_MOS_CAL`` with its residual table
("MNRU-anchored, not Google-SVR-exact"; the mapping is monotone, so every
order-level conformance row is unchanged).  Host numpy, as JAX's.

    python -m ezaudio_tpu_torch.validation.calibrate_nsim_mnru [--qs 10,15,...] [--n-refs 4]
        [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ezaudio_tpu_torch.audio import quality as Q
from ezaudio_tpu_torch.audio.effects import mnru
from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation.calibrate_pesq_mnru import BOUND, FS, anchor_mos, parse_args

IDENTITY_MOS = 4.55  # nsim 1.0 (transparent) pins the top of the scale


def logistic(x, span, k, c):
    return 1.0 + span / (1.0 + np.exp(-k * (x - c)))


def main(argv=None) -> dict:
    """Fit and print; returns ``{"cal": (span, k, c), "rows": [(Q, anchor,
    mean nsim, calibrated, residual)], "identity": float, "worst": float}``."""
    from scipy.optimize import curve_fit

    a = parse_args(argv, prog="calibrate_nsim_mnru")
    resolve_device(a.device)
    refs = [Q.synthetic_speech(4.0, FS, seed=s) for s in range(a.n_refs)]
    xs, ys, per_q = [], [], {}
    for q in a.qs:
        per_q[q] = [Q.visqol_nsim(mnru(r, q, seed=100 + i), r, FS)["nsim"]
                    for i, r in enumerate(refs)]
        xs += per_q[q]
        ys += [anchor_mos(q)] * len(per_q[q])
    xs += [1.0] * a.n_refs
    ys += [IDENTITY_MOS] * a.n_refs
    xs, ys = np.array(xs), np.array(ys)

    (span, k, c), _ = curve_fit(logistic, xs, ys, p0=(3.6, 25.0, 0.88), maxfev=20000)
    print(f"fitted NSIM_MOS_CAL = ({span:.4f}, {k:.4f}, {c:.4f})   "
          f"[baked in: {getattr(Q, 'NSIM_MOS_CAL', None)}]")

    print("\n| Q (dB) | anchor MOS | mean nsim | calibrated mos | residual |")
    print("|---|---|---|---|---|")
    table, worst = [], 0.0
    for q in a.qs:
        m = float(np.mean([logistic(v, span, k, c) for v in per_q[q]]))
        res = m - anchor_mos(q)
        worst = max(worst, abs(res))
        table.append((q, anchor_mos(q), float(np.mean(per_q[q])), m, res))
        print(f"| {q} | {anchor_mos(q):.2f} | {np.mean(per_q[q]):.4f} | {m:.2f} | {res:+.2f} |")
    ident = float(logistic(1.0, span, k, c))
    print(f"| identity | 4.5+ | 1.0000 | {ident:.2f} | {ident - IDENTITY_MOS:+.2f} |")
    print(f"\nworst MNRU residual: {worst:.3f} MOS (documented bound: {BOUND})")
    return {"cal": (float(span), float(k), float(c)), "rows": table, "identity": ident,
            "worst": worst}


if __name__ == "__main__":
    main()
