"""Intrusive speech/audio quality metrics (the port's copy of
``ezaudio_tpu/audio/quality.py``, numpy only).

Equivalent of reference ``audiotools/metrics/quality.py``:
  * ``stoi`` — a native implementation of the Short-Time Objective
    Intelligibility measure (Taal et al. 2010): 1/3-octave band envelope
    correlation over 384 ms analysis windows with clipping;
  * ``pesq`` — a native implementation of the ITU-T P.862 structure
    (level align, time align, Bark-band loudness, asymmetric disturbance
    aggregation → MOS map) defined below; order-conformant on standard
    degradations AND score-level anchored to the published P.862 MNRU
    characteristic via ``PESQ_CAL`` (fit residual ≤0.18 MOS, held-out
    family means within ±0.35 MOS — tests/test_quality_conformance.py,
    scripts/calibrate_pesq_mnru.py);
  * ``nsim`` — the ViSQOL neurogram-similarity core, likewise native;
  * ``visqol`` — the exact Google MOS mapping requires the external
    scorer (not distributed here) and raises with a clear gating message.
"""

from __future__ import annotations

import numpy as np


def _thirdoct(fs: int, n_fft: int, num_bands: int, min_freq: float):
    """1/3-octave band matrix (STOI reference construction)."""
    f = np.linspace(0, fs, n_fft + 1)[: n_fft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        li = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, li:hi_i] = 1.0
    return obm, cf


def _stft_frames(x: np.ndarray, win: int, hop: int, n_fft: int):
    w = np.hanning(win + 2)[1:-1]
    n = 1 + (len(x) - win) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None]
    return np.fft.rfft(x[idx] * w, n=n_fft, axis=-1)


def stoi(estimate: np.ndarray, reference: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """STOI in [~-1, 1]; inputs are 1-D waveforms at any rate (resampled to
    10 kHz internally, as the metric specifies).  ``extended=True``
    computes ESTOI (Jensen & Taal 2016: row/column-normalized segment
    inner products, no clipping)."""
    from ezaudio_tpu_torch.data.audio_io import resample

    FS = 10000
    x = resample(np.asarray(reference, np.float32), fs, FS)
    y = resample(np.asarray(estimate, np.float32), fs, FS)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]

    N_FRAME, N_FFT, NUM_BANDS, MIN_FREQ = 256, 512, 15, 150.0
    N = 30  # analysis length in frames (384 ms)
    BETA = -15.0

    # remove silent frames (40 dB below the loudest reference frame)
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    nf = 1 + (n - N_FRAME) // hop
    if nf < N + 1:
        return float("nan")
    idx = np.arange(nf)[:, None] * hop + np.arange(N_FRAME)[None]
    energies = 20 * np.log10(np.linalg.norm(x[idx] * w, axis=1) + 1e-12)
    keep = energies > energies.max() - 40.0
    frames_x = (x[idx] * w)[keep]
    frames_y = (y[idx] * w)[keep]
    if len(frames_x) < N:
        return float("nan")

    X = np.abs(np.fft.rfft(frames_x, n=N_FFT, axis=-1))
    Y = np.abs(np.fft.rfft(frames_y, n=N_FFT, axis=-1))
    obm, _ = _thirdoct(FS, N_FFT, NUM_BANDS, MIN_FREQ)
    Xb = np.sqrt(obm @ (X.T**2)).T  # (frames, bands)
    Yb = np.sqrt(obm @ (Y.T**2)).T

    def _rc_norm(s):
        # ESTOI row/column normalization (Jensen & Taal 2016): each band's
        # time-vector to zero-mean unit-norm, then each frame's
        # band-vector likewise
        s = s - s.mean(0, keepdims=True)
        s = s / (np.linalg.norm(s, axis=0, keepdims=True) + 1e-12)
        s = s - s.mean(1, keepdims=True)
        s = s / (np.linalg.norm(s, axis=1, keepdims=True) + 1e-12)
        return s

    d = []
    for m in range(N, len(Xb) + 1):
        seg_x = Xb[m - N : m]  # (N, bands)
        seg_y = Yb[m - N : m]
        if extended:
            # ESTOI: no clipping/scaling; inner product of the doubly
            # normalized segments averaged over frames
            d.append(float(np.sum(_rc_norm(seg_x) * _rc_norm(seg_y)) / N))
            continue
        alpha = np.sqrt((seg_x**2).sum(0) / ((seg_y**2).sum(0) + 1e-12))
        y_scaled = seg_y * alpha[None]
        y_clip = np.minimum(y_scaled, seg_x * (1 + 10 ** (-BETA / 20)))
        xm = seg_x - seg_x.mean(0, keepdims=True)
        ym = y_clip - y_clip.mean(0, keepdims=True)
        corr = (xm * ym).sum(0) / (
            np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12)
        d.append(corr.mean())
    return float(np.mean(d))


# ---------------------------------------------------------------------------
# PESQ (ITU-T P.862) — native numpy implementation
# ---------------------------------------------------------------------------

def _bark_scale(f_hz):
    """Traunmüller/Zwicker analytic Bark scale."""
    f = np.asarray(f_hz, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _abs_threshold_db(f_hz):
    """ISO 226-style analytic absolute hearing threshold (dB SPL)."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


def synthetic_speech(duration_s: float = 4.0, fs: int = 8000,
                     seed: int = 0) -> np.ndarray:
    """Deterministic speech-like test signal for metric calibration:
    pitch-modulated pulse-train excitation through a slowly-varying
    two-formant resonator, with syllabic amplitude modulation and pauses
    (P.862 operates on speech; no speech corpus ships with the project).
    This is THE calibration signal family for PESQ_CAL below — the
    score-level conformance rows (tests/test_quality_conformance.py) and
    scripts/calibrate_pesq_mnru.py must use the same family, degraded by
    ezaudio_tpu_torch.audio.effects.mnru (ITU-T P.810)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * fs)
    t = np.arange(n) / fs
    # glottal excitation: F0 drifts 90-160 Hz
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.31 * t + rng.uniform(0, 6))
    phase = np.cumsum(f0) / fs
    exc = ((phase % 1.0) < 0.1).astype(np.float64)  # pulse train
    exc += 0.02 * rng.standard_normal(n)  # aspiration
    # two formants wandering over vowel space
    out = np.zeros(n)
    seg = int(0.25 * fs)
    b1 = np.zeros(2)
    b2 = np.zeros(2)
    for s in range(0, n, seg):
        F1 = rng.uniform(300, 800)
        F2 = rng.uniform(900, 2200)
        e = exc[s : s + seg]
        y = e
        for F, bw, state in ((F1, 80.0, b1), (F2, 120.0, b2)):
            r = np.exp(-np.pi * bw / fs)
            a1 = 2 * r * np.cos(2 * np.pi * F / fs)
            a2 = -r * r
            z = np.empty_like(y)
            p1, p2 = state
            for i in range(len(y)):
                v = y[i] + a1 * p1 + a2 * p2
                z[i] = v
                p2, p1 = p1, v
            state[0], state[1] = p1, p2
            y = z
        out[s : s + seg] = y
    # syllabic envelope (~4 Hz) with pauses
    env = np.clip(np.sin(2 * np.pi * 3.7 * t + 1.0), 0.0, None) ** 0.5
    env *= (np.sin(2 * np.pi * 0.43 * t) > -0.7)  # occasional silence
    out = out * env
    return (0.3 * out / (np.abs(out).max() + 1e-12)).astype(np.float64)


def _pesq_frames(x, n_frame):
    hop = n_frame // 2
    n = 1 + max(0, (len(x) - n_frame)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_frame)[None]
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_frame) / n_frame))
    return np.abs(np.fft.rfft(x[idx] * w, axis=-1)) ** 2


def _align(ref, deg):
    """Whole-file crude alignment by envelope cross-correlation (the
    P.862 utterance-splitting fine alignment is omitted — generated audio
    has a single global offset at most)."""
    n = 1 << int(np.ceil(np.log2(len(ref) + len(deg))))
    env_r = np.abs(ref)
    env_d = np.abs(deg)
    R = np.fft.rfft(env_r, n)
    D = np.fft.rfft(env_d, n)
    xc = np.fft.irfft(D * np.conj(R), n)
    lag = int(np.argmax(np.concatenate([xc[-len(ref):], xc[: len(deg)]])))
    lag -= len(ref)
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        ref = ref[-lag:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


def pesq(estimate: np.ndarray, reference: np.ndarray, fs: int,
         mode: str = "nb", _components: bool = False) -> float:
    """Perceptual speech quality following the ITU-T P.862 algorithm
    structure, in pure numpy.

    Stages (P.862 §10): level alignment to a fixed band power, IRS-like
    band-pass, envelope time alignment, 32 ms Hann-frame power spectra,
    Bark-band grouping with frequency compensation, Zwicker loudness
    (exponent 0.23), center-clipped disturbance with asymmetry weighting
    (ratio^1.2, clamp 12), L3 band / L6 syllable / L2 time aggregation and
    the published MOS map ``4.5 - 0.1 d_s - 0.0309 d_a``.

    The standard's 42-band tabulated constants are replaced by analytic
    Bark-scale / absolute-threshold forms (documented in psychoacoustics
    literature), so scores CORRELATE with but are not bit-identical to the
    ITU reference implementation; identical signals score 4.5 and the
    metric is monotone in SNR (see tests/test_quality_report.py).

    Reference gating note: ``audiotools/metrics/quality.py:64`` shells out
    to the external ``pesq`` package; this is the native equivalent.
    """
    from ezaudio_tpu_torch.data.audio_io import resample

    FS = 8000 if mode == "nb" else 16000
    ref = resample(np.asarray(reference, np.float64).ravel(), fs, FS)
    deg = resample(np.asarray(estimate, np.float64).ravel(), fs, FS)

    # --- level alignment: fixed power in the 325-3250 Hz band ---
    def band_power(x):
        spec = np.abs(np.fft.rfft(x)) ** 2
        f = np.fft.rfftfreq(len(x), 1.0 / FS)
        m = (f >= 325) & (f <= 3250)
        return spec[m].sum() / len(x) ** 2 * 2

    TARGET = 1e-2
    ref = ref * np.sqrt(TARGET / max(band_power(ref), 1e-20))
    deg = deg * np.sqrt(TARGET / max(band_power(deg), 1e-20))

    # --- IRS-like receive filter: telephone band emphasis ---
    def irs(x):
        spec = np.fft.rfft(x)
        f = np.fft.rfftfreq(len(x), 1.0 / FS)
        gain = np.ones_like(f)
        gain[f < 200] = (np.maximum(f[f < 200], 50) / 200.0) ** 2
        gain[f > 3600] = np.exp(-((f[f > 3600] - 3600) / 600.0))
        return np.fft.irfft(spec * gain, len(x))

    if mode == "nb":
        ref, deg = irs(ref), irs(deg)

    ref, deg = _align(ref, deg)
    if len(ref) < FS // 4:
        return float("nan")

    # --- perceptual model ---
    N_FRAME = 256 if mode == "nb" else 512  # 32 ms
    P_ref = _pesq_frames(ref, N_FRAME)  # (frames, bins) power
    P_deg = _pesq_frames(deg, N_FRAME)
    n_bins = P_ref.shape[1]
    f = np.linspace(0, FS / 2, n_bins)

    # Bark bands: uniform 0.5-Bark grid over the audible band
    z = _bark_scale(f)
    n_bands = int(np.floor(z[-1] / 0.5))
    edges = np.arange(n_bands + 1) * 0.5
    band_of = np.clip(np.digitize(z, edges) - 1, 0, n_bands - 1)
    B = np.zeros((n_bands, n_bins))
    B[band_of, np.arange(n_bins)] = 1.0
    width = np.maximum(B.sum(1), 1.0)

    bark_ref = (P_ref @ B.T) / width  # mean power per band
    bark_deg = (P_deg @ B.T) / width

    # silent-frame exclusion: 45 dB below loudest reference frame
    fe = 10 * np.log10(bark_ref.sum(1) + 1e-20)
    active = fe > fe.max() - 45.0
    if active.sum() < 4:
        return float("nan")
    bark_ref, bark_deg = bark_ref[active], bark_deg[active]

    # frequency compensation: per-band ratio of mean spectra (clamped
    # +-20 dB), applied to the degraded signal (P.862 partial gain comp.)
    mr = bark_ref.mean(0)
    md = bark_deg.mean(0)
    comp = np.clip(mr / np.maximum(md, 1e-20), 1e-2, 1e2)
    bark_deg = bark_deg * comp[None, :]

    # hearing threshold per band (intensity units)
    fc = np.array([f[band_of == b].mean() if (band_of == b).any() else f[-1]
                   for b in range(n_bands)])
    thr_db = _abs_threshold_db(fc)
    P0 = 10 ** (thr_db / 10.0) * 1e-10  # threshold intensity, calibrated
    P0 = np.maximum(P0, 1e-12)

    # Zwicker loudness
    def loud(p):
        sl = (P0 / 0.5) ** 0.23
        return sl * ((0.5 + 0.5 * p / P0) ** 0.23 - 1.0) * 32.0

    L_ref = loud(bark_ref)
    L_deg = loud(bark_deg)

    # center-clipped disturbance (deadzone 0.25*min loudness)
    dead = 0.25 * np.minimum(L_ref, L_deg)
    d = np.abs(L_deg - L_ref)
    d = np.maximum(d - dead, 0.0)

    # asymmetry factor: additive components weighted up
    ratio = (bark_deg + 50.0 * P0) / (bark_ref + 50.0 * P0)
    asym = np.clip(ratio ** 1.2, 0.0, 12.0)
    asym[asym < 3.0] = 0.0
    d_asym = d * asym

    # aggregation: L3 over bands -> L6 over ~320 ms -> L2 over time
    def agg(dm, p_band, p_time1=6.0):
        per_frame = (dm ** p_band).mean(1) ** (1.0 / p_band)
        n_syl = max(1, len(per_frame) // 10)
        chunks = np.array_split(per_frame, n_syl)
        syl = np.array([(np.mean(c ** p_time1)) ** (1 / p_time1)
                        for c in chunks])
        return float(np.sqrt((syl ** 2).mean()))

    d_s = agg(d, 3.0)
    d_a = agg(d_asym, 1.0)

    drop = 0.1 * d_s + 0.0309 * d_a  # the published inner weights
    raw = 4.5 - PESQ_CAL[0] * drop ** PESQ_CAL[1]
    if _components:
        return float(np.clip(raw, -0.5, 4.5)), float(d_s), float(d_a)
    return float(np.clip(raw, -0.5, 4.5))


# MNRU score-level calibration.  P.862's published MOS
# map (4.5 - 0.1 d_s - 0.0309 d_a) assumes the ITU 42-band tabulated
# perceptual model; ours uses analytic Bark/threshold forms, so the raw
# combined disturbance sits on a compressed scale.  (alpha, beta) below
# recalibrate the published drop by a power law, fitted in
# scripts/calibrate_pesq_mnru.py so that MNRU-degraded synthetic speech
# (ITU-T P.810, mnru() above) reproduces the published approximately-
# linear P.862 MNRU characteristic — slope ~0.1 MOS/dB crossing ~2.9 at
# Q=25 dB over Q in [10, 35] (reconstructed from the P.862 literature;
# the exact ITU conformance tables are not distributable and absent from
# the repository).  Fit residual: worst 0.18 MOS over Q in {10..35};
# documented tolerance +-0.35 MOS.  Score-level conformance rows:
# tests/test_quality_conformance.py.  Monotone transform: all order-level
# conformance properties are unchanged.
PESQ_CAL = (2.3227, 0.9571)


# ---------------------------------------------------------------------------
# NSIM — the ViSQOL similarity core (Hines et al.), native numpy
# ---------------------------------------------------------------------------

def _erb_bandwidth(fc):
    return 24.7 * (4.37 * fc / 1000.0 + 1.0)


def _gammatone_bands(fs: int, n_fft: int, bands: int, fmin: float = 50.0):
    """Analytic 4th-order gammatone magnitude responses on the FFT grid,
    center frequencies ERB-spaced in [fmin, 0.45*fs]."""
    fmax = 0.45 * fs
    # ERB-number scale (Glasberg & Moore)
    def hz_to_erbn(f):
        return 21.4 * np.log10(1.0 + 0.00437 * f)

    def erbn_to_hz(e):
        return (10.0 ** (e / 21.4) - 1.0) / 0.00437

    cf = erbn_to_hz(np.linspace(hz_to_erbn(fmin), hz_to_erbn(fmax), bands))
    f = np.linspace(0, fs / 2, n_fft // 2 + 1)
    b = 1.019 * _erb_bandwidth(cf)
    # |H(f)|^2 for a 4th-order gammatone ~ (1 + ((f-fc)/b)^2)^-4
    H = (1.0 + ((f[None, :] - cf[:, None]) / b[:, None]) ** 2) ** -4.0
    return H, cf


def visqol_nsim(estimate: np.ndarray, reference: np.ndarray, fs: int,
                bands: int = 32, win_s: float = 0.08, hop_s: float = 0.02
                ) -> dict:
    """Neurogram Similarity Index Measure — the similarity core of ViSQOL
    (audiotools/metrics/quality.py:100 shells out to Google's binary; the
    full tool additionally runs patch alignment and an SVR NSIM->MOS model
    whose trained weights only ship with that binary).

    Computes gammatone log-spectrograms of reference and degraded signals
    and the SSIM-style NSIM over them (luminance x structure with local
    moments along time).  Returns ``{"nsim": ..., "mos": ...}`` where
    ``mos`` maps nsim onto the subjective scale via ``NSIM_MOS_CAL`` — a
    logistic fitted to the published P.862/P.810 MNRU characteristic
    (scripts/calibrate_nsim_mnru.py; worst fit residual 0.089 MOS,
    held-out family means within +-0.35 —
    tests/test_quality_conformance.py).  MNRU-anchored, NOT Google's
    trained SVR (which only ships in their binary); the mapping is
    monotone so rankings equal raw-``nsim`` rankings.
    """
    est = np.asarray(estimate, np.float64).reshape(-1)
    ref = np.asarray(reference, np.float64).reshape(-1)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]

    win = int(round(win_s * fs))
    hop = int(round(hop_s * fs))
    n_fft = int(2 ** np.ceil(np.log2(max(win, 2))))
    Xr = _stft_frames(ref, win, hop, n_fft)
    Xd = _stft_frames(est, win, hop, n_fft)
    H, _ = _gammatone_bands(fs, n_fft, bands)
    # neurograms (bands, frames): gammatone-weighted power -> dB, floored
    Nr = 10.0 * np.log10(H @ (np.abs(Xr) ** 2).T + 1e-12)
    Nd = 10.0 * np.log10(H @ (np.abs(Xd) ** 2).T + 1e-12)
    floor = Nr.max() - 70.0
    Nr = np.maximum(Nr, floor) - floor
    Nd = np.maximum(Nd, floor) - floor

    # local moments along time (3-frame window, per band)
    def box(x):
        k = 3
        if x.shape[1] <= 1:
            return x
        pad = np.pad(x, ((0, 0), (k // 2, k // 2)), mode="edge")
        # zero-prefixed cumsum so window i sums pad[i : i+k] (centered on
        # x[i]) and all x.shape[1] frames are kept
        c = np.cumsum(pad, axis=1)
        c = np.concatenate([np.zeros((x.shape[0], 1)), c], axis=1)
        return (c[:, k:] - c[:, :-k]) / k

    mu_r, mu_d = box(Nr), box(Nd)
    var_r = np.maximum(box(Nr * Nr) - mu_r ** 2, 0.0)
    var_d = np.maximum(box(Nd * Nd) - mu_d ** 2, 0.0)
    cov = box(Nr * Nd) - mu_r * mu_d

    L = 70.0  # dynamic range of the floored neurogram (dB)
    C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    lum = (2 * mu_r * mu_d + C1) / (mu_r ** 2 + mu_d ** 2 + C1)
    struct = (cov + C2 / 2) / (np.sqrt(var_r * var_d) + C2 / 2)
    # active-patch weighting: ViSQOL aligns and scores only patches with
    # reference energy; the equivalent here is an intensity-weighted mean,
    # so silent bands (noise-filled in the degraded signal) do not dominate
    w = np.maximum(mu_r, 0.0) + 1e-6
    nsim = float(np.sum(lum * struct * w) / np.sum(w))

    span, k, c = NSIM_MOS_CAL
    mos = float(np.clip(1.0 + span / (1.0 + np.exp(-k * (nsim - c))),
                        1.0, 5.0))
    return {"nsim": nsim, "mos": mos}


# MNRU score-level calibration for the NSIM->MOS map (the PESQ_CAL trick
# repeated for the ViSQOL core).  Google's exact
# NSIM->MOS SVR ships only inside their binary, so the mapping here is a
# 3-parameter logistic  MOS = 1 + span/(1 + exp(-k*(nsim - c)))  fitted in
# scripts/calibrate_nsim_mnru.py so that MNRU-degraded synthetic speech
# (ITU-T P.810) reproduces the same published ~0.1-MOS/dB / 2.9-at-Q=25
# characteristic the PESQ calibration targets, with identity pinned at the
# top of the scale.  Fit residual: worst 0.089 MOS over Q in {10..35};
# documented tolerance +-0.35 MOS (held-out seeds:
# tests/test_quality_conformance.py).  Monotone: order-level conformance
# rows are unchanged.  "MNRU-anchored, not Google-SVR-exact."
NSIM_MOS_CAL = (8.9222, 37.8489, 1.0107)


def visqol(*args, **kwargs):
    raise ImportError(
        "Exact ViSQOL scores require Google's visqol binary (its trained "
        "NSIM->MOS SVR model only ships there), which is not available "
        "here.  For a native similarity metric of the same "
        "family use ezaudio_tpu_torch.audio.quality.visqol_nsim.")
