"""Audio losses and quality metrics (counterpart of
``ezaudio_tpu/audio/metrics.py``; the reference's audiotools/metrics/):

  * ``multiscale_stft_loss`` — MultiScaleSTFTLoss (spectral.py:11-95): over
    the window lengths, the L1 of log10 clamped magnitudes^pow plus the L1
    of magnitudes;
  * ``mel_spectrogram_loss`` — MelSpectrogramLoss (spectral.py:98-193), the
    same on mel spectrograms at several scales;
  * ``si_sdr`` — SISDRLoss (distance.py:45-126), without its sign flip;
  * ``l1_loss`` — waveform L1;
  * ``stft_phase_loss`` — PhaseLoss (spectral.py:195-239).

These take (B, T) tensors, run on their device and are differentiable.
The Fréchet distance and the classifier statistics (paired KL, Inception
Score) run on the host with numpy and scipy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ezaudio_tpu_torch.audio.stft import mel_spectrogram, stft


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def si_sdr(estimate, reference, scaling: bool = True, zero_mean: bool = True,
           reduce: bool = True):
    """Scale-invariant SDR in dB (higher is better)."""
    eps = 1e-8
    if zero_mean:
        estimate = estimate - estimate.mean(-1, keepdim=True)
        reference = reference - reference.mean(-1, keepdim=True)
    if scaling:
        alpha = ((estimate * reference).sum(-1, keepdim=True) + eps) / (
            reference.square().sum(-1, keepdim=True) + eps)
    else:
        alpha = 1.0
    e_true = alpha * reference
    e_res = estimate - e_true
    sdr = 10 * torch.log10((e_true.square().sum(-1) + eps) / (e_res.square().sum(-1) + eps))
    return sdr.mean() if reduce else sdr


def _log_l1(mx, my, clamp_eps, pow):
    return (mx.clamp_min(clamp_eps).pow(pow).log10()
            - my.clamp_min(clamp_eps).pow(pow).log10()).abs().mean()


def multiscale_stft_loss(pred, target, window_lengths: Sequence[int] = (2048, 512),
                         clamp_eps: float = 1e-5, mag_weight: float = 1.0,
                         log_weight: float = 1.0, pow: float = 2.0):
    """audiotools' defaults: windows 2048/512, hop = window / 4."""
    loss = 0.0
    for w in window_lengths:
        mx, my = stft(pred, w, w // 4).abs(), stft(target, w, w // 4).abs()
        loss = loss + log_weight * _log_l1(mx, my, clamp_eps, pow)
        loss = loss + mag_weight * (mx - my).abs().mean()
    return loss


def mel_spectrogram_loss(pred, target, sr: int = 24000, n_mels: Sequence[int] = (150, 80),
                         window_lengths: Sequence[int] = (2048, 512), clamp_eps: float = 1e-5,
                         mag_weight: float = 1.0, log_weight: float = 1.0, pow: float = 2.0,
                         fmin: Sequence[float] = (0.0, 0.0),
                         fmax: Optional[Sequence[Optional[float]]] = None):
    """Multi-scale mel loss (audiotools spectral.py:98-193 defaults)."""
    fmax = fmax or [None] * len(n_mels)
    if len(fmin) != len(n_mels):
        if len(fmin) == 1:  # one value for every scale
            fmin = tuple(fmin) * len(n_mels)
        elif tuple(fmin) == (0.0, 0.0):  # the untouched default
            fmin = (0.0,) * len(n_mels)
    if len({len(n_mels), len(window_lengths), len(fmin), len(fmax)}) != 1:
        raise ValueError(
            f"scale lists must align: n_mels {len(n_mels)}, windows "
            f"{len(window_lengths)}, fmin {len(fmin)}, fmax {len(fmax)}")
    loss = 0.0
    for nm, w, lo, hi in zip(n_mels, window_lengths, fmin, fmax):
        mx = mel_spectrogram(pred, sr, w, w // 4, nm, lo, hi)
        my = mel_spectrogram(target, sr, w, w // 4, nm, lo, hi)
        loss = loss + log_weight * _log_l1(mx, my, clamp_eps, pow)
        loss = loss + mag_weight * (mx - my).abs().mean()
    return loss


def stft_phase_loss(pred, target, window_lengths: Sequence[int] = (2048, 512),
                    weight: float = 1.0):
    """Phase distance (wrapped to [-pi, pi)) weighted by the reference's
    magnitude."""
    loss = 0.0
    for w in window_lengths:
        sx, sy = stft(pred, w, w // 4), stft(target, w, w // 4)
        d = torch.remainder(sx.angle() - sy.angle() + math.pi, 2 * math.pi) - math.pi
        mag = sy.abs()
        loss = loss + weight * (mag * d ** 2).mean() / mag.mean().clamp_min(1e-8)
    return loss


def mel_statistics_embedding(wavs, sr: int, n_mels: int = 64, n_fft: int = 1024):
    """A light per-clip embedding: the log-mel mean, std and mean |delta|
    per band -> (N, 3 * n_mels).  Not VGGish: a proxy for FAD-style
    regression tracking without external weights."""
    m = mel_spectrogram(torch.as_tensor(wavs), sr, n_fft, n_fft // 4, n_mels)
    logm = m.clamp_min(1e-5).log()
    return torch.cat([logm.mean(-1), logm.std(-1, unbiased=False),
                      logm.diff(dim=-1).abs().mean(-1)], dim=-1)


# ---------------------------------------------------------------------------
# Host statistics (numpy / scipy)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """Fréchet distance between two Gaussians (the FAD statistic, Kilgour et
    al., arXiv 1812.08466)."""
    from scipy import linalg  # scipy 1.18 took sqrtm's ``disp``: the root alone

    mu1, mu2, cov1, cov2 = (_np(a) for a in (mu1, mu2, cov1, cov2))
    diff = mu1 - mu2
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        # rank-deficient covariances (fewer clips than dimensions): the
        # eps * I offset of the reference FID/FAD implementations
        off = np.eye(cov1.shape[0]) * 1e-6
        covmean = linalg.sqrtm((cov1 + off) @ (cov2 + off))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def _gaussian_stats(emb):
    emb = _np(emb).astype(np.float64)
    return emb.mean(axis=0), np.atleast_2d(np.cov(emb, rowvar=False))


def frechet_audio_distance(emb_eval, emb_ref) -> float:
    """FAD over two sets of per-clip embeddings (N, D)."""
    mu1, cov1 = _gaussian_stats(emb_eval)
    mu2, cov2 = _gaussian_stats(emb_ref)
    return frechet_distance(mu1, cov1, mu2, cov2)


def paired_kl_divergence(logits_eval, logits_ref, kind: str = "softmax") -> float:
    """The mean paired KL(p_ref || p_gen) of classifier logits (the "KL"
    column of the EzAudio paper; audioldm_eval's convention): ``softmax``
    reads each row as one distribution, ``sigmoid`` as per-class
    Bernoullis."""
    le, lr = _np(logits_eval).astype(np.float64), _np(logits_ref).astype(np.float64)
    if le.shape != lr.shape:
        raise ValueError(f"paired metric needs matching shapes, got {le.shape} vs {lr.shape}")
    if kind == "softmax":
        def logsm(x):
            x = x - x.max(axis=-1, keepdims=True)
            return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

        kl = (np.exp(logsm(lr)) * (logsm(lr) - logsm(le))).sum(axis=-1)
    elif kind == "sigmoid":
        def sig(x):
            return 1.0 / (1.0 + np.exp(-x))

        pr, pe = sig(lr).clip(1e-7, 1 - 1e-7), sig(le).clip(1e-7, 1 - 1e-7)
        kl = (pr * np.log(pr / pe) + (1 - pr) * np.log((1 - pr) / (1 - pe))).sum(axis=-1)
    else:
        raise ValueError(f"kind must be softmax|sigmoid, got {kind!r}")
    return float(kl.mean())


def inception_score(probs, splits: int = 10) -> float:
    """Inception Score of per-clip class probabilities (N, C), averaged over
    ``splits`` chunks (Salimans et al., arXiv 1606.03498)."""
    p = _np(probs).astype(np.float64).clip(1e-7, None)
    p = p / p.sum(axis=-1, keepdims=True)
    splits = max(1, min(splits, p.shape[0]))
    scores = []
    for part in np.array_split(p, splits):
        marginal = part.mean(axis=0, keepdims=True)
        scores.append(np.exp((part * (np.log(part) - np.log(marginal))).sum(axis=-1).mean()))
    return float(np.mean(scores))
