"""Validation-set rendering (counterpart of
``ezaudio_tpu/training/evaluate.py``; the reference ``eval_udit``,
src/inference.py:110-169): render the first ``val_num`` prompts of a CSV
split to wav files, or with ``mae`` reconstruct each clip under two random
spans of 20 % masked (editing evaluation).

The CSV is read with the stdlib ``csv`` module; the spans come from
Python's ``random.Random(random_seed)`` in the JAX package's order, so one
seed masks the same frames on both.  The encode and decode run kernel 2.
``codec_fidelity_report`` measures a codec round trip with
``audio/metrics.py``.
"""

from __future__ import annotations

import csv
import os
import random

import numpy as np
import torch

from ezaudio_tpu_torch.data.audio_io import load_wav, peak_normalize, save_wav
from ezaudio_tpu_torch.utils import scale_shift_re


def _rows(val_df: str, subset: str, mae: bool) -> list:
    with open(val_df, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["split"] == subset]
    if mae and rows and "audio_length" in rows[0]:
        from ezaudio_tpu_torch.data.dataset import _keep_length

        rows = [r for r in rows if _keep_length(r["audio_length"])]
    return rows


@torch.no_grad()
def eval_udit(ez, val_df: str, subset: str, audio_dir: str = "", mae: bool = False,
              guidance_scale: float = 3.0, guidance_rescale: float = 0.0,
              ddim_steps: int = 50, eta: float = 1.0, random_seed: int = 2023,
              epoch: int = 0, save_path: str = "logs/eval/", val_num: int = 5) -> list:
    """Render val prompts with ``ez`` (an ``EzAudio``); returns the wav
    paths written under ``<save_path>/<epoch>``."""
    rows = _rows(val_df, subset, mae)
    out_dir = os.path.join(save_path, str(epoch))
    os.makedirs(out_dir, exist_ok=True)
    rnd = random.Random(random_seed)
    written = []
    for i, row in enumerate(rows[:val_num]):
        text = str(row["caption"])
        if mae:
            gt = peak_normalize(load_wav(os.path.join(audio_dir, row["audio_path"]), sr=ez.sr))
            save_wav(os.path.join(out_dir, f"{i}_gt.wav"), gt, ez.sr)
            # two random spans of 20 % (reference inference.py:144-150)
            n = int(10 * ez.sr)
            gt = np.pad(gt, (0, max(0, n - len(gt))))[:n]
            mask_len = int(int(10 * ez.latent_sr) * 0.2)
            gen = torch.Generator(device=ez.device).manual_seed(int(random_seed))
            gt_latent = ez.autoencoder.encode(gt[None, :, None], generator=gen)
            gt_mask = np.zeros((1, gt_latent.shape[1], 1), bool)
            for _ in range(2):
                start = rnd.randint(0, gt_latent.shape[1] - mask_len)
                gt_mask[:, start: start + mask_len] = True
            latents = ez._generate_latents([text], gt_latent.shape[1], guidance_scale,
                                           guidance_rescale, ddim_steps, eta, random_seed,
                                           gt=gt_latent, gt_mask=gt_mask)
            pred = scale_shift_re(latents, ez.scale, ez.shift)
            pred = torch.where(torch.from_numpy(gt_mask).to(pred.device), pred, gt_latent)
            wav = ez.autoencoder.decode(pred)[0, :, 0].float().cpu().numpy()
        else:
            _, wav = ez.generate_audio(text, length=10, guidance_scale=guidance_scale,
                                       guidance_rescale=guidance_rescale,
                                       ddim_steps=ddim_steps, eta=eta, random_seed=random_seed)
        path = os.path.join(out_dir, f"{i}.wav")
        save_wav(path, wav, ez.sr)
        written.append(path)
    return written


@torch.no_grad()
def codec_fidelity_report(facade, wavs: np.ndarray, sr: int) -> dict:
    """SI-SDR (dB) and the multi-scale mel distance of ``facade``'s round
    trip of ``wavs`` (B, T): the posterior mean encoded, decoded, both cut
    to the shorter length."""
    from ezaudio_tpu_torch.audio.metrics import mel_spectrogram_loss, si_sdr

    ref = torch.as_tensor(np.asarray(wavs, np.float32))
    rec = facade.decode(facade.encode(ref[:, :, None], sample=False))[:, :, 0].float()
    n = min(rec.shape[1], ref.shape[1])
    rec, ref = rec[:, :n], ref[:, :n].to(rec.device)
    return {"si_sdr_db": float(si_sdr(rec, ref)),
            "mel_distance": float(mel_spectrogram_loss(rec, ref, sr=sr))}
