"""Editing (inpainting) and ControlNet quality rows on the trained mid-scale
model (counterpart of ``scripts/quality_edit_controlnet_mid.py``).

Editing rows (the public ``ez.editing_audio``, the reference's paste):
  * mask-region FAD: latent features of the regenerated region against the
    reference distribution's same region (the decode -> encode round trip
    applied to the reference side too);
  * in-mask conditional accuracy of a class-changing edit (gt clip of
    class a, edit prompt of class b != a: the readout must hear b in the
    mask);
  * out-of-mask preservation error against the gt round trip (the paste);
  * the seam's energy step (dB across the mask edges) against the gt's own
    continuity (floor) and a naive cross-clip splice (ceiling);
  * the class-matched splice floor (target-class audio spliced in: the
    content change the edit asks for, with no generative seam);
  * the crossfade A/B (``editing_audio(crossfade=)``, the same clips and
    seeds);
  * same-class edits, whose seam should sit near the gt floor.

ControlNet rows: the mid-scale energy ControlNet (``EzAudioControlNet(base=
ez)``) fine-tuned (``training/controlnet_trainer.py``) on the conditioner
curves of peak-normalised clips, then the Pearson r between a requested
energy curve and the generated audio's, against the t2a baseline.  The
fine-tune starts, as JAX's, from zero projections and a zero mask
embedding (``EzAudioControlNet(zero_projections=True)``) and the in-blocks
copied from the base; its loss is printed as a running mean over each
logging interval.

``--seed-offset k`` adds ``k`` to the data generators' seeds (2, 3 and 4)
and to the fine-tune's step seeds: another seed set on the same trained
base (the sampling seeds stay); 0 is the JAX script's run.

    python -m ezaudio_tpu_torch.validation.quality_edit_controlnet_mid [--depth 12] ...
    CPU smoke (frames stay 500: the ControlNet API's window is 10 s):
        --device cpu --depth 2 --dim 64 --train-steps 30 --cn-steps 20 --n-train 24
        --n-edit 4 --n-cn-train 8 --n-cn-eval 2 --edit-steps 4

Each ``QC_*`` knob of the JAX script is the flag of the same name
(``QC_SKIP_EDIT=1`` -> ``--skip-edit``, ``QC_XFADE`` -> ``--xfade``, ...).
Caches live under ``--cache-root`` (default ``mid_common.default_cache_root()``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance
from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.utils import resolve_device
from ezaudio_tpu_torch.validation import mid_common as mc
from ezaudio_tpu_torch.validation.quality_validate import precision_line
from ezaudio_tpu_torch.validation.quality_validate_mid import features, latent_class, synth_clip


def seam_db(m, m0: int, m1: int, w: int = 10) -> np.ndarray:
    """Mean |energy step| (dB) across the two mask edges, per sample."""
    e = (np.asarray(m, np.float64) ** 2).mean(-1) + 1e-9  # (B, L)

    def step(at):
        left = e[:, at - w: at].mean(1)
        right = e[:, at: at + w].mean(1)
        return np.abs(10 * np.log10(right) - 10 * np.log10(left))

    return 0.5 * (step(m0) + step(m1))


def pearson(a, b) -> float:
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def mask_geometry(frames: int, latent_sr: float):
    """The edit's mask, the middle 40 % of the clip: ``(start s, length s,
    first frame, end frame)``."""
    length_s = frames / latent_sr
    mask_start_s, mask_len_s = 0.3 * length_s, 0.4 * length_s
    m0 = int(mask_start_s * latent_sr)
    return mask_start_s, mask_len_s, m0, m0 + int(mask_len_s * latent_sr)


def preserved_frames(frames: int, latent_sr: float, m0: int, m1: int) -> np.ndarray:
    """The frames the paste must keep: outside the mask and outside the
    re-noised boundary band on each side."""
    out_mask = np.ones(frames, bool)
    out_mask[m0:m1] = False
    bnd = int(0.08 * (frames / latent_sr) * latent_sr) + 2
    out_mask[max(0, m0 - bnd): m0] = False
    out_mask[m1: m1 + bnd] = False
    return out_mask


def _clips(rng, classes, n_samples: int, sr: int) -> np.ndarray:
    return np.stack([mc.peak_wav(synth_clip(rng, int(c), n_samples, sr)) for c in classes])


class Harness:
    """The run's model, data and knobs; each row group is a method."""

    def __init__(self, ez, data: dict, a):
        self.ez, self.data, self.a = ez, data, a
        self.mu, self.sd = data["mu"], data["sd"]
        self.sr, self.latent_sr = ez.sr, ez.latent_sr
        self.n_samples = a.frames * (self.sr // self.latent_sr)
        self.length_s = a.frames / self.latent_sr

    def enc(self, wavs: np.ndarray) -> np.ndarray:
        return (mc.encode(self.ez, wavs) - self.mu) / self.sd

    def run_edits(self, rng, gt_cls, edit_cls, seed0: int, gt_wavs=None, crossfade: float = 0.0):
        """``editing_audio`` of each gt clip (drawn from ``rng`` unless
        given) to its ``edit_cls`` prompt, seeds ``seed0 + i``: the edited
        and the gt clips' model-space latents, and the gt clips."""
        a = self.a
        if gt_wavs is None:
            gt_wavs = _clips(rng, gt_cls, self.n_samples, self.sr)
        mask_start_s, mask_len_s, _, _ = mask_geometry(a.frames, self.latent_sr)
        t0 = time.time()
        edited = []
        for i in range(len(gt_cls)):
            _, w = self.ez.editing_audio(
                mc.PROMPTS[int(edit_cls[i])], boundary=0.08 * self.length_s, gt_file=gt_wavs[i],
                mask_start=mask_start_s, mask_length=mask_len_s, ddim_steps=a.edit_steps,
                guidance_scale=mc.GUIDANCE, random_seed=seed0 + i, crossfade=crossfade)
            edited.append(np.asarray(w, np.float32)[:gt_wavs.shape[1]])
        print(f"edited {len(gt_cls)} clips in {time.time() - t0:.0f}s"
              + (f" (crossfade {crossfade:.3f}s)" if crossfade else ""), flush=True)
        return self.enc(np.stack(edited)), self.enc(gt_wavs), gt_wavs

    def edit_rows(self) -> dict:
        """The seven editing rows, printed as the JAX script prints them."""
        a, n_class = self.a, len(mc.PROMPTS)
        _, _, m0, m1 = mask_geometry(a.frames, self.latent_sr)
        # class-changing edits on fresh gt clips
        rng = np.random.default_rng(2 + a.seed_offset)
        gt_cls = rng.integers(0, n_class, a.n_edit)
        edit_cls = (gt_cls + 1 + rng.integers(0, n_class - 1, a.n_edit)) % n_class
        m_edit, m_gt, gt_wavs = self.run_edits(rng, gt_cls, edit_cls, seed0=0)
        # region FAD against the reference distribution's same region (both
        # sides through decode -> encode)
        ref_rt = mc.roundtrip_latents(self.ez, self.data["m_eval"], self.mu, self.sd)
        r = dict(fad_region=frechet_audio_distance(features(m_edit[:, m0:m1]),
                                                   features(ref_rt[:, m0:m1])),
                 acc_edit=float((latent_class(m_edit[:, m0:m1]) == edit_cls).mean()),
                 acc_gt_region=float((latent_class(m_gt[:, m0:m1]) == gt_cls).mean()))
        out_mask = preserved_frames(a.frames, self.latent_sr, m0, m1)
        r["pres_err"] = float(np.abs(m_edit[:, out_mask] - m_gt[:, out_mask]).mean())
        r["gt_scale"] = float(np.abs(m_gt[:, out_mask]).mean())
        # seam: edited against the gt continuity floor and a naive splice
        r["seam_edit"] = float(seam_db(m_edit, m0, m1).mean())
        r["seam_gt"] = float(seam_db(m_gt, m0, m1).mean())
        spliced = m_gt.copy()
        spliced[:, m0:m1] = np.roll(m_gt[:, m0:m1], 1, axis=0)  # another clip's
        r["seam_splice"] = float(seam_db(spliced, m0, m1).mean())
        # the class-matched splice floor: real target-class clips in the mask
        m_tgt = self.enc(_clips(rng, edit_cls, self.n_samples, self.sr))
        spliced_cm = m_gt.copy()
        spliced_cm[:, m0:m1] = m_tgt[:, m0:m1]
        r["seam_splice_cm"] = float(seam_db(spliced_cm, m0, m1).mean())
        # crossfade A/B: the same gt clips and seeds, only the paste differs
        m_xf, _, _ = self.run_edits(rng, gt_cls, edit_cls, seed0=0, gt_wavs=gt_wavs,
                                    crossfade=a.xfade)
        r["seam_xf"] = float(seam_db(m_xf, m0, m1).mean())
        r["acc_xf"] = float((latent_class(m_xf[:, m0:m1]) == edit_cls).mean())
        r["pres_xf"] = float(np.abs(m_xf[:, out_mask] - m_gt[:, out_mask]).mean())
        n_same = a.n_same if a.n_same is not None else max(8, a.n_edit // 2)
        same_cls = rng.integers(0, n_class, n_same)
        m_same, m_same_gt, _ = self.run_edits(rng, same_cls, same_cls, seed0=1000)
        r["seam_same"] = float(seam_db(m_same, m0, m1).mean())
        r["seam_same_gt"] = float(seam_db(m_same_gt, m0, m1).mean())
        r["acc_same"] = float((latent_class(m_same[:, m0:m1]) == same_cls).mean())

        print("\n| editing metric | value | baseline |")
        print("|---|---|---|")
        print(f"| mask-region FAD vs data | {r['fad_region']:.3f} | — |")
        print(f"| in-mask edit-class accuracy | {r['acc_edit']:.2f} | "
              f"gt-region readout {r['acc_gt_region']:.2f} |")
        print(f"| out-of-mask preservation err | {r['pres_err']:.4f} | "
              f"gt level {r['gt_scale']:.4f} |")
        print(f"| seam energy step, class-changing (dB) | {r['seam_edit']:.2f} | "
              f"gt floor {r['seam_gt']:.2f} / naive splice {r['seam_splice']:.2f} |")
        print(f"| seam, class-MATCHED splice floor (dB) | {r['seam_splice_cm']:.2f} | "
              f"content-change component; artifact = edited - this |")
        print(f"| seam, class-changing + crossfade {a.xfade:.2f}s (dB) | {r['seam_xf']:.2f} | "
              f"in-mask acc {r['acc_xf']:.2f} (vs {r['acc_edit']:.2f}); out-of-mask err "
              f"{r['pres_xf']:.4f} |")
        print(f"| seam energy step, same-class (dB) | {r['seam_same']:.2f} | "
              f"gt floor {r['seam_same_gt']:.2f}; in-mask acc {r['acc_same']:.2f} |",
              flush=True)
        return r

    def condition(self, cn_api, wavs: np.ndarray) -> np.ndarray:
        """The conditioner's curves of ``wavs`` (n, T), computed on the
        model's device, ENCODE_CHUNK clips at a time: (n, frames, 1)."""
        dev = self.ez.device
        return np.concatenate([mc._np(cn_api.conditioner(torch.as_tensor(
            wavs[i:i + mc.ENCODE_CHUNK], device=dev)))
            for i in range(0, len(wavs), mc.ENCODE_CHUNK)], 0)

    def train_controlnet(self, cn_api, schedule, steps: int, rng, cls, lat, cond,
                         log_every: int = 500) -> list:
        """``steps`` fine-tune steps of ``cn_api.controlnet`` (lr 2e-4,
        warmup 100) on batches of rows from ``rng``; step ``i`` draws from
        seed ``i`` plus the seed offset.  Prints (and returns, as ``(step,
        mean)`` pairs) the mean loss over each logging interval.  Leaves the
        ControlNet frozen."""
        from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step

        a, dev, data = self.a, self.ez.device, self.data
        step = make_controlnet_train_step(self.ez.dit, cn_api.controlnet, schedule,
                                          learning_rate=2e-4, warmup=100)
        log = mc.RunningMean()
        t1 = time.time()
        for i in range(steps):
            idx = rng.integers(0, len(cls), a.batch)
            batch = {"latents": torch.as_tensor(lat[idx], device=dev),
                     "condition": torch.as_tensor(cond[idx], device=dev),
                     "text": torch.as_tensor(data["cond_emb"][cls[idx]], device=dev),
                     "text_mask": torch.as_tensor(data["cond_mask"][cls[idx]], device=dev)}
            log.add(step(batch, seed=a.seed_offset + i)["loss"])
            if i % log_every == 0 or i == steps - 1:
                print(f"  [controlnet] step {i}: {log.take(i)} ({time.time() - t1:.0f}s)",
                      flush=True)
        cn_api.controlnet.eval().requires_grad_(False)
        return log.curve

    def controlnet(self):
        """``EzAudioControlNet(base=ez, zero_projections=True)``: the
        fine-tune's start."""
        from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet

        return EzAudioControlNet(base=self.ez, zero_projections=True)

    def controlnet_data(self, cn_api, rng, n: int):
        """``n`` peak-normalised clips of classes drawn from ``rng``: their
        classes, model-space latents and conditioner curves."""
        cn_cls = rng.integers(0, len(mc.PROMPTS), n)
        t0 = time.time()
        cn_wavs = _clips(rng, cn_cls, self.n_samples, self.sr)
        cn_lat = self.enc(cn_wavs)
        cn_cond = self.condition(cn_api, cn_wavs)
        print(f"controlnet training data: {cn_lat.shape} latents, {cn_cond.shape} conditions "
              f"({time.time() - t0:.0f}s)", flush=True)
        return cn_cls, cn_lat, cn_cond

    def controlnet_rows(self, schedule) -> dict:
        """Fine-tune the energy ControlNet, then the energy-curve Pearson r
        of ControlNet samples against t2a samples on held-out clips."""
        a = self.a
        cn_api = self.controlnet()
        rng = np.random.default_rng(3 + a.seed_offset)
        cn_cls, cn_lat, cn_cond = self.controlnet_data(cn_api, rng, a.n_cn_train)
        self.train_controlnet(cn_api, schedule, a.cn_steps, rng, cn_cls, cn_lat, cn_cond)
        return self.controlnet_eval(cn_api, a.n_cn_eval)

    def controlnet_eval(self, cn_api, n_eval: int) -> dict:
        """The Pearson r rows on ``n_eval`` held-out reference clips."""
        a = self.a
        rng = np.random.default_rng(4 + a.seed_offset)
        ev_cls = rng.integers(0, len(mc.PROMPTS), n_eval)
        ev_wavs = _clips(rng, ev_cls, self.n_samples, self.sr)
        r_cn, r_base = [], []
        for i in range(n_eval):
            prompt = mc.PROMPTS[int(ev_cls[i])]
            target = self.condition(cn_api, ev_wavs[i][None])[0, :, 0]
            _, w_cn = cn_api.generate_audio(prompt, ev_wavs[i], ddim_steps=a.edit_steps,
                                            guidance_scale=mc.GUIDANCE, conditioning_scale=1.0,
                                            random_seed=i)
            got = self.condition(cn_api, np.asarray(w_cn, np.float32)[None, :ev_wavs.shape[1]])
            r_cn.append(pearson(target, got[0, :len(target), 0]))
            _, w_t2a = self.ez.generate_audio(prompt, length=self.length_s,
                                              ddim_steps=a.edit_steps,
                                              guidance_scale=mc.GUIDANCE, random_seed=i)
            got0 = self.condition(cn_api,
                                  np.asarray(w_t2a, np.float32)[None, :ev_wavs.shape[1]])
            r_base.append(pearson(target, got0[0, :len(target), 0]))
        r = dict(r_mean=float(np.mean(r_cn)), r_base_mean=float(np.mean(r_base)),
                 r_median=float(np.median(r_cn)), r_base_median=float(np.median(r_base)))
        print("\n| controlnet metric | value | baseline (no controlnet) |")
        print("|---|---|---|")
        print(f"| energy-curve Pearson r (mean over {n_eval}) | {r['r_mean']:.3f} | "
              f"{r['r_base_mean']:.3f} |")
        print(f"| energy-curve Pearson r (median) | {r['r_median']:.3f} | "
              f"{r['r_base_median']:.3f} |", flush=True)
        return r


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m ezaudio_tpu_torch.validation.quality_edit_controlnet_mid",
        description="Each flag is the JAX script's QC_* knob of the same name.")
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--train-steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--cn-steps", type=int, default=1500)
    p.add_argument("--n-cn-train", type=int, default=512)
    p.add_argument("--n-edit", type=int, default=48)
    p.add_argument("--n-cn-eval", type=int, default=32)
    p.add_argument("--edit-steps", type=int, default=50)
    p.add_argument("--vae-steps", type=int, default=1500)
    p.add_argument("--xfade", type=float, default=0.06, help="the crossfade A/B's seconds")
    p.add_argument("--n-same", type=int, default=None,
                   help="same-class edits (default max(8, n_edit // 2))")
    p.add_argument("--skip-edit", action="store_true", help="no editing rows")
    p.add_argument("--skip-cn", action="store_true", help="no ControlNet rows")
    p.add_argument("--seed-offset", type=int, default=0,
                   help="added to the data generators' (2, 3, 4) and the fine-tune's step "
                        "seeds: another seed set")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--cache-root", default=None,
                   help="caches (default: outside the checkout, mid_common.default_cache_root)")
    a = p.parse_args(argv)
    a.cache_root = a.cache_root or mc.default_cache_root()
    return a


def main(argv=None, *, vae_config: Optional[dict] = None) -> dict:
    """Run the harness; ``vae_config`` replaces ``vae.json`` (tests run a
    tiny one).  Returns ``{"edit": ..., "controlnet": ...}``, the rows'
    numbers of each group that ran."""
    a = parse_args(argv)
    device = resolve_device(a.device)
    print(precision_line(device), flush=True)
    walls, out = {}, {}
    t0 = time.time()
    ez, cfg, model_cfg, _ = mc.build_mid_ezaudio(a.depth, a.dim, a.heads, a.frames,
                                                 with_controlnet=True, device=device,
                                                 vae_config=vae_config)
    mc.fit_vae(ez, steps=a.vae_steps, cache_root=a.cache_root)
    data = mc.prepare_data(ez, a.frames, a.n_train, max(a.n_edit, 32), cache_root=a.cache_root)
    mc.train_teacher(ez, model_cfg, data, a.train_steps, a.batch, cache_root=a.cache_root)
    walls["setup_s"] = time.time() - t0
    h = Harness(ez, data, a)
    if not a.skip_edit:
        t0 = time.time()
        out["edit"] = h.edit_rows()
        walls["edit_s"] = time.time() - t0
    if not a.skip_cn:
        t0 = time.time()
        out["controlnet"] = h.controlnet_rows(DDIMSchedule.from_config(cfg["diff"]))
        walls["controlnet_s"] = time.time() - t0
    print("stage walls " + json.dumps(walls), flush=True)
    return out


if __name__ == "__main__":
    main()
