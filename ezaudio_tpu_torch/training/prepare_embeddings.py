"""Offline T5 embeddings (counterpart of
``ezaudio_tpu/training/prepare_embeddings.py``): every caption of a CSV
split through the text encoder, written as ``<out_dir>/<absolute_index>.npz``
(``embedding`` (Lc, D) f32, ``mask`` (Lc,) bool), plus ``uncond.npz`` for the
empty prompt: what ``EACaps(text_path=, uncond_path=)`` reads.

    python -m ezaudio_tpu_torch.training.prepare_embeddings \\
        --config-name <cfg.json|.yml|model name> --meta <meta.csv> --out-dir <dir>

The CSV is read with the stdlib ``csv`` module.  Runs on CUDA unless
``--device cpu``; ``--t5-ckpt`` loads a reference-format T5 file, else T5
takes seeded random weights.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch


def _save(path: str, emb: torch.Tensor, mask: torch.Tensor) -> None:
    np.savez(path, embedding=emb.float().cpu().numpy(), mask=mask.bool().cpu().numpy())


@torch.no_grad()
def prepare(ez, meta_csv: str, out_dir: str, subset: str = "train",
            batch_size: int = 32) -> int:
    """Embed every caption of ``subset`` with ``ez.embed_text``; returns
    the number of clips written."""
    os.makedirs(out_dir, exist_ok=True)
    with open(meta_csv, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["split"] == subset]
    emb, mask = ez.embed_text([""])
    _save(os.path.join(out_dir, "uncond.npz"), emb[0], mask[0])
    for i in range(0, len(rows), batch_size):
        chunk = rows[i: i + batch_size]
        emb, mask = ez.embed_text([str(r["caption"]) for r in chunk])
        for j, r in enumerate(chunk):
            _save(os.path.join(out_dir, f"{r['absolute_index']}.npz"), emb[j], mask[j])
    return len(rows)


def main(argv=None, *, t5_config=None, vae_config=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ezaudio_tpu_torch.training.prepare_embeddings")
    ap.add_argument("--config-name", required=True)
    ap.add_argument("--meta", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--subset", default="train")
    ap.add_argument("--t5-ckpt", default=None)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import MODEL_REGISTRY, load_config

    name = args.config_name
    cfg = load_config(MODEL_REGISTRY[name]["config"] if name in MODEL_REGISTRY else name)
    ez = EzAudio(config=cfg.to_dict(), t5_path=args.t5_ckpt, device=args.device,
                 t5_config=t5_config, vae_config=vae_config)
    n = prepare(ez, args.meta, args.out_dir, args.subset, args.batch_size)
    print(f"wrote {n} embeddings to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
