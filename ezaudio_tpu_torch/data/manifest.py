"""Dataset manifests (counterpart of ``ezaudio_tpu/data/manifest.py``).

Equivalents of reference ``audiotools/data/preprocess.py`` (``create_csv``)
and ``audiotools/core/util.py`` ``find_audio``: scan directories for audio
files and build CSV manifests with optional durations, in the column format
the EACaps dataset expects.  The JAX package writes the CSV with pandas;
the port writes the same bytes with the ``csv`` module (same columns and
order, floats as their shortest repr, booleans as ``True``), so it runs
where pandas is not installed.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

AUDIO_EXTENSIONS = (".wav", ".flac", ".mp3", ".ogg")


def find_audio(folder: str, ext: Sequence[str] = AUDIO_EXTENSIONS) -> List[str]:
    out = []
    for root, _, files in os.walk(folder):
        for f in sorted(files):
            if f.lower().endswith(tuple(ext)):
                out.append(os.path.join(root, f))
    return out


def _duration(path: str) -> float:
    try:
        from scipy.io import wavfile

        sr, data = wavfile.read(path, mmap=True)
        return len(data) / sr
    except Exception:
        return 0.0


def create_csv(audio_dir: str, output_csv: str, split: str = "train",
               captions: Optional[dict] = None, loudness: bool = False,
               relative: bool = True) -> List[Dict]:
    """Build an EACaps-compatible manifest: one row per audio file with
    audio_path, caption, split, audio_length, absolute_index,
    fine_tune_data (and optionally loudness).  Returns the rows."""
    paths = find_audio(audio_dir)
    rows = []
    for i, p in enumerate(paths):
        rel = os.path.relpath(p, audio_dir) if relative else p
        row = {
            "audio_path": rel,
            "caption": (captions or {}).get(rel, os.path.splitext(
                os.path.basename(p))[0].replace("_", " ")),
            "split": split,
            "audio_length": _duration(p),
            "absolute_index": i,
            "fine_tune_data": True,
        }
        if loudness:
            from ezaudio_tpu_torch.audio.signal import AudioSignal

            try:
                row["loudness"] = AudioSignal.load(p).loudness()
            except Exception:
                row["loudness"] = float("-inf")
        rows.append(row)
    with open(output_csv, "w", newline="") as f:
        if not rows:
            f.write("\n")  # pandas' CSV of an empty frame
        else:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(rows[0])
            for row in rows:
                w.writerow(repr(float(v)) if isinstance(v, float) else v
                           for v in row.values())
    return rows


def read_csv_column(path: str, column: str) -> List[str]:
    """One column of a CSV manifest, as strings."""
    with open(path, newline="") as f:
        return [row[column] for row in csv.DictReader(f)]
