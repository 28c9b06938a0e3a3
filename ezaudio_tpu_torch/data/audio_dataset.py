"""Multi-source audio dataset for codec training (counterpart of
``ezaudio_tpu/data/audio_dataset.py``).

Equivalents of reference ``audiotools/data/datasets.py``:
  * ``AudioLoader`` (:15-150): draws random (optionally salient) excerpts
    from a list of sources (folders or CSV manifests), with per-source
    weights;
  * ``AudioDataset`` (:153-476): combines loaders; ``aligned=True`` draws
    the same index from every loader (for paired data);
  * resumable iteration lives in ``ezaudio_tpu_torch.data.dataset.ResumableIterator``.

Every draw is the JAX package's, from the same per-item generator
``default_rng((seed, idx))``, so an index gives the same excerpt and the
same transform parameters.  The signals carry ``device``: the spectral
transforms run there (CUDA unless another is named).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ezaudio_tpu_torch.audio.signal import AudioSignal
from ezaudio_tpu_torch.data.manifest import find_audio, read_csv_column


class AudioLoader:
    def __init__(self, sources: Sequence[str], weights: Optional[Sequence[float]] = None,
                 transform=None):
        src_files = []
        for s in sources:
            if os.path.isdir(s):
                src_files.append(find_audio(s))
            elif s.endswith(".csv"):
                base = os.path.dirname(s)
                src_files.append([os.path.join(base, p)
                                  for p in read_csv_column(s, "audio_path")])
            else:
                src_files.append([s])
        self.src_files = src_files
        w = np.asarray(weights if weights is not None else [1.0] * len(src_files), np.float64)
        self.weights = w / w.sum()
        self.transform = transform

    def __call__(self, rng: np.random.Generator, duration: float, sr: int,
                 loudness_cutoff: Optional[float] = -40.0,
                 item_idx: Optional[int] = None,
                 source_idx: Optional[int] = None,
                 offset: Optional[int] = None, device=None) -> AudioSignal:
        """``source_idx``/``offset`` pin the source choice and excerpt
        window: AudioDataset(aligned=True) propagates them from the first
        loader so paired data shares the same time window (reference
        datasets.py:243-258)."""
        src = (int(rng.choice(len(self.src_files), p=self.weights))
               if source_idx is None else int(source_idx))
        files = self.src_files[src]
        idx = (item_idx % len(files)) if item_idx is not None else int(rng.integers(len(files)))
        path = files[idx]
        if offset is not None:
            sig = AudioSignal.excerpt(path, duration, state=rng, sr=sr, offset=offset,
                                      device=device)
        elif loudness_cutoff is not None:
            sig = AudioSignal.salient_excerpt(path, duration, loudness_cutoff=loudness_cutoff,
                                              state=rng, sr=sr, device=device)
        else:
            sig = AudioSignal.excerpt(path, duration, state=rng, sr=sr, device=device)
        sig.metadata["source_idx"] = src
        if self.transform is not None:
            sig = self.transform(sig, rng)
        return sig


class AudioDataset:
    def __init__(self, loaders, duration: float = 1.0, sample_rate: int = 24000,
                 n_examples: int = 1000, aligned: bool = False,
                 loudness_cutoff: Optional[float] = -40.0, seed: int = 0, device=None):
        self.loaders = loaders if isinstance(loaders, (list, tuple)) else [loaders]
        self.duration = duration
        self.sample_rate = sample_rate
        self.n_examples = n_examples
        self.aligned = aligned
        self.loudness_cutoff = loudness_cutoff
        self.seed = seed
        self.device = device

    def __len__(self):
        return self.n_examples

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, idx))
        out = {"idx": idx}
        src0 = off0 = None
        for i, loader in enumerate(self.loaders):
            sig = loader(rng, self.duration, self.sample_rate, self.loudness_cutoff,
                         item_idx=idx if self.aligned else None,
                         source_idx=src0, offset=off0, device=self.device)
            if self.aligned and i == 0:
                # pin the pair: same source choice and excerpt window for
                # every subsequent loader (reference datasets.py aligned)
                src0 = sig.metadata.get("source_idx")
                off0 = sig.metadata.get("offset")
            out[f"signal_{i}" if len(self.loaders) > 1 else "signal"] = sig
        return out

    def batches(self, batch_size: int):
        for i in range(0, len(self), batch_size):
            items = [self[j] for j in range(i, min(i + batch_size, len(self)))]
            keys = [k for k in items[0] if k.startswith("signal")]
            batch = {"idx": [it["idx"] for it in items]}
            for k in keys:
                batch[k] = AudioSignal.batch([it[k] for it in items])
            yield batch
