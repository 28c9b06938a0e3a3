"""Training dataset: CSV-manifest audio-caption pairs (counterpart of
``ezaudio_tpu/data/dataset.py``: ``EACaps`` and ``ResumableIterator``).

  * CSV metadata (``audio_path, caption, split`` plus ``fine_tune_data``,
    ``audio_length``, ``absolute_index``), read with the stdlib ``csv``
    module; split and fine-tune filtering, zero-length rows dropped
    outside prepare mode;
  * channel policy: 5.1 -> mean of the front pair; stereo -> mono mean,
    or with ``mono=False`` a random pick of mean, left or right;
  * a random ``seg_length``-second crop, zero padding to the fixed length,
    peak normalisation, then ``aug_config``'s waveform augmentations
    (``wav_aug.py``) drawn from the dataset's generator;
  * offline embeddings: a cached per-clip text embedding and mask
    (``<text_path>/<absolute_index>.npz``), swapped for the cached uncond
    embedding with probability ``cfg_prob``;
  * ``prepare_mode`` yields (text, absolute_index) for precomputing them.

The numpy draws are the JAX package's, in its order, so one manifest and
one seed give the same batches bit for bit, augmentations included.
``use_native=True`` reads each batch with one call of the threaded C++
loader (``data/native_loader.py``: decode, crop, pad and normalise in a
thread pool, seeded from the dataset's generator), where its fixed
policy applies: no augmenter, mono, norm, no offline embeddings or
prepare mode, and the library available; an item it reports an error
for is read by the Python path instead.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, Optional

import numpy as np

from ezaudio_tpu_torch.data.audio_io import load_wav
from ezaudio_tpu_torch.data.wav_aug import WavAugmentation

_TRUE = ("true", "1", "1.0")


def _keep_length(value: str) -> bool:
    """pandas' ``audio_length != 0``: an empty cell (NaN) is kept."""
    try:
        return float(value) != 0
    except ValueError:
        return True


class EACaps:
    def __init__(self, data_dir: str, meta_dir: str, subset: str = "train",
                 fine_tune: bool = True, seg_length: float = 10, sr: int = 24000,
                 aug_config: Optional[dict] = None, norm: bool = True,
                 mono: bool = True, text_path: Optional[str] = None,
                 uncond_path: Optional[str] = None, cfg_prob: float = 0.0,
                 prepare_mode: bool = False, seed: int = 0,
                 use_native: bool = False, native_threads: int = 8, **kwargs):
        self.data_dir = data_dir
        with open(meta_dir, newline="") as f:
            rows = [r for r in csv.DictReader(f) if r["split"] == subset]
        if fine_tune and rows and "fine_tune_data" in rows[0]:
            rows = [r for r in rows if r["fine_tune_data"].strip().lower() in _TRUE]
        if not prepare_mode and rows and "audio_length" in rows[0]:
            rows = [r for r in rows if _keep_length(r["audio_length"])]
        self.meta = rows
        self.seg_len = seg_length
        self.sr = sr
        self.norm = norm
        self.mono = mono
        self.prepare_mode = prepare_mode
        self.rng = np.random.default_rng(seed)
        self.augmenter = WavAugmentation(aug_config, sr=sr, rng=self.rng) if aug_config else None
        self.text_path = text_path
        self.cfg_prob = cfg_prob
        self.uncond = None
        if text_path is not None:
            if uncond_path is None:
                raise ValueError("offline embeddings (text_path) need uncond_path")
            self.uncond = dict(np.load(uncond_path))
        self.use_native = False
        if use_native and self.augmenter is None and mono and norm:
            from ezaudio_tpu_torch.data import native_loader

            if native_loader.available():
                self.use_native = True
                self.native_threads = native_threads

    def __len__(self):
        return len(self.meta)

    def load_audio(self, audio_path: str) -> np.ndarray:
        y = load_wav(audio_path, sr=self.sr, mono=False)
        if y.ndim == 1:
            y = y[None, :]
        if y.shape[0] == 6:
            y = y[:2].mean(axis=0, keepdims=True)
        if self.mono:
            y = y.mean(axis=0, keepdims=True)
        elif y.shape[0] == 2:
            pick = self.rng.integers(0, 3)
            y = y.mean(axis=0, keepdims=True) if pick == 0 else y[pick - 1: pick]
        total = y.shape[-1]
        n = int(self.seg_len * self.sr)
        start = self.rng.integers(0, max(total - n, 0) + 1)
        end = min(start + n, total)
        clip = np.zeros(n, np.float32)
        clip[: end - start] = y[0, start:end]
        if self.norm:
            clip = clip / (np.abs(clip).max() + 1e-9)
        if self.augmenter is not None:
            clip = self.augmenter(clip)
        return clip

    def __getitem__(self, index: int):
        row = self.meta[index]
        text = row["caption"]
        if self.prepare_mode:
            return text, row["absolute_index"]
        clip = self.load_audio(os.path.join(self.data_dir, row["audio_path"]))
        if self.text_path:
            if self.rng.random() < self.cfg_prob:
                emb = self.uncond
            else:
                emb = dict(np.load(os.path.join(self.text_path,
                                                f"{row['absolute_index']}.npz")))
            return clip, emb["embedding"], emb["mask"]
        return clip, text

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[dict]:
        """Fixed-shape numpy batches: ``audio`` (B, T) and ``text`` (a list
        of captions, or (B, Lc, D) embeddings with ``text_mask``)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        n_full = len(order) // batch_size
        end = n_full * batch_size if drop_remainder else len(order)
        for i in range(0, end, batch_size):
            idx = order[i: i + batch_size]
            if self.use_native and not self.prepare_mode and not self.text_path:
                yield self._native_batch(idx)
                continue
            items = [self[j] for j in idx]
            if self.prepare_mode:
                yield {"text": [it[0] for it in items], "index": [it[1] for it in items]}
            elif self.text_path:
                yield {"audio": np.stack([it[0] for it in items]),
                       "text": np.stack([it[1] for it in items]),
                       "text_mask": np.stack([it[2] for it in items])}
            else:
                yield {"audio": np.stack([it[0] for it in items]),
                       "text": [it[1] for it in items]}


    def _native_batch(self, idx) -> dict:
        """One ``load_batch`` call for the rows ``idx``; an item with an
        error status is read by :meth:`load_audio`."""
        from ezaudio_tpu_torch.data import native_loader

        paths = [os.path.join(self.data_dir, self.meta[j]["audio_path"]) for j in idx]
        audio, status = native_loader.load_batch(
            paths, int(self.seg_len * self.sr), self.sr, normalize=self.norm,
            seed=int(self.rng.integers(1, 2**63 - 1)), n_threads=self.native_threads)
        for b in np.nonzero(status)[0]:
            audio[b] = self.load_audio(paths[b])
        return {"audio": audio, "text": [self.meta[j]["caption"] for j in idx]}


class ResumableIterator:
    """Deterministic, resumable epoch iterator: state = (epoch, step); each
    epoch reseeds the dataset's generator from (seed, epoch), and rebinds
    the augmenter to it, so a restored state replays the same order and
    augmentations and skips what was consumed."""

    def __init__(self, dataset: EACaps, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.step = 0

    def state_dict(self):
        return {"epoch": self.epoch, "step": self.step}

    def load_state_dict(self, state):
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])

    def __iter__(self):
        while True:
            self.dataset.rng = np.random.default_rng((self.seed, self.epoch))
            if self.dataset.augmenter is not None:
                self.dataset.augmenter.rng = self.dataset.rng
            for i, batch in enumerate(self.dataset.batches(self.batch_size)):
                if i < self.step:
                    continue
                self.step = i + 1
                yield batch
            self.epoch += 1
            self.step = 0
