"""Whisper feature/transcript/embedding extraction (WhisperMixin
equivalent; counterpart of ``ezaudio_tpu/audio/whisper.py``).

Reference surface: audiotools/core/whisper.py:7-97 —
setup_whisper / get_whisper_features / get_whisper_transcript /
get_whisper_embeddings on AudioSignal.  This module provides the same
capabilities as a standalone wrapper class:

* **features** need no weights at all: `WhisperFeatureExtractor` is a
  config-only numpy log-mel frontend, so feature extraction works fully
  offline with transformers' defaults (80 mel bins, 16 kHz, 30 s pad).
* **transcript / embeddings** need model weights.  No published
  checkpoint ships with the project, so `WhisperWrapper` accepts a
  *local* `from_pretrained` path OR pre-built (processor, model) objects —
  the tests drive the full code path with a tiny randomly-initialized
  Whisper, and production passes a downloaded snapshot directory.

transformers is imported inside the functions that need it, so the module
imports where transformers is not installed.  The port's own Whisper (the
encoder and decoder in plain torch on the device, the log-mel front-end on
the device, a cached greedy decoder, the same checkpoint names) is
``ezaudio_tpu_torch.models.whisper.WhisperTranscriber``; either serves as
the ``wrapper`` of the ``AudioSignal.get_whisper_*`` methods.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return wav
    from ezaudio_tpu_torch.data.audio_io import resample

    return resample(wav, sr, target_sr)


class WhisperWrapper:
    """Holds the processor + model pair and exposes the three extractions.

    Parameters
    ----------
    model : str | None
        Local path for ``from_pretrained`` (e.g. a downloaded
        ``openai/whisper-base.en`` snapshot).  Hub ids are refused: the
        wrapper reads local files only.
    processor, whisper_model :
        Pre-built ``WhisperProcessor``-like and
        ``WhisperForConditionalGeneration``-like objects; override
        ``model``.  The processor only needs ``__call__``,
        ``batch_decode`` and ``.feature_extractor.sampling_rate``.
    device :
        Where the model runs: CUDA unless another is named.
    """

    def __init__(self, model: Optional[str] = None, processor=None,
                 whisper_model=None, device=None):
        from ezaudio_tpu_torch.utils import resolve_device

        self.device = resolve_device(device)
        if processor is not None and whisper_model is not None:
            self.processor = processor
            self.model = whisper_model
        elif model is not None:
            import os

            if not os.path.isdir(model):
                # fail fast: a hub id would send transformers to the network
                raise ValueError(
                    f"WhisperWrapper model path {model!r} is not a local "
                    "directory; pass a downloaded snapshot directory (or "
                    "pre-built processor/model objects).")
            from transformers import (WhisperForConditionalGeneration,
                                      WhisperProcessor)

            self.processor = WhisperProcessor.from_pretrained(model)
            self.model = WhisperForConditionalGeneration.from_pretrained(
                model).to(self.device)
        else:
            raise ValueError(
                "WhisperWrapper needs either a local model path or "
                "pre-built (processor, whisper_model) objects.  No Whisper "
                "weights ship with the project; download a "
                "snapshot and pass its directory.  For weight-free feature "
                "extraction use whisper_features() directly.")
        if hasattr(self.model, "eval"):
            self.model.eval()

    @property
    def sampling_rate(self) -> int:
        return int(self.processor.feature_extractor.sampling_rate)

    def features(self, wav: np.ndarray, sr: int):
        """Log-mel input features, shape (1, n_mels, n_frames)
        (whisper.py:24 get_whisper_features)."""
        import torch

        mono = _to_mono(wav)
        mono = _resample(mono, sr, self.sampling_rate)
        with torch.inference_mode():
            out = self.processor([mono], sampling_rate=self.sampling_rate,
                                 return_tensors="pt")
        return out.input_features

    def transcript(self, wav: np.ndarray, sr: int, **generate_kwargs) -> str:
        """Decoded transcription incl. special tokens
        (whisper.py:56 get_whisper_transcript)."""
        import torch

        feats = self.features(wav, sr).to(self.device)
        with torch.inference_mode():
            ids = self.model.generate(inputs=feats, **generate_kwargs)
        return self.processor.batch_decode(ids)[0]

    def embeddings(self, wav: np.ndarray, sr: int):
        """Encoder last hidden state, shape (1, seq, hidden)
        (whisper.py:77 get_whisper_embeddings)."""
        import torch

        feats = self.features(wav, sr).to(self.device)
        encoder = self.model.get_encoder()
        with torch.inference_mode():
            return encoder(feats).last_hidden_state


def whisper_features(wav: np.ndarray, sr: int, n_mels: int = 80):
    """Weight-free feature extraction with transformers' default Whisper
    frontend (config-only, works fully offline).  Returns the (1, n_mels,
    3000) torch tensor the models consume."""
    import torch
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor(feature_size=n_mels)
    mono = _resample(_to_mono(wav), sr, int(fe.sampling_rate))
    with torch.inference_mode():
        return fe([mono], sampling_rate=int(fe.sampling_rate),
                  return_tensors="pt").input_features


def _to_mono(wav: np.ndarray) -> np.ndarray:
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    return wav
