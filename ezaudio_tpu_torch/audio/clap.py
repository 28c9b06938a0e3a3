"""CLAP scoring (counterpart of ``ezaudio_tpu/audio/clap.py``): the CLAP
model of ``models/clap.py`` behind the feature extraction of
``transformers.ClapFeatureExtractor`` (48 kHz, 1024-point hann STFT, hop
480, 64 slaney mel bins, dB log-mel, "repeatpad" padding or a centre crop
to 10 s).

Resampling and the padding are host work (numpy and scipy, as in the JAX
package); the STFT and the log-mel run on the scorer's device.
Tokenization is the caller's: pass a ``tokenizer`` callable or
precomputed RoBERTa ``input_ids``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ezaudio_tpu_torch.audio.stft import mel_filterbank, mel_filterbank_htk, stft
from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict
from ezaudio_tpu_torch.data.audio_io import resample
from ezaudio_tpu_torch.models.clap import CLAP, ClapConfig, clap_state_dict_from_hf, init_clap_
from ezaudio_tpu_torch.utils import cast_params_, resolve_device


def clap_log_mel(wav: torch.Tensor, sr: int = 48000, n_fft: int = 1024, hop: int = 480,
                 n_mels: int = 64, fmin: float = 0.0, fmax: float = 14000.0,
                 scale: str = "slaney") -> torch.Tensor:
    """(B, T) waveform at ``sr`` -> (B, frames, n_mels) dB log-mel, on the
    waveform's device (``ClapFeatureExtractor._np_extract_fbank_features``:
    hann STFT with centre reflect padding, power 2, 10 log10 with a 1e-10
    floor)."""
    wav = torch.atleast_2d(torch.as_tensor(wav, dtype=torch.float32))
    spec = stft(wav, n_fft, hop).abs().square()
    fb = (mel_filterbank(sr, n_fft, n_mels, fmin, fmax) if scale == "slaney"
          else mel_filterbank_htk(sr, n_fft, n_mels, fmin, fmax))
    mel = torch.einsum("mf,bft->btm", torch.from_numpy(fb).to(wav.device), spec)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def prepare_clap_audio(wav, sr: int, *, target_sr: int = 48000, max_length_s: float = 10.0,
                       padding: str = "repeatpad", fmax: float = 14000.0,
                       device=None) -> torch.Tensor:
    """Waveform (T,) or (B, T) at ``sr`` -> ``input_features`` (B, 1,
    frames, 64) for the audio tower, on ``device`` (CUDA unless named).
    Short clips repeat then zero-pad ("repeatpad": whole copies, then
    zeros; "repeat": one copy more, cropped); long clips are centre-cropped
    (the HF extractor crops at random; a fixed crop keeps the score
    deterministic)."""
    device = resolve_device(device)
    if isinstance(wav, torch.Tensor):
        wav = wav.detach().float().cpu().numpy()
    wav = np.atleast_2d(np.asarray(wav, np.float32))
    wav = resample(wav, sr, target_sr)
    max_len = int(max_length_s * target_sr)
    out = np.zeros((wav.shape[0], max_len), np.float32)
    for b in range(wav.shape[0]):
        w = wav[b]
        if len(w) > max_len:
            start = (len(w) - max_len) // 2
            w = w[start:start + max_len]
        elif 0 < len(w) < max_len:
            if padding == "repeatpad":
                w = np.tile(w, max_len // len(w))
            elif padding == "repeat":
                w = np.tile(w, max_len // len(w) + 1)[:max_len]
        out[b, :len(w)] = w[:max_len]
    mel = clap_log_mel(torch.from_numpy(out).to(device), target_sr, fmax=fmax)
    return mel[:, None]


class CLAPScorer:
    """Text-audio alignment scores with the port's CLAP.

    ``weights``: a transformers-format state dict (``torch.load`` of a local
    ``laion/clap-htsat-unfused`` checkpoint or ``ClapModel.state_dict()``),
    loaded strictly; None draws seeded random weights.  ``tokenizer``: an
    optional callable ``texts -> (input_ids, attention_mask)``.
    ``dtype=torch.bfloat16`` computes the JAX package's bf16 model (norms,
    BatchNorm and logit scales in f32).  Runs on CUDA unless
    ``device="cpu"``.
    """

    def __init__(self, cfg: Optional[ClapConfig] = None,
                 weights: Optional[Dict[str, Any]] = None, tokenizer=None,
                 dtype: torch.dtype = torch.float32, device=None):
        self.cfg = cfg or ClapConfig()
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        with torch.device(self.device):
            model = CLAP(self.cfg)
        if weights is not None:
            load_state_dict_strict(model, clap_state_dict_from_hf(weights), "CLAP weights")
        else:
            init_clap_(model, torch.Generator(device=self.device).manual_seed(0))
        self.model = cast_params_(model, dtype).eval().requires_grad_(False)

    @torch.inference_mode()
    def embed_audio(self, wav, sr: int) -> torch.Tensor:
        """(B?, T) waveform -> (B, projection_dim) unit embeddings."""
        feats = prepare_clap_audio(wav, sr, device=self.device)
        return self.model(input_features=feats)["audio_embeds"]

    @torch.inference_mode()
    def embed_text(self, texts_or_ids, attention_mask=None) -> torch.Tensor:
        """Texts (through ``tokenizer``) or (B, L) ids -> (B, projection_dim)
        unit embeddings.  Without a mask, the mask is ``ids != pad_id``, so
        padded ids match transformers (all ones would attend the pads and
        shift the RoBERTa positions)."""
        if isinstance(texts_or_ids, (list, tuple)) and texts_or_ids and \
                isinstance(texts_or_ids[0], str):
            if self.tokenizer is None:
                raise RuntimeError(
                    "CLAPScorer needs a tokenizer for raw text: pass tokenizer=... "
                    "(e.g. a locally-loaded RobertaTokenizer) or precomputed input_ids")
            texts_or_ids, attention_mask = self.tokenizer(list(texts_or_ids))
        ids = torch.as_tensor(texts_or_ids, dtype=torch.long, device=self.device)
        if attention_mask is None:
            mask = (ids != self.cfg.text.pad_token_id).long()
        else:
            mask = torch.as_tensor(attention_mask, dtype=torch.long, device=self.device)
        return self.model(input_ids=ids, attention_mask=mask)["text_embeds"]

    def score(self, wav, sr: int, texts_or_ids, attention_mask=None) -> np.ndarray:
        """Cosine similarity of audio i and text i (the CLAP score)."""
        a = self.embed_audio(wav, sr)
        t = self.embed_text(texts_or_ids, attention_mask)
        return (a * t).sum(-1).float().cpu().numpy()
