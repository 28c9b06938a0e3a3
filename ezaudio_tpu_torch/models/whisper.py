"""Whisper, speech to text, for the AudioSignal Whisper methods (counterpart
of ``ezaudio_tpu/models/whisper.py``).

Reference: ``audiotools/core/whisper.py`` wires transformers'
``WhisperForConditionalGeneration`` and ``WhisperProcessor`` into three
AudioSignal methods: ``get_whisper_features`` (the log-mel
``input_features``), ``get_whisper_embeddings`` (the encoder's
``last_hidden_state``) and ``get_whisper_transcript`` (greedy generation).

  * :func:`whisper_log_mel`: ``WhisperFeatureExtractor``'s numerics on the
    device (the port's ``audio/stft.py``: reflect-padded periodic-hann
    400/160 frames, ``rfft``, power, slaney mel to 8 kHz, log10, the
    per-item ``max - 8`` clamp, ``(x + 4) / 4``);
  * :class:`WhisperForConditionalGeneration`: the pre-LN encoder (two
    convs, sinusoidal positions) and decoder (causal self-attention,
    cross-attention) with transformers' module and parameter names, so its
    state dict loads strictly (``k_proj`` has no bias, q is scaled after
    its projection, GELU is erf, ``proj_out`` is tied to ``embed_tokens``).
    Attention is plain torch with f32 logits and softmax: the JAX package
    computes it outside any Pallas kernel;
  * :func:`greedy_decode`: the JAX package's ids (its one-scan loop over a
    fixed buffer, every token after the first EOS pinned to EOS), computed
    with a key/value cache: the prompt in one pass, then one token a step;
  * :class:`WhisperTranscriber`: features, embeddings, transcription, on
    ``device`` (CUDA unless another is named).

The JAX package's ``convert_whisper_state_dict`` has no counterpart: the
port's names are transformers', and ``convert/from_jax.py::whisper_state_dict_from_jax``
carries the JAX package's parameters across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.audio.stft import mel_filterbank, stft
from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict
from ezaudio_tpu_torch.ops.convs import Conv1d
from ezaudio_tpu_torch.ops.norms import LayerNorm
from ezaudio_tpu_torch.utils import cast_params_, init_seeded_, resolve_device


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Defaults: whisper-base (d 512, 6 + 6 layers, 8 heads of 64)."""
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50257
    eos_token_id: int = 50256
    scale_embedding: bool = False

    @classmethod
    def from_hf_config(cls, hf) -> "WhisperConfig":
        kw = {f.name: getattr(hf, f.name) for f in dataclasses.fields(cls)
              if f.name != "scale_embedding"}
        return cls(scale_embedding=getattr(hf, "scale_embedding", False), **kw)


# ---------------------------------------------------------------------------
# log-mel front-end (WhisperFeatureExtractor numerics)
# ---------------------------------------------------------------------------

WHISPER_SR = 16000
_N_FFT = 400
_HOP = 160


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 80,
                    chunk_length: int = 30) -> torch.Tensor:
    """(B, T) 16 kHz waveform -> (B, n_mels, 3000) Whisper input_features,
    on the waveform's device: zero pad or trim to 30 s, periodic-hann
    400/160 centred (reflect) STFT, power spectrum, slaney mel (fmax 8 kHz),
    log10 with a 1e-10 floor, per-item clamp to [max - 8, max], then
    (x + 4) / 4.  The last STFT frame is dropped (HF ``log_spec[:, :-1]``)."""
    if audio.ndim == 1:
        audio = audio[None]
    n_samples = chunk_length * WHISPER_SR
    T = audio.shape[-1]
    audio = audio[:, :n_samples] if T >= n_samples else F.pad(audio, (0, n_samples - T))
    spec = stft(audio.float(), _N_FFT, _HOP).abs() ** 2        # (B, bins, frames)
    spec = spec[:, :, :-1]
    fb = torch.from_numpy(mel_filterbank(WHISPER_SR, _N_FFT, n_mels, 0.0, 8000.0)).to(
        spec.device)
    log_spec = torch.log10(torch.einsum("mf,bft->bmt", fb, spec).clamp_min(1e-10))
    mx = log_spec.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, mx - 8.0) + 4.0) / 4.0


# ---------------------------------------------------------------------------
# model (transformers' names)
# ---------------------------------------------------------------------------

class WhisperAttention(nn.Module):
    """q, v and out have a bias, k has none; q is scaled after its
    projection.  :meth:`kv` gives the keys and values alone, for the
    decoder's caches."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def _split(self, x):
        B, L, D = x.shape
        return x.reshape(B, L, self.heads, D // self.heads).transpose(1, 2)

    def kv(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._split(self.k_proj(x)), self._split(self.v_proj(x))

    def forward(self, x, kv=None, mask_bias=None):
        """``kv``: (k, v) in (B, H, Lk, hd), else this layer's own of ``x``."""
        B, L, D = x.shape
        q = self._split(self.q_proj(x) * (D // self.heads) ** -0.5)
        k, v = self.kv(x) if kv is None else kv
        logits = (q @ k.transpose(-1, -2)).float()
        if mask_bias is not None:
            logits = logits + mask_bias
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, L, D))


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.encoder_attention_heads)
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d)

    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder positions: sin then cos over log-spaced rates."""
    half = channels // 2
    inv = np.exp(-(np.log(10000.0) / (half - 1)) * np.arange(half))
    ang = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=1)).float()


class WhisperEncoder(nn.Module):
    """(B, n_mels, 2 * max_source_positions) features -> (B, S, d)."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(d)

    def forward(self, features):
        x = F.gelu(self.conv1(features.to(self.conv1.weight.dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.embed_positions.weight[: x.shape[1]].to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.decoder_attention_heads)
        self.self_attn_layer_norm = LayerNorm(d)
        self.encoder_attn = WhisperAttention(d, cfg.decoder_attention_heads)
        self.encoder_attn_layer_norm = LayerNorm(d)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d)

    def forward(self, x, cross_kv, mask_bias, cache: Optional[List[torch.Tensor]] = None):
        """``cache``: [k, v] of the earlier positions (None for a full
        pass), extended in place by this call's."""
        h = self.self_attn_layer_norm(x)
        k, v = self.self_attn.kv(h)
        if cache is not None:
            if cache:
                k, v = torch.cat([cache[0], k], 2), torch.cat([cache[1], v], 2)
            cache[:] = [k, v]
        x = x + self.self_attn(h, kv=(k, v), mask_bias=mask_bias)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), kv=cross_kv)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, d)
        self.layers = nn.ModuleList(_DecoderLayer(cfg) for _ in range(cfg.decoder_layers))
        self.layer_norm = LayerNorm(d)

    def cross_kv(self, enc) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each layer's cross-attention keys and values of the encoder output."""
        return [layer.encoder_attn.kv(enc) for layer in self.layers]

    def forward(self, tokens, cross_kv, start: int = 0,
                caches: Optional[List[List[torch.Tensor]]] = None):
        """(B, L) tokens at positions ``start`` .. ``start + L - 1`` ->
        (B, L, d) hidden states; causal over the cached positions and these."""
        L = tokens.shape[-1]
        x = self.embed_tokens(tokens)
        if self.cfg.scale_embedding:
            x = x * math.sqrt(self.cfg.d_model)
        x = x + self.embed_positions.weight[start: start + L].to(x.dtype)
        keys = torch.arange(start + L, device=tokens.device)
        rows = torch.arange(start, start + L, device=tokens.device)
        mask_bias = torch.where(keys[None, :] <= rows[:, None], 0.0, float("-inf"))
        for i, layer in enumerate(self.layers):
            x = layer(x, cross_kv[i], mask_bias, None if caches is None else caches[i])
        return self.layer_norm(x)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)


class WhisperForConditionalGeneration(nn.Module):
    """transformers' ``WhisperForConditionalGeneration`` names: ``model.*``
    and ``proj_out`` (tied to ``model.decoder.embed_tokens``)."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.model = WhisperModel(cfg)
        self.proj_out = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        self.proj_out.weight = self.model.decoder.embed_tokens.weight

    def encode(self, features):
        return self.model.encoder(features)

    def logits(self, hidden):
        return hidden @ self.proj_out.weight.to(hidden.dtype).t()

    def forward(self, features, tokens):
        """(B, n_mels, T) features and (B, L) tokens -> (B, L, vocab) logits."""
        dec = self.model.decoder
        return self.logits(dec(tokens, dec.cross_kv(self.encode(features))))


@torch.no_grad()
def init_whisper_(model: WhisperForConditionalGeneration,
                  generator: torch.Generator) -> WhisperForConditionalGeneration:
    """Seeded random weights (``utils.init_seeded_``: no bias or norm left
    at zero or one, ROADMAP F6), the encoder's positions the sinusoids
    (transformers and the JAX package draw them so)."""
    init_seeded_(model, generator, (LayerNorm,))
    pos = model.model.encoder.embed_positions.weight
    pos.copy_(sinusoids(*pos.shape))
    return model


def whisper_state_dict(weights: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A transformers ``WhisperForConditionalGeneration`` state dict -> what
    :class:`WhisperForConditionalGeneration` loads strictly: ``proj_out.weight``
    filled from the tied ``embed_tokens`` when absent, and refused when it
    differs from it."""
    sd = {k: torch.as_tensor(v) for k, v in weights.items()}
    emb = sd.get("model.decoder.embed_tokens.weight")
    if emb is not None:
        out = sd.setdefault("proj_out.weight", emb)
        if not torch.equal(out, emb):
            raise ValueError("proj_out.weight differs from model.decoder.embed_tokens.weight: "
                             "Whisper ties them")
    return sd


# ---------------------------------------------------------------------------
# greedy decoding
# ---------------------------------------------------------------------------

@torch.inference_mode()
def greedy_decode(model: WhisperForConditionalGeneration, features: torch.Tensor,
                  prompt_ids: Tuple[int, ...], max_new_tokens: int = 64,
                  return_logits: bool = False):
    """Greedy generation: (B, n_mels, T) features -> (B, P + N) int32 ids on
    the host (numpy), as the JAX package's.  ``prompt_ids`` is the forced prefix (decoder start
    and any task tokens); every token after the first EOS is EOS.  With
    ``return_logits``, also the (B, N, vocab) f32 logits each new token was
    chosen from."""
    cfg = model.cfg
    B = features.shape[0]
    P = len(prompt_ids)
    L = P + max_new_tokens
    if L > cfg.max_target_positions:
        raise ValueError(f"{L} tokens exceeds max_target_positions {cfg.max_target_positions}")
    dec = model.model.decoder
    cross = dec.cross_kv(model.encode(features))
    caches: List[List[torch.Tensor]] = [[] for _ in dec.layers]
    ids = torch.tensor(prompt_ids, dtype=torch.long, device=features.device).expand(B, P)
    out, scores = [ids], []
    done = torch.zeros(B, dtype=torch.bool, device=features.device)
    tokens, start = ids, 0
    for _ in range(max_new_tokens):
        logits = model.logits(dec(tokens, cross, start, caches)[:, -1]).float()
        nxt = torch.where(done, cfg.eos_token_id, logits.argmax(-1))
        done = done | (nxt == cfg.eos_token_id)
        out.append(nxt[:, None])
        scores.append(logits)
        start += tokens.shape[1]
        tokens = nxt[:, None]
    ids = torch.cat(out, 1).cpu().numpy().astype(np.int32)
    if return_logits:
        return ids, torch.stack(scores, 1)
    return ids


# ---------------------------------------------------------------------------
# user-facing wrapper (the mixin's engine)
# ---------------------------------------------------------------------------

class WhisperTranscriber:
    """Waveform -> features / embeddings / transcript ids, on ``device``
    (CUDA unless another is named).

    ``weights``: a transformers-format state dict (``torch.load`` of a
    local Whisper checkpoint), loaded strictly, or None for seeded random
    weights (``seed``).  ``tokenizer``: any object with
    ``decode(ids) -> str``; without it ``transcribe`` returns token ids.
    """

    def __init__(self, sr: int, cfg: Optional[WhisperConfig] = None,
                 weights: Optional[Dict[str, Any]] = None, tokenizer: Any = None,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        self.sr = sr
        self.cfg = cfg or WhisperConfig()
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        with torch.device(self.device):
            model = WhisperForConditionalGeneration(self.cfg)
        if weights is not None:
            load_state_dict_strict(model, whisper_state_dict(weights), "Whisper weights")
        else:
            init_whisper_(model, torch.Generator(device=self.device).manual_seed(seed))
        self.model = cast_params_(model, dtype).eval().requires_grad_(False)

    def _to_16k(self, audio, sr: Optional[int]) -> torch.Tensor:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        if audio.ndim == 3:  # (B, C, T) -> mono, as the reference mixin does
            audio = audio.mean(axis=1)
        sr = self.sr if sr is None else int(sr)
        if sr != WHISPER_SR:
            from ezaudio_tpu_torch.audio.signal import _resample

            audio = _resample(audio[:, None, :], sr, WHISPER_SR)[:, 0]
        return torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)

    @torch.inference_mode()
    def features(self, audio, sr: Optional[int] = None) -> torch.Tensor:
        """Reference ``get_whisper_features``: (B, n_mels, 3000) log-mel on
        the device, 2 * max_source_positions frames."""
        feats = whisper_log_mel(self._to_16k(audio, sr), self.cfg.num_mel_bins)
        return feats[:, :, : 2 * self.cfg.max_source_positions]

    @torch.inference_mode()
    def embeddings(self, audio, sr: Optional[int] = None) -> torch.Tensor:
        """Reference ``get_whisper_embeddings``: the encoder's last hidden
        state (B, max_source_positions, d_model)."""
        return self.model.encode(self.features(audio, sr))

    def transcribe(self, audio, sr: Optional[int] = None,
                   prompt_ids: Optional[Tuple[int, ...]] = None,
                   max_new_tokens: Optional[int] = None):
        """Reference ``get_whisper_transcript``: greedy ids (text when a
        tokenizer is wired).  ``max_new_tokens`` defaults to 64, clamped to
        the model's target-position budget."""
        prompt = (tuple(prompt_ids) if prompt_ids is not None
                  else (self.cfg.decoder_start_token_id,))
        if max_new_tokens is None:
            max_new_tokens = min(64, self.cfg.max_target_positions - len(prompt))
        ids = greedy_decode(self.model, self.features(audio, sr), prompt,
                            max_new_tokens=max_new_tokens)
        if self.tokenizer is not None:
            return [self.tokenizer.decode(row) for row in ids]
        return ids

    # AudioSignal duck type (``get_whisper_transcript`` passes (wav, sr));
    # text when a tokenizer is wired, else ids
    def transcript(self, audio, sr: Optional[int] = None):
        out = self.transcribe(audio, sr)
        return out[0] if self.tokenizer is not None else out
