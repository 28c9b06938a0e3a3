"""CLAP — contrastive language-audio embeddings (counterpart of
``ezaudio_tpu/models/clap.py``), the LAION-CLAP architecture of
``laion/clap-htsat-unfused``:

  * audio tower, HTSAT: frozen BatchNorm over the mel bins, the
    align-corners bicubic time stretch to ``spec_size * freq_ratio`` frames,
    the mel -> square image fold, a conv patch embedding with LayerNorm,
    Swin stages (window attention with a learned relative-position bias,
    shifted windows with a -100 mask, 2x2 patch merging), LayerNorm and the
    token mean;
  * text tower, RoBERTa: post-LN blocks, position ids counted over the
    non-pad tokens and offset by the pad id, a tanh CLS pooler;
  * two-layer projections into the shared space and both logit scales.

Module and parameter names are those of ``transformers.ClapModel``'s state
dict, so a local checkpoint loads with a strict ``load_state_dict`` after
:func:`clap_state_dict_from_hf` drops the buffers that
``convert_clap_state_dict`` of the JAX package ignores (``IGNORED_HF_KEYS``).
The window partition, the bias gather index, the shift mask and the
bicubic matrix are host constants, as in the JAX package.  Attention is a
plain torch matmul with its scores, bias, mask and softmax in f32.  In a
bf16 model (``utils.cast_params_``) the BatchNorm, the norms and the logit
scales keep f32; the convolution sums in f32 (``ops/convs.py``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.ops.convs import Conv2d
from ezaudio_tpu_torch.ops.norms import LayerNorm
from ezaudio_tpu_torch.utils import cast_params_, init_seeded_


# ---------------------------------------------------------------------------
# Configs (transformers' ClapTextConfig / ClapAudioConfig fields)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClapTextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12
    projection_dim: int = 512

    @classmethod
    def from_hf_config(cls, hf) -> "ClapTextConfig":
        return cls(**{f.name: getattr(hf, f.name) for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class ClapAudioConfig:
    spec_size: int = 256
    num_mel_bins: int = 64
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    patch_embeds_hidden_size: int = 96
    window_size: int = 8
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_attention_heads: Tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    hidden_size: int = 768          # = patch_embeds_hidden_size * 2**(n-1)
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    flatten_patch_embeds: bool = True
    enable_patch_layer_norm: bool = True

    @classmethod
    def from_hf_config(cls, hf) -> "ClapAudioConfig":
        kw = {f.name: getattr(hf, f.name) for f in dataclasses.fields(cls)}
        for k in ("patch_stride", "depths", "num_attention_heads"):
            kw[k] = tuple(kw[k])
        return cls(**kw)

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.spec_size // self.patch_stride[0], self.spec_size // self.patch_stride[1])


@dataclasses.dataclass(frozen=True)
class ClapConfig:
    text: ClapTextConfig = ClapTextConfig()
    audio: ClapAudioConfig = ClapAudioConfig()
    projection_dim: int = 512
    logit_scale_init: float = math.log(100 / 7)

    @classmethod
    def from_hf_config(cls, hf) -> "ClapConfig":
        return cls(text=ClapTextConfig.from_hf_config(hf.text_config),
                   audio=ClapAudioConfig.from_hf_config(hf.audio_config),
                   projection_dim=hf.projection_dim,
                   logit_scale_init=math.log(hf.logit_scale_init_value))


# ---------------------------------------------------------------------------
# Host constants
# ---------------------------------------------------------------------------

def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (torch bicubic's A = -0.75) at |t| <= 2."""
    t = np.abs(t)
    return np.where(t <= 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                    np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0))


def bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix of ``F.interpolate(mode='bicubic',
    align_corners=True)`` along one axis (edge taps clamped); the identity
    when src == dst."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    x = np.arange(dst) * (src - 1) / (dst - 1)
    x0 = np.floor(x).astype(np.int64)
    t = x - x0
    mat = np.zeros((dst, src), np.float64)
    for off, dist in ((-1, t + 1.0), (0, t), (1, 1.0 - t), (2, 2.0 - t)):
        idx = np.clip(x0 + off, 0, src - 1)
        np.add.at(mat, (np.arange(dst), idx), _cubic_kernel(dist))
    return mat.astype(np.float32)


def swin_relative_index(window: int) -> np.ndarray:
    """(w*w, w*w) gather index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def swin_shift_mask(height: int, width: int, window: int,
                    shift: int) -> Optional[np.ndarray]:
    """(num_windows, w*w, w*w) additive mask (0 / -100) of shifted-window
    attention, or None when shift == 0."""
    if shift == 0:
        return None
    img = np.zeros((height, width), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(height // window, window, width // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    """(B*nW, w*w, C) -> (B, H, W, C)."""
    C = x.shape[-1]
    x = x.reshape(-1, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


def _attend(q, k, v, bias, window_mask=None):
    """softmax(q kᵀ / sqrt(d) + bias) v over (B, h, N, d), the scores, bias
    and softmax in f32, the products in the inputs' dtype.  A
    ``window_mask`` (nW, N, N) is added window by window (B = batch * nW)."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    scores = scores.float() + bias
    if window_mask is not None:
        B, h, N, _ = scores.shape
        nW = window_mask.shape[0]
        scores = (scores.reshape(B // nW, nW, h, N, N)
                  + window_mask[:, None].float()).reshape(B, h, N, N)
    return torch.softmax(scores, dim=-1).to(v.dtype) @ v


# ---------------------------------------------------------------------------
# Audio tower (HTSAT Swin)
# ---------------------------------------------------------------------------

class _Dense(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim_out)


class _SelfAttention(nn.Module):
    """Query, key and value, and the relative-position-bias table."""

    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool):
        super().__init__()
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=qkv_bias)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        # torch.tensor, not from_numpy: the buffer follows the device the
        # model is built on
        self.register_buffer("relative_index", torch.tensor(
            swin_relative_index(window).reshape(-1)), persistent=False)


class SwinWindowAttention(nn.Module):
    """Windowed multi-head attention with the relative-position bias
    (HF ``ClapAudioAttention``: ``self`` and ``output.dense``)."""

    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.self = _SelfAttention(dim, num_heads, window, qkv_bias)
        self.output = _Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        nB, N, C = x.shape          # nB = batch * windows, N = window ** 2
        h, s = self.num_heads, self.self
        q, k, v = (m(x).reshape(nB, N, h, C // h).transpose(1, 2)
                   for m in (s.query, s.key, s.value))
        bias = s.relative_position_bias_table[s.relative_index].reshape(N, N, h)
        out = _attend(q, k, v, bias.permute(2, 0, 1).float(), mask)
        return self.output.dense(out.transpose(1, 2).reshape(nB, N, C))


class SwinBlock(nn.Module):
    """LN -> (shifted-)window attention -> residual -> LN -> MLP -> residual
    (HF ``ClapAudioLayer``)."""

    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int],
                 window_size: int, shift_size: int, mlp_ratio: float,
                 qkv_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        H, W = resolution
        # a window that does not fit shrinks to the resolution, and the shift goes
        window, shift = window_size, shift_size
        if min(H, W) <= window:
            window, shift = min(H, W), 0
        self.resolution, self.window, self.shift = resolution, window, shift
        self.pad = ((window - H % window) % window, (window - W % window) % window)
        mask = swin_shift_mask(H + self.pad[0], W + self.pad[1], window, shift)
        self.register_buffer("shift_mask", None if mask is None else torch.tensor(mask),
                             persistent=False)
        self.layernorm_before = LayerNorm(dim, eps)
        self.attention = SwinWindowAttention(dim, num_heads, window, qkv_bias)
        self.layernorm_after = LayerNorm(dim, eps)
        self.intermediate = _Dense(dim, int(mlp_ratio * dim))
        self.output = _Dense(int(mlp_ratio * dim), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (H, W), w, shift = self.resolution, self.window, self.shift
        B, N, C = x.shape
        y = self.layernorm_before(x).reshape(B, H, W, C)
        if any(self.pad):
            y = F.pad(y, (0, 0, 0, self.pad[1], 0, self.pad[0]))
        Hp, Wp = H + self.pad[0], W + self.pad[1]
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = self.attention(window_partition(y, w), self.shift_mask)
        y = window_reverse(y, w, Hp, Wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :H, :W].reshape(B, N, C)
        y = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(y)


class PatchMerging(nn.Module):
    """2x2 merging: four strided slices, LN(4C), Linear(4C -> 2C, no bias)
    (HF ``ClapAudioPatchMerging``)."""

    def __init__(self, dim: int, resolution: Tuple[int, int], eps: float = 1e-5):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim, eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over the last axis, in f32 (``cast_`` keeps its
    weights and statistics f32, as the JAX package computes it)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        x = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return x * self.weight + self.bias

    def cast_(self, dtype):
        """Everything stays f32 (``utils.cast_params_``)."""


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        self.proj = Conv2d(1, cfg.patch_embeds_hidden_size, cfg.patch_size,
                           stride=cfg.patch_stride)
        if cfg.enable_patch_layer_norm:
            self.norm = LayerNorm(cfg.patch_embeds_hidden_size)


class ClapAudioTower(nn.Module):
    """HTSAT (HF ``ClapAudioEncoder``): ``input_features`` (B, 1, T, mel)
    log-mel with T <= spec_size * freq_ratio -> (framewise (B, tokens,
    hidden), pooled (B, hidden))."""

    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        self.cfg = cfg
        self.batch_norm = FrozenBatchNorm(cfg.num_mel_bins)
        self.patch_embed = _PatchEmbed(cfg)
        gh, gw = cfg.grid_size
        n = len(cfg.depths)
        self.layers = nn.ModuleList()
        for i in range(n):
            dim, res = cfg.patch_embeds_hidden_size * 2 ** i, (gh // 2 ** i, gw // 2 ** i)
            blocks = [SwinBlock(dim, cfg.num_attention_heads[i], res, cfg.window_size,
                                0 if j % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio,
                                cfg.qkv_bias, cfg.layer_norm_eps)
                      for j in range(cfg.depths[i])]
            down = PatchMerging(dim, res, cfg.layer_norm_eps) if i < n - 1 else None
            self.layers.append(_Stage(blocks, down))
        self.norm = LayerNorm(cfg.patch_embeds_hidden_size * 2 ** (n - 1), cfg.layer_norm_eps)

    def forward(self, input_features: torch.Tensor):
        cfg = self.cfg
        B, _, T, Fm = input_features.shape
        x = self.batch_norm(input_features)
        # reshape_mel2img: stretch time to spec_size * freq_ratio (bicubic,
        # align corners), then fold freq_ratio time chunks into frequency
        r = cfg.freq_ratio
        spec_w, spec_h = cfg.spec_size * r, cfg.spec_size // r
        if T > spec_w or Fm > spec_h:
            raise ValueError(f"mel input ({T}x{Fm}) exceeds swin input ({spec_w}x{spec_h})")
        if T < spec_w:
            x = torch.einsum("st,bctf->bcsf", torch.from_numpy(
                bicubic_matrix(T, spec_w)).to(x), x)
        if Fm < spec_h:
            x = torch.einsum("sf,bctf->bcts", torch.from_numpy(
                bicubic_matrix(Fm, spec_h)).to(x), x)
        x = x.reshape(B, r, spec_w // r, spec_h).transpose(2, 3).reshape(
            B, 1, spec_h * r, spec_w // r)
        pe = self.patch_embed
        x = pe.proj(x.to(pe.proj.weight.dtype)).flatten(2).transpose(1, 2)
        if cfg.enable_patch_layer_norm:
            x = pe.norm(x)
        for stage in self.layers:
            x = stage(x)
        x = self.norm(x)
        # HF's AdaptiveAvgPool1d averages every spatial position: a token mean
        return x, x.mean(dim=1)


class _AudioModel(nn.Module):
    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        self.audio_encoder = ClapAudioTower(cfg)


# ---------------------------------------------------------------------------
# Text tower (RoBERTa)
# ---------------------------------------------------------------------------

class _Embeddings(nn.Module):
    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class _DenseNorm(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim_out)
        self.LayerNorm = LayerNorm(dim_out, eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class _TextSelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)


class _TextAttention(nn.Module):
    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.self = _TextSelfAttention(cfg.hidden_size)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)


class _TextLayer(nn.Module):
    """Post-LN BERT block (HF ``ClapTextLayer``)."""

    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.attention = _TextAttention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, addmask):
        B, L, C = x.shape
        s = self.attention.self
        q, k, v = (m(x).reshape(B, L, self.num_heads, -1).transpose(1, 2)
                   for m in (s.query, s.key, s.value))
        attn = _attend(q, k, v, addmask).transpose(1, 2).reshape(B, L, C)
        x = self.attention.output(attn, x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.layer = nn.ModuleList(_TextLayer(cfg) for _ in range(cfg.num_hidden_layers))


class _Pooler(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim, dim)


class ClapTextTower(nn.Module):
    """RoBERTa encoder + tanh CLS pooler (HF ``ClapTextModel``):
    ``input_ids`` (B, L), ``attention_mask`` (B, L) of 0/1 ->
    (last_hidden_state, pooled)."""

    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _TextEncoder(cfg)
        self.pooler = _Pooler(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        cfg, emb = self.cfg, self.embeddings
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = attention_mask.long()
        # RoBERTa positions count the non-pad tokens from pad_id + 1; pads
        # keep position pad_id
        pos = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        x = emb.word_embeddings(input_ids) + emb.position_embeddings(pos)
        x = emb.LayerNorm(x + emb.token_type_embeddings(torch.zeros_like(input_ids)))
        addmask = (1.0 - mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
        for layer in self.encoder.layer:
            x = layer(x, addmask)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


class ClapProjection(nn.Module):
    """Linear -> ReLU -> Linear into the shared space (HF ``ClapProjectionLayer``)."""

    def __init__(self, dim_in: int, projection_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(dim_in, projection_dim)
        self.linear2 = nn.Linear(projection_dim, projection_dim)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


# ---------------------------------------------------------------------------
# The combined model
# ---------------------------------------------------------------------------

def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLAP(nn.Module):
    """Both towers, the projections and the logit scales.  Called with
    either modality or both; returns the l2-normalized ``audio_embeds`` /
    ``text_embeds`` and, with both, ``logits_per_audio`` and
    ``logits_per_text``."""

    def __init__(self, cfg: ClapConfig):
        super().__init__()
        self.cfg = cfg
        self.logit_scale_a = nn.Parameter(torch.tensor(cfg.logit_scale_init))
        self.logit_scale_t = nn.Parameter(torch.tensor(cfg.logit_scale_init))
        self.text_model = ClapTextTower(cfg.text)
        self.text_projection = ClapProjection(cfg.text.hidden_size, cfg.projection_dim)
        self.audio_model = _AudioModel(cfg.audio)
        self.audio_projection = ClapProjection(cfg.audio.hidden_size, cfg.projection_dim)

    def forward(self, input_features=None, input_ids=None,
                attention_mask=None) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if input_features is not None:
            _, pooled = self.audio_model.audio_encoder(input_features)
            out["audio_embeds"] = _unit(self.audio_projection(pooled))
        if input_ids is not None:
            _, pooled = self.text_model(input_ids, attention_mask)
            out["text_embeds"] = _unit(self.text_projection(pooled))
        if len(out) == 2:
            sim = (out["audio_embeds"] @ out["text_embeds"].T).float()
            out["logits_per_audio"] = self.logit_scale_a.exp() * sim
            out["logits_per_text"] = self.logit_scale_t.exp() * sim.T
        return out

    def cast_(self, dtype):
        """The logit scales stay f32; the towers cast (``utils.cast_params_``)."""
        for child in self.children():
            cast_params_(child, dtype)


@torch.no_grad()
def init_clap_(model: CLAP, generator: torch.Generator) -> CLAP:
    """Seeded random weights (``utils.init_seeded_``), with the BatchNorm
    statistics drawn too (mean N(0, 1), variance U(0.5, 1.5)) and the
    relative-position tables at N(0, 0.5): no weight sits at a value that
    hides a wrong gather or axis (ROADMAP F6).  The logit scales keep their
    initial value."""
    init_seeded_(model, generator, (LayerNorm, FrozenBatchNorm))
    bn = model.audio_model.audio_encoder.batch_norm
    bn.running_mean.normal_(0.0, 1.0, generator=generator)
    bn.running_var.uniform_(0.5, 1.5, generator=generator)
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            p.normal_(0.0, 0.5, generator=generator)
        elif name.startswith("logit_scale"):
            p.fill_(model.cfg.logit_scale_init)
    return model


# ---------------------------------------------------------------------------
# transformers ClapModel state dict -> the port's
# ---------------------------------------------------------------------------

# buffers of the transformers checkpoint that the model recomputes (the JAX
# converter reads none of them)
IGNORED_HF_KEYS = (
    r"text_model\.embeddings\.position_ids",
    r"text_model\.embeddings\.token_type_ids",
    r"audio_model\.audio_encoder\.batch_norm\.num_batches_tracked",
    r"audio_model\.audio_encoder\.layers\.\d+\.blocks\.\d+\.attention\.self\."
    r"relative_position_index",
)
_IGNORED = re.compile("|".join(f"(?:{p})" for p in IGNORED_HF_KEYS))


def clap_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``transformers.ClapModel.state_dict()`` (or a ``torch.load`` of the
    published checkpoint) without the keys in ``IGNORED_HF_KEYS``: what
    :class:`CLAP` loads strictly.  Every other key is kept, so a strict
    load names any key that is missing or extra."""
    return {k: v for k, v in sd.items() if not _IGNORED.fullmatch(k)}
