"""HuBERT encoder — the ContentVec feature tower of the voice-conversion
conditioner (counterpart of ``ezaudio_tpu/models/hubert.py``).

The reference's ``HubertModelWithFinalProj`` is transformers' HubertModel
plus a ``final_proj`` kept for checkpoint compatibility; the extractor
returns ``last_hidden_state`` and never uses the projection.  This module:

  * the conv feature encoder (x320 downsample): GroupNorm with one group
    per channel after the first conv (``feat_extract_norm='group'``, base)
    or LayerNorm after every conv (``'layer'``, large), erf GELU;
  * the feature projection (LayerNorm, Linear);
  * the positional conv embedding (128 taps, 16 groups, the trailing
    column dropped for an even kernel), its weight norm folded at load;
  * post-LN encoder blocks (``do_stable_layer_norm=False``) or pre-LN ones
    with a final LayerNorm (True); ``attention_mask`` masks the frames whose
    last sample is padding;
  * :class:`VoiceConversionExtractor`: the reference's recipe around it
    (16 kHz on the host, a symmetric 40-sample pad, ``last_hidden_state``).

Module and parameter names are those of ``transformers.HubertModel``'s
state dict: :func:`hubert_state_dict_from_hf` strips a ``hubert.`` prefix,
folds the weight norm (``weight_g``/``weight_v`` or
``parametrizations.weight.original0/1``) and drops ``IGNORED_HF_KEYS``; the
rest loads strictly.  Attention is a plain torch matmul with its logits
and softmax in f32.  In a bf16 model (``utils.cast_params_``) the norms
keep f32 and the convolutions sum in f32 (``ops/convs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict
from ezaudio_tpu_torch.data.audio_io import resample
from ezaudio_tpu_torch.ops.convs import Conv1d
from ezaudio_tpu_torch.ops.norms import LayerNorm
from ezaudio_tpu_torch.utils import cast_params_, init_seeded_, resolve_device


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"   # "group" (base) | "layer" (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    classifier_proj_size: int = 256

    @classmethod
    def from_hf_config(cls, hf) -> "HubertConfig":
        kw = {f.name: getattr(hf, f.name) for f in dataclasses.fields(cls)}
        for k in ("conv_dim", "conv_kernel", "conv_stride"):
            kw[k] = tuple(kw[k])
        return cls(**kw)


class ChannelNorm(nn.Module):
    """GroupNorm with one group per channel over (B, C, T): each channel
    normalized over time, in f32 (``cast_`` keeps its weights f32)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        y = F.group_norm(x.float(), x.shape[1], self.weight, self.bias, self.eps)
        return y.to(x.dtype)

    def cast_(self, dtype):
        """Weight and bias stay f32 (``utils.cast_params_``)."""


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, cfg: HubertConfig, first: bool):
        super().__init__()
        self.conv = Conv1d(c_in, c_out, k, stride=s, bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = LayerNorm(c_out, cfg.layer_norm_eps)
        elif cfg.feat_extract_norm == "group" and first:
            self.layer_norm = ChannelNorm(c_out, cfg.layer_norm_eps)
        else:
            self.layer_norm = None

    def forward(self, x):  # (B, C, T)
        x = self.conv(x)
        if isinstance(self.layer_norm, LayerNorm):
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, cfg, i == 0)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, audio):  # (B, T) -> (B, T', conv_dim[-1])
        x = audio[:, None, :].to(self.conv_layers[0].conv.weight.dtype)
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0  # SamePadLayer

    def forward(self, x):  # (B, L, D)
        y = self.conv(x.transpose(1, 2))
        if self.drop_last:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x, mask_bias=None):
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        q = (self.q_proj(x) * hd ** -0.5).reshape(B, L, H, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, L, H, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, L, H, hd).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)).float()
        if mask_bias is not None:
            logits = logits + mask_bias
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, L, D))


class _FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    """Post-LN (attention -> residual -> LN, FF -> residual -> LN) or, with
    ``do_stable_layer_norm``, pre-LN (LN -> attention -> residual,
    LN -> FF -> residual)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = _Attention(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask_bias=None):
        if self.stable:
            x = x + self.attention(self.layer_norm(x), mask_bias)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, mask_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


def feature_vector_mask(cfg: HubertConfig, attention_mask: torch.Tensor,
                        n_frames: int) -> torch.Tensor:
    """(B, T) sample mask -> (B, n_frames) frame mask: a frame is valid when
    the conv stack's output length over the valid samples covers it."""
    lengths = attention_mask.long().sum(-1)
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return torch.arange(n_frames, device=lengths.device)[None, :] < lengths[:, None]


class HubertEncoder(nn.Module):
    """HubertModel's ``last_hidden_state``: ``audio`` (B, T) at 16 kHz and an
    optional (B, T) sample mask -> (B, frames, hidden_size)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, audio: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        cfg, enc = self.cfg, self.encoder
        x = self.feature_projection(self.feature_extractor(audio))
        mask_bias = None
        if attention_mask is not None:
            frames = feature_vector_mask(cfg, attention_mask, x.shape[1])
            x = torch.where(frames[..., None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
            mask_bias = torch.where(frames, 0.0, -1e9)[:, None, None, :]
        x = x + enc.pos_conv_embed(x)
        if not cfg.do_stable_layer_norm:
            x = enc.layer_norm(x)
        for layer in enc.layers:
            x = layer(x, mask_bias)
        if cfg.do_stable_layer_norm:
            x = enc.layer_norm(x)
        return x


@torch.no_grad()
def init_hubert_(model: HubertEncoder, generator: torch.Generator) -> HubertEncoder:
    """Seeded random weights (``utils.init_seeded_``): no weight left at
    zero or one (ROADMAP F6)."""
    return init_seeded_(model, generator, (LayerNorm, ChannelNorm))


# ---------------------------------------------------------------------------
# transformers HubertModel state dict -> the port's
# ---------------------------------------------------------------------------

# checkpoint-compatibility entries the extractor never reads (the JAX
# converter ignores them)
IGNORED_HF_KEYS = ("masked_spec_embed", "final_proj.weight", "final_proj.bias")
_POS_CONV = "encoder.pos_conv_embed.conv"


def hubert_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers ``HubertModel`` (or ``HubertModelWithFinalProj``)
    state dict -> what :class:`HubertEncoder` loads strictly: a ``hubert.``
    prefix stripped, ``IGNORED_HF_KEYS`` dropped, the positional conv's
    weight norm (over the kernel axis, ``dim=2``) folded into ``weight``.
    Every other key is kept, so a strict load names any key that is missing
    or extra."""
    if any(k.startswith("hubert.") for k in sd):
        sd = {k[len("hubert."):] if k.startswith("hubert.") else k: v for k, v in sd.items()}
    out = {k: v for k, v in sd.items() if k not in IGNORED_HF_KEYS}
    for g_key, v_key in (("weight_g", "weight_v"), ("parametrizations.weight.original0",
                                                    "parametrizations.weight.original1")):
        if f"{_POS_CONV}.{g_key}" in out:
            g = torch.as_tensor(out.pop(f"{_POS_CONV}.{g_key}")).float()
            v = torch.as_tensor(out.pop(f"{_POS_CONV}.{v_key}")).float()
            norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
            out[f"{_POS_CONV}.weight"] = g * v / norm.clamp_min(1e-12)
    return out


# ---------------------------------------------------------------------------
# The voice-conversion extractor (reference voice.py:19-36)
# ---------------------------------------------------------------------------

class VoiceConversionExtractor:
    """ContentVec/HuBERT content features of a waveform: (T,), (B, T) or
    (B, C, T) (downmixed to mono) at ``sr`` -> ``last_hidden_state``
    (B, frames, hidden_size) at 50 Hz, on ``device``.

    As the reference: resampled to 16 kHz (on the host, as the JAX package
    does), padded by (400 - 320) // 2 = 40 samples on each side (the conv
    receptive field aligned as fairseq does), then the encoder.
    ``weights``: a transformers-format state dict (e.g. ``torch.load`` of a
    local ContentVec checkpoint), or None for seeded random weights.  Runs
    on CUDA unless ``device="cpu"``.
    """

    target_sr = 16000

    def __init__(self, sr: int, cfg: Optional[HubertConfig] = None,
                 weights: Optional[Dict[str, torch.Tensor]] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        self.sr = sr
        self.cfg = cfg or HubertConfig()
        self.device = resolve_device(device)
        with torch.device(self.device):
            model = HubertEncoder(self.cfg)
        if weights is not None:
            load_state_dict_strict(model, hubert_state_dict_from_hf(weights), "HuBERT weights")
        else:
            init_hubert_(model, torch.Generator(device=self.device).manual_seed(0))
        self.model = cast_params_(model, dtype).eval().requires_grad_(False)

    @torch.inference_mode()
    def __call__(self, audio) -> torch.Tensor:
        audio = torch.as_tensor(audio).float()
        if audio.ndim == 1:
            audio = audio[None]
        if audio.ndim == 3:
            audio = audio.mean(dim=1)
        if self.sr != self.target_sr:
            audio = torch.from_numpy(resample(audio.cpu().numpy(), self.sr, self.target_sr))
        pad = (400 - 320) // 2
        return self.model(F.pad(audio.to(self.device), (pad, pad)))
