"""T5 encoder (FLAN-T5 class) in plain PyTorch — the text conditioning tower.

Counterpart of ``ezaudio_tpu/text/t5.py::T5Encoder``:

  * T5LayerNorm: RMS (no mean subtraction, no bias), computed in float32;
  * relative position bias: bidirectional buckets, computed once in layer 0
    and shared by every layer;
  * attention WITHOUT 1/sqrt(d) scaling (folded into the init, per T5);
  * gated-GELU feed forward (``gelu_tanh(wi_0 x) * wi_1 x``) for FLAN-T5;
  * no biases anywhere; final RMS layer norm.

Module names follow the HF ``T5EncoderModel`` encoder stack
(``block.{i}.layer.0.SelfAttention.q`` ...), so an HF state dict loads
through :func:`t5_state_dict_from_hf` with no renaming beyond the prefix.
T5 runs once per prompt; its attention is a plain ``torch.matmul``.  In a
bf16 model (``utils.cast_params_``) its scores, position bias and softmax
stay f32 and P.V accumulates in f32, as the JAX encoder computes them;
the relative position bias table keeps its f32 values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from ezaudio_tpu_torch.ops.activations import gelu_tanh
from ezaudio_tpu_torch.utils import cast_params_


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # FLAN-T5; the only one ported

    @classmethod
    def flan_t5_large(cls):
        return cls(d_model=1024, d_kv=64, d_ff=2816, num_layers=24, num_heads=16)

    @classmethod
    def flan_t5_xl(cls):
        return cls(d_model=2048, d_kv=64, d_ff=5120, num_layers=24, num_heads=32)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight.to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32, max_distance: int = 128):
    """Bidirectional T5 bucketing (HF modeling_t5._relative_position_bucket)."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rp = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    rp_large = max_exact + (
        torch.log(rp.float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.long)
    rp_large = torch.clamp(rp_large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rp, rp_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def cast_(self, dtype, cast=None):
        """Cast the projections; the position bias table stays f32."""
        for m in (self.q, self.k, self.v, self.o):
            cast_params_(m, dtype, cast)

    def position_bias(self, L: int, device) -> torch.Tensor:
        c = self.cfg
        pos = torch.arange(L, device=device)
        rel = pos[None, :] - pos[:, None]  # memory - context
        buckets = relative_position_bucket(
            rel, c.relative_attention_num_buckets,
            c.relative_attention_max_distance)
        return self.relative_attention_bias.weight[buckets].permute(2, 0, 1)[None]

    def forward(self, x, mask_bias, position_bias):
        c = self.cfg
        B, L, _ = x.shape

        def heads(t):
            return t.view(B, L, c.num_heads, c.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if position_bias is None:
            position_bias = self.position_bias(L, x.device)
        # T5: NO 1/sqrt(d) scaling
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores + position_bias.float() + mask_bias
        weights = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(weights.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, L, -1)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, mask_bias, position_bias):
        h, position_bias = self.SelfAttention(self.layer_norm(x), mask_bias,
                                              position_bias)
        return x + h, position_bias


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(gelu_tanh(self.wi_0(x)) * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        if cfg.feed_forward_proj != "gated-gelu":
            raise NotImplementedError(f"feed_forward_proj={cfg.feed_forward_proj!r}")
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, mask_bias, position_bias):
        x, position_bias = self.layer[0](x, mask_bias, position_bias)
        return self.layer[1](x), position_bias


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.block = nn.ModuleList(
            [T5Block(cfg, has_relative_bias=(i == 0)) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask=None):
        """input_ids (B, L) int; attention_mask (B, L) bool/int.
        Returns last_hidden_state (B, L, d_model)."""
        x = self.embed_tokens(input_ids.long())
        if attention_mask is None:
            mask_bias = torch.zeros((1, 1, 1, x.shape[1]), device=x.device)
        else:
            neg = torch.finfo(torch.float32).min
            mask_bias = torch.where(
                attention_mask.bool()[:, None, None, :],
                torch.zeros((), device=x.device), torch.full((), neg, device=x.device))
        position_bias = None
        for blk in self.block:
            x, position_bias = blk(x, mask_bias, position_bias)
        return self.final_layer_norm(x)


def t5_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF ``T5EncoderModel`` state dict -> :class:`T5Encoder` state dict:
    drops the ``encoder.`` prefix and takes the embedding from
    ``shared.weight`` (or ``encoder.embed_tokens.weight``)."""
    out = {}
    for k, v in sd.items():
        if k == "shared.weight":
            out["embed_tokens.weight"] = v
        elif k.startswith("encoder."):
            out.setdefault(k[len("encoder."):], v)
    return out
