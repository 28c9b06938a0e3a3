"""DiT building blocks: attention, AdaLN-SOLA, DiTBlock, FinalBlock
(counterpart of ``ezaudio_tpu/models/blocks.py``).

Channel-last tokens (B, L, D); module and parameter names follow the
reference torch DiT (``attn.to_q``, ``adaln.lora_a``, ``skip_linear`` ...)
so reference state dicts load as they are.  The residual gates keep the
reference's ``x + (1 - gate) * f(x)``.

Attention (self and cross) goes through ``ops/kernels/attention.py``:
the hand-written CUDA kernel for CUDA tensors, its plain twin on the CPU;
inside ``attention_impl_context('bf16' | 'chunked_bf16')`` it is the
JAX package's bf16-logit einsum formulation in plain torch instead.
The linear layers are ``ops/quant.py::QuantLinear``: int8 inside
``quant_context('int8')``, float otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ezaudio_tpu_torch.ops.attention import (BF16_IMPLS, chunked_dot_product_attention,
                                             current_attention_impl, dot_product_attention)
from ezaudio_tpu_torch.ops.embeddings import unpatchify_1d
from ezaudio_tpu_torch.ops.convs import Conv1d
from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
from ezaudio_tpu_torch.ops.mlp import FeedForward, film_modulate
from ezaudio_tpu_torch.ops.norms import make_norm
from ezaudio_tpu_torch.ops.quant import QuantLinear
from ezaudio_tpu_torch.ops.rope import apply_rope, inv_freq, rope_tables


class RotaryEmbedding(nn.Module):
    """Holds the reference's persistent ``inv_freq`` buffer (rotary.py:41-43)
    and caches the (cos, sin) tables of every sequence length it meets."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.register_buffer("inv_freq", inv_freq(head_dim))
        self._cache = {}

    def cast_(self, dtype, cast=None):
        """``inv_freq`` stays f32: RoPE runs in f32 (``utils.cast_params_``)."""

    def tables(self, L: int):
        # every length stays cached: a captured CUDA graph reads its tables
        # in place, so a table must outlive the call that made it
        key = (L, self.inv_freq.device)
        if key not in self._cache:
            self._cache[key] = rope_tables(L, self.inv_freq.numel() * 2,
                                           freqs=self.inv_freq)
        return self._cache[key]


class Attention(nn.Module):
    """Self or cross attention: q/k/v projections, per-head q/k norm,
    RoPE ``shared`` (self-attention only), boolean key mask (True = attend)."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 qk_norm: Optional[str] = None, rope_mode: str = "none"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = qk_scale or self.head_dim ** -0.5
        ctx_dim = context_dim or dim
        self.to_q = QuantLinear(dim, dim, bias=qkv_bias)
        self.to_k = QuantLinear(ctx_dim, dim, bias=qkv_bias)
        self.to_v = QuantLinear(ctx_dim, dim, bias=qkv_bias)
        if qk_norm is not None:
            if qk_norm not in ("layernorm", "rmsnorm"):
                raise NotImplementedError(qk_norm)
            self.norm_q = make_norm(qk_norm, self.head_dim)
            self.norm_k = make_norm(qk_norm, self.head_dim)
        else:
            self.norm_q = self.norm_k = None
        if rope_mode not in ("none", "shared"):
            raise NotImplementedError(f"rope_mode={rope_mode!r}")
        self.rotary = RotaryEmbedding(self.head_dim) if rope_mode == "shared" else None
        self.proj = QuantLinear(dim, dim)

    def forward(self, x, context=None, context_mask=None):
        B, L, _ = x.shape
        ctx = x if context is None else context
        Lk = ctx.shape[1]
        H, Dh = self.num_heads, self.head_dim
        q = self.to_q(x).view(B, L, H, Dh).transpose(1, 2)
        k = self.to_k(ctx).view(B, Lk, H, Dh).transpose(1, 2)
        v = self.to_v(ctx).view(B, Lk, H, Dh).transpose(1, 2)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        if self.rotary is not None:  # self-attention only (cross passes rope "none")
            cos, sin = self.rotary.tables(L)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        impl = current_attention_impl()
        if impl in BF16_IMPLS:
            mask = None if context_mask is None else context_mask.bool()[:, None, None, :]
            fn = chunked_dot_product_attention if impl == "chunked_bf16" else dot_product_attention
            out = fn(q, k, v, mask=mask, scale=self.scale, softmax_dtype=torch.bfloat16)
        else:
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_mask=context_mask, scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, L, H * Dh))


class AdaLN(nn.Module):
    """AdaLN-SOLA modulation head: shared ``time_ada`` + rank-r LoRA delta
    ``lora_b(lora_a(time_token)) * alpha / r`` (+ the (6, dim) table for
    ``ada_sola_bias``).  Returns (B, 6, dim) laid out as
    [shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp]."""

    def __init__(self, dim: int, ada_mode: str, r: int, alpha: float):
        super().__init__()
        if ada_mode not in ("ada_sola", "ada_sola_bias"):
            raise NotImplementedError(f"time_fusion={ada_mode!r}")
        self.dim = dim
        self.scaling = alpha / r
        self.lora_a = QuantLinear(dim, r * 6, bias=False)
        self.lora_b = QuantLinear(r * 6, dim * 6, bias=False)
        self.scale_shift_table = (nn.Parameter(torch.zeros(6, dim))
                                  if ada_mode == "ada_sola_bias" else None)

    def forward(self, time_token, time_ada):
        out = time_ada + self.lora_b(self.lora_a(time_token)) * self.scaling
        out = out.reshape(-1, 6, self.dim)
        if self.scale_shift_table is not None:
            out = out + self.scale_shift_table[None]
        return out


class DiTBlock(nn.Module):
    """Pre-LN DiT block with AdaLN FiLM, ``(1 - gate)`` residuals, optional
    long-skip fusion (``skip_linear(skip_norm(cat[x, skip]))``) and
    cross-attention to the text context."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, qk_norm: Optional[str] = None,
                 act_layer: str = "geglu", norm_layer: str = "layernorm",
                 time_fusion: str = "ada_sola_bias", ada_sola_rank: int = 32,
                 ada_sola_alpha: float = 32, skip: bool = False,
                 skip_norm: bool = False, rope_mode: str = "none",
                 context_norm: bool = False):
        super().__init__()
        self.skip_linear = QuantLinear(2 * dim, dim) if skip else None
        self.skip_norm = make_norm(norm_layer, 2 * dim) if (skip and skip_norm) else None
        self.adaln = AdaLN(dim, time_fusion, ada_sola_rank, ada_sola_alpha)
        self.norm1 = make_norm(norm_layer, dim)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale,
                              qk_norm=qk_norm, rope_mode=rope_mode)
        self.cross = context_dim is not None
        if self.cross:
            self.norm2 = make_norm(norm_layer, dim)
            self.norm_context = make_norm(norm_layer, context_dim) if context_norm else None
            self.cross_attn = Attention(dim, num_heads, context_dim=context_dim,
                                        qkv_bias=qkv_bias, qk_scale=qk_scale,
                                        qk_norm=qk_norm)
        self.norm3 = make_norm(norm_layer, dim)
        self.mlp = FeedForward(dim, mlp_ratio, act_layer)

    def forward(self, x, time_token, time_ada, skip=None, context=None,
                x_mask=None, context_mask=None):
        if self.skip_linear is not None:
            cat = torch.cat([x, skip], dim=-1)
            if self.skip_norm is not None:
                cat = self.skip_norm(cat)
            x = self.skip_linear(cat)
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaln(time_token, time_ada).chunk(6, dim=1)

        h = film_modulate(self.norm1(x), shift=shift_msa, scale=scale_msa)
        x = x + (1 - gate_msa) * self.attn(h, context_mask=x_mask)

        if self.cross:
            ctx = self.norm_context(context) if self.norm_context is not None else context
            x = x + self.cross_attn(self.norm2(x), context=ctx, context_mask=context_mask)

        h = film_modulate(self.norm3(x), shift=shift_mlp, scale=scale_mlp)
        return x + (1 - gate_mlp) * self.mlp(h)


class FinalBlock(nn.Module):
    """AdaLN-modulated norm, linear to the patch dim, unpatchify, width-3
    output conv (reference blocks.py:163-211, 1d)."""

    def __init__(self, embed_dim: int, patch_size: int, out_chans: int,
                 norm_layer: str = "layernorm", use_conv: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.out_chans = out_chans
        self.norm = make_norm(norm_layer, embed_dim)
        self.linear = QuantLinear(embed_dim, patch_size * out_chans)
        self.final_layer = (Conv1d(out_chans, out_chans, 3, padding=1)
                            if use_conv else None)

    def forward(self, x, time_ada):
        shift, scale = time_ada.reshape(x.shape[0], 2, self.embed_dim).chunk(2, dim=1)
        h = film_modulate(self.norm(x), shift, scale)
        h = unpatchify_1d(self.linear(h), self.out_chans)
        if self.final_layer is not None:
            h = self.final_layer(h.transpose(1, 2)).transpose(1, 2)
        return h
