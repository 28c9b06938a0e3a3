"""DiT building blocks: attention (every RoPE mode), AdaLN (every mode),
DiTBlock (AdaLN or time token), FinalBlock (1d or 2d)
(counterpart of ``ezaudio_tpu/models/blocks.py``).

Channel-last tokens (B, L, D); module and parameter names follow the
reference torch DiT (``attn.to_q``, ``adaln.lora_a``, ``skip_linear`` ...)
so reference state dicts load as they are.  The residual gates keep the
reference's ``x + (1 - gate) * f(x)``.

Attention (self and cross) goes through ``ops/kernels/attention.py``:
the hand-written CUDA kernel for CUDA tensors, its plain twin on the CPU;
inside ``attention_impl_context('bf16' | 'chunked_bf16')`` it is the
JAX package's bf16-logit einsum formulation in plain torch instead.
Self-attention runs the sequence-parallel ring
(``parallel/ring_attention.py``) under ``'ring'``, or under ``'auto'``
inside a ``ring_context`` whose mesh has sp > 1; cross-attention stays on
the kernel.  The heads are read from the projections' width, so a
tensor-parallel shard (``parallel/sharding.py``) runs H/tp of them.
The linear layers are ``ops/quant.py::QuantLinear``: int8 inside
``quant_context('int8')``, float otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ezaudio_tpu_torch.ops.attention import (BF16_IMPLS, chunked_dot_product_attention,
                                             current_attention_impl, dot_product_attention)
from ezaudio_tpu_torch.ops.convs import Conv1d, Conv2d
from ezaudio_tpu_torch.ops.embeddings import unpatchify_1d, unpatchify_2d
from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
from ezaudio_tpu_torch.ops.mlp import FeedForward, film_modulate
from ezaudio_tpu_torch.ops.norms import make_norm
from ezaudio_tpu_torch.ops.quant import QuantLinear
from ezaudio_tpu_torch.ops.rope import apply_rope, apply_rope_skip_prefix, inv_freq, rope_tables


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


ROPE_MODES = ("none", "shared", "x_only", "dual")
ADA_MODES = ("ada", "ada_single", "ada_sola", "ada_sola_bias")
TIME_FUSIONS = ("token",) + ADA_MODES


class Attention(nn.Module):
    """Self or cross attention: q/k/v projections, per-head q/k norm,
    boolean key mask (True = attend), RoPE on self-attention:

      * ``shared``: every position rotated (``rotary``);
      * ``x_only``: the ``extras`` prefix (time/cls tokens, concatenated
        context) passes unrotated, the rest is rotated from position 0
        (``rotary``);
      * ``dual``: the prefix and the rest each rotated from position 0
        with a table of its own (``rotary_c``, ``rotary_x``)."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 qk_norm: Optional[str] = None, rope_mode: str = "none", extras: int = 0,
                 attention_impl: str = "auto"):
        super().__init__()
        self.attention_impl = attention_impl
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
        if rope_mode not in ROPE_MODES:
            raise NotImplementedError(f"rope_mode={rope_mode!r}")
        self.rope_mode = rope_mode
        self.extras = extras
        if rope_mode in ("shared", "x_only"):
            self.rotary = RotaryEmbedding(self.head_dim)
        elif rope_mode == "dual":
            self.rotary_x = RotaryEmbedding(self.head_dim)
            self.rotary_c = RotaryEmbedding(self.head_dim)
        self.proj = QuantLinear(dim, dim)

    def _rope(self, q, k):
        L, e = q.shape[2], self.extras
        if self.rope_mode == "shared":
            cos, sin = self.rotary.tables(L)
            return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if self.rope_mode == "x_only":
            cos, sin = self.rotary.tables(L)
            return (apply_rope_skip_prefix(q, cos, sin, e),
                    apply_rope_skip_prefix(k, cos, sin, e))
        cx, sx = self.rotary_x.tables(max(L - e, 0))
        cc, sc = self.rotary_c.tables(min(e, L))
        return tuple(torch.cat([apply_rope(t[:, :, :e], cc, sc),
                                apply_rope(t[:, :, e:], cx, sx)], dim=2) for t in (q, k))

    def forward(self, x, context=None, context_mask=None):
        B, L, _ = x.shape
        ctx = x if context is None else context
        Lk = ctx.shape[1]
        Dh = self.head_dim  # the heads: all, or this tensor-parallel rank's
        q = self.to_q(x).view(B, L, -1, Dh).transpose(1, 2)
        k = self.to_k(ctx).view(B, Lk, -1, Dh).transpose(1, 2)
        v = self.to_v(ctx).view(B, Lk, -1, Dh).transpose(1, 2)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        if self.rope_mode != "none":  # self-attention only (cross passes rope "none")
            q, k = self._rope(q, k)
        impl = self.attention_impl
        if impl == "auto":
            impl = current_attention_impl() or "auto"
        if context is None and impl in ("auto", "ring"):
            from ezaudio_tpu_torch.parallel.mesh import axis_size
            from ezaudio_tpu_torch.parallel.ring_attention import (current_ring_context,
                                                                   ring_attention)

            rctx = current_ring_context()
            if impl == "ring" and rctx is None:
                raise RuntimeError("attention_impl='ring' requires running inside "
                                   "ring_context(mesh, ...)")
            if rctx is not None and (impl == "ring" or axis_size(rctx[0], rctx[1]) > 1):
                mesh, axis, batch_axes = rctx
                out = ring_attention(q, k, v, mesh, key_mask=context_mask, scale=self.scale,
                                     axis=axis, batch_axes=batch_axes)
                return self.proj(out.transpose(1, 2).reshape(B, L, -1))
        if impl in BF16_IMPLS:
            mask = None if context_mask is None else context_mask.bool()[:, None, None, :]
            fn = chunked_dot_product_attention if impl == "chunked_bf16" else dot_product_attention
            out = fn(q, k, v, mask=mask, scale=self.scale, softmax_dtype=torch.bfloat16)
        else:
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_mask=context_mask, scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, L, -1))


class AdaLN(nn.Module):
    """AdaLN modulation head, returning (B, 6, dim) laid out as
    [shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp]:

      * ``ada``: a per-block ``time_ada`` Linear of the time token;
      * ``ada_single``: the shared ``time_ada`` output plus the block's
        (6, dim) ``scale_shift_table``;
      * ``ada_sola``: the shared output plus a rank-r LoRA delta
        ``lora_b(lora_a(time_token)) * alpha / r``;
      * ``ada_sola_bias``: ``ada_sola`` plus the table (EzAudio's)."""

    def __init__(self, dim: int, ada_mode: str, r: Optional[int] = None,
                 alpha: Optional[float] = None):
        super().__init__()
        if ada_mode not in ADA_MODES:
            raise NotImplementedError(f"time_fusion={ada_mode!r}")
        self.dim = dim
        self.mode = ada_mode
        if ada_mode == "ada":
            self.time_ada = QuantLinear(dim, 6 * dim)
        if ada_mode in ("ada_sola", "ada_sola_bias"):
            if r is None or alpha is None:
                raise ValueError(f"time_fusion={ada_mode!r} needs ada_sola_rank and "
                                 "ada_sola_alpha")
            self.scaling = alpha / r
            self.lora_a = QuantLinear(dim, r * 6, bias=False)
            self.lora_b = QuantLinear(r * 6, dim * 6, bias=False)
        self.scale_shift_table = (nn.Parameter(torch.zeros(6, dim))
                                  if ada_mode in ("ada_single", "ada_sola_bias") else None)

    def forward(self, time_token, time_ada):
        if self.mode == "ada":
            return self.time_ada(time_token).reshape(-1, 6, self.dim)
        out = time_ada
        if self.mode != "ada_single":
            out = out + self.lora_b(self.lora_a(time_token)) * self.scaling
        out = out.reshape(-1, 6, self.dim)
        if self.scale_shift_table is not None:
            out = out + self.scale_shift_table[None]
        return out


class DiTBlock(nn.Module):
    """Pre-LN DiT block: optional long-skip fusion
    (``skip_linear(skip_norm(cat[x, skip]))``), self-attention, optional
    cross-attention to the text context, the MLP.  Under an AdaLN
    ``time_fusion`` the norms are FiLM-modulated and the residuals gated
    ``x + (1 - gate) * f(x)``; under ``token`` (the time token is a prefix
    of the sequence) the norms are plain and the residuals ungated.
    ``extras`` is the prefix length the RoPE modes ``x_only``/``dual``
    treat apart."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, qk_norm: Optional[str] = None,
                 act_layer: str = "geglu", norm_layer: str = "layernorm",
                 time_fusion: str = "ada_sola_bias", ada_sola_rank: Optional[int] = 32,
                 ada_sola_alpha: Optional[float] = 32, skip: bool = False,
                 skip_norm: bool = False, rope_mode: str = "none",
                 context_norm: bool = False, extras: int = 0, attention_impl: str = "auto"):
        super().__init__()
        if time_fusion not in TIME_FUSIONS:
            raise NotImplementedError(f"time_fusion={time_fusion!r}")
        self.skip_linear = QuantLinear(2 * dim, dim) if skip else None
        self.skip_norm = make_norm(norm_layer, 2 * dim) if (skip and skip_norm) else None
        self.adaln = (AdaLN(dim, time_fusion, ada_sola_rank, ada_sola_alpha)
                      if time_fusion != "token" else None)
        self.norm1 = make_norm(norm_layer, dim)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale,
                              qk_norm=qk_norm, rope_mode=rope_mode, extras=extras,
                              attention_impl=attention_impl)
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
        if self.adaln is None:
            x = x + self.attn(self.norm1(x), context_mask=x_mask)
        else:
            (shift_msa, scale_msa, gate_msa,
             shift_mlp, scale_mlp, gate_mlp) = self.adaln(time_token, time_ada).chunk(6, dim=1)
            h = film_modulate(self.norm1(x), shift=shift_msa, scale=scale_msa)
            x = x + (1 - gate_msa) * self.attn(h, context_mask=x_mask)

        if self.cross:
            ctx = self.norm_context(context) if self.norm_context is not None else context
            x = x + self.cross_attn(self.norm2(x), context=ctx, context_mask=context_mask)

        if self.adaln is None:
            return x + self.mlp(self.norm3(x))
        h = film_modulate(self.norm3(x), shift=shift_mlp, scale=scale_mlp)
        return x + (1 - gate_mlp) * self.mlp(h)


class FinalBlock(nn.Module):
    """Strip the ``extras`` prefix, norm (AdaLN-modulated by
    ``time_ada_final`` under AdaLN), linear to the patch dim, unpatchify,
    optional width-3 output conv ``final_layer`` (reference
    blocks.py:163-211; ``2d``: p*p*C patch dim, (H, W) ``img_size``, a 3x3
    Conv2d)."""

    def __init__(self, embed_dim: int, patch_size: int, out_chans: int,
                 norm_layer: str = "layernorm", use_conv: bool = True,
                 use_adanorm: bool = True, input_type: str = "1d", img_size=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.out_chans = out_chans
        self.use_adanorm = use_adanorm
        self.img_size = tuple(img_size) if input_type == "2d" else None
        self.norm = make_norm(norm_layer, embed_dim)
        p = patch_size ** 2 if input_type == "2d" else patch_size
        self.linear = QuantLinear(embed_dim, p * out_chans)
        conv = Conv2d if input_type == "2d" else Conv1d
        self.final_layer = conv(out_chans, out_chans, 3, padding=1) if use_conv else None

    def forward(self, x, time_ada=None, extras: int = 0):
        h = self.norm(x[:, extras:])
        if self.use_adanorm:
            shift, scale = time_ada.reshape(x.shape[0], 2, self.embed_dim).chunk(2, dim=1)
            h = film_modulate(h, shift, scale)
        h = self.linear(h)
        if self.img_size is not None:
            h = unpatchify_2d(h, self.out_chans, self.img_size)
            if self.final_layer is not None:
                h = self.final_layer(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            return h
        h = unpatchify_1d(h, self.out_chans)
        if self.final_layer is not None:
            h = self.final_layer(h.transpose(1, 2)).transpose(1, 2)
        return h
