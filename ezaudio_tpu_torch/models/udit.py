"""UDiT: U-shaped diffusion transformer with long skips
(counterpart of ``ezaudio_tpu/models/udit.py::UDiT``), every switch the
JAX package builds:

  * ``input_type`` ``1d`` (B, T, C) or ``2d`` (B, H, W, C) with a
    (H, W) ``img_size``;
  * ``pe_method`` / ``context_pe_method``: ``abs``, ``conv``, ``sinu``,
    ``none`` (``ops/embeddings.py::PEWrapper``);
  * ``time_fusion``: ``token`` (the time token, and the ``cls_dim`` class
    token, prefixed to the sequence with an ``abs`` ``time_pe``) or the
    AdaLN family ``ada``, ``ada_single``, ``ada_sola``, ``ada_sola_bias``
    (``time_ada_final`` -> 2*dim for the FinalBlock; a shared ``time_ada``
    -> 6*dim but for ``ada``; the class embedding added to the time
    embedding);
  * ``context_fusion``: ``cross`` (per-block cross-attention; none with
    ``context_dim=None``, the MAE pretraining stage) or ``concat`` /
    ``joint`` (the embedded context, padded to ``context_max_length``,
    prefixed to x, its mask to x's key mask);
  * ``rope_mode`` ``none``/``shared``/``x_only``/``dual`` over the
    ``extras`` prefix (:func:`udit_extras`), the activations of
    ``ops/mlp.py``, ``qkv_bias``, ``use_conv``, ``skip``, ``skip_norm``.

An unknown value raises ``NotImplementedError``.
depth//2 in-blocks collect skips, a mid block, depth//2 out-blocks pop
them in reverse, then the FinalBlock.  Cross-step layer caching
(``collect_deep_k`` / ``deep_cache``) splits that stack.  ControlNet skips
(``controlnet_skips``, one per in-block) are popped in reverse in step with
the long skips and added to them (to ``x`` when ``skip=False``).

``use_checkpoint`` recomputes each block in the backward pass (the JAX
package's ``nn.remat``), only while autograd records: ``remat_policy``
``'full'`` keeps each block's inputs alone
(``torch.utils.checkpoint``, non-reentrant), ``'dots'`` also keeps the
outputs of the non-batched matrix products (``mm``/``addmm``, a
selective-checkpoint policy: JAX's ``dots_with_no_batch_dims_saveable``),
``'auto'`` reads ``EZAUDIO_REMAT`` (default ``'full'``).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tc
from torch import nn

from ezaudio_tpu_torch.models.blocks import TIME_FUSIONS, DiTBlock, FinalBlock
from ezaudio_tpu_torch.ops.embeddings import (MLPEmbedder, PatchEmbed1D, PatchEmbed2D,
                                              PEWrapper, TimestepEmbedder)
from ezaudio_tpu_torch.ops.quant import QuantLinear

REMAT_POLICIES = ("full", "dots")
INPUT_TYPES = ("1d", "2d")
CONTEXT_FUSIONS = ("cross", "concat", "joint")


def udit_extras(time_fusion: str, cls_dim, context_dim, context_fusion: str,
                context_max_length) -> int:
    """The prefix tokens before x (JAX ``UDiT._extras``): the time token
    (and the class token) under ``token``, the context under
    ``concat``/``joint``."""
    extras = 0
    if time_fusion == "token":
        extras = 2 if cls_dim is not None else 1
    if context_dim is not None and context_fusion in ("concat", "joint"):
        extras += context_max_length
    return extras


def prefix_context(x, x_mask, context_token, context_mask, max_length: int):
    """Concat/joint fusion: the embedded context (B, Lc, D) before the
    tokens x (B, L, D), its mask before x's (all-True where absent);
    returns ``(x, key_mask)``.  The context must be padded to
    ``max_length``: every prefix-aware step counts that many tokens."""
    B, L, _ = x.shape
    if context_token.shape[1] != max_length:
        raise ValueError("concat fusion requires the context padded to context_max_length="
                         f"{max_length}, got {context_token.shape[1]}")
    if x_mask is None:
        x_mask = torch.ones(B, L, dtype=torch.bool, device=x.device)
    if context_mask is None:
        context_mask = torch.ones(B, max_length, dtype=torch.bool, device=x.device)
    return (torch.cat([context_token, x], dim=1),
            torch.cat([context_mask.bool(), x_mask.bool()], dim=1))


def _dots_saveable(ctx, op, *args, **kwargs):
    """Keep the non-batched matrix products, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return tc.CheckpointPolicy.MUST_SAVE
    return tc.CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(policy: str) -> str:
    """``'auto'`` -> ``EZAUDIO_REMAT`` (default ``'full'``); checked."""
    if policy == "auto":
        policy = os.environ.get("EZAUDIO_REMAT", "full")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}: one of {REMAT_POLICIES} or 'auto'")
    if policy == "dots" and not hasattr(tc, "create_selective_checkpoint_contexts"):
        raise NotImplementedError("remat_policy='dots' needs torch's selective "
                                  "checkpointing (torch >= 2.4)")
    return policy


class UDiT(nn.Module):
    def __init__(self, img_size=500, patch_size: int = 1, in_chans: int = 257,
                 input_type: str = "1d", out_chans: Optional[int] = None,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, qk_norm: Optional[str] = None,
                 act_layer: str = "geglu", norm_layer: str = "layernorm",
                 context_norm: bool = False, use_checkpoint: bool = False,
                 remat_policy: str = "auto",
                 time_fusion: str = "ada_sola_bias", ada_sola_rank: Optional[int] = 32,
                 ada_sola_alpha: Optional[float] = 32, cls_dim: Optional[int] = None,
                 context_dim: Optional[int] = 1024, context_fusion: str = "cross",
                 context_max_length: Optional[int] = None,
                 context_pe_method: str = "none", pe_method: str = "none",
                 rope_mode: str = "none", use_conv: bool = True, skip: bool = True,
                 skip_norm: bool = True, attention_impl: str = "auto"):
        super().__init__()
        if input_type not in INPUT_TYPES:
            raise NotImplementedError(f"input_type={input_type!r}")
        if time_fusion not in TIME_FUSIONS:
            raise NotImplementedError(f"time_fusion={time_fusion!r}")
        if context_dim is not None and context_fusion not in CONTEXT_FUSIONS:
            raise NotImplementedError(f"context_fusion={context_fusion!r}")
        self.concat = context_dim is not None and context_fusion in ("concat", "joint")
        if self.concat and context_max_length is None:
            raise ValueError(f"context_fusion={context_fusion!r} needs context_max_length")
        self.out_chans = out_chans or in_chans
        self.skip = skip
        self.use_checkpoint = use_checkpoint
        self.remat_policy = remat_policy
        self.use_adanorm = time_fusion != "token"
        self.context_max_length = context_max_length
        self.extras = extras = udit_extras(time_fusion, cls_dim, context_dim, context_fusion,
                                           context_max_length)
        if input_type == "2d":
            H, W = img_size
            num_patches = (H // patch_size) * (W // patch_size)
            self.patch_embed = PatchEmbed2D(patch_size, in_chans, embed_dim)
        else:
            num_patches = img_size // patch_size
            self.patch_embed = PatchEmbed1D(patch_size, in_chans, embed_dim)
        self.x_pe = PEWrapper(pe_method, embed_dim, num_patches)
        self.context_embed = (MLPEmbedder(context_dim, embed_dim)
                              if context_dim is not None else None)
        self.context_pe = PEWrapper(context_pe_method if context_dim is not None else "none",
                                    embed_dim, context_max_length)
        self.time_embed = TimestepEmbedder(embed_dim)
        self.cls_embed = (MLPEmbedder(cls_dim, embed_dim, zero_out=self.use_adanorm)
                          if cls_dim is not None else None)
        self.time_ada_final = self.time_ada = self.time_pe = None
        if self.use_adanorm:
            self.time_ada_final = QuantLinear(embed_dim, 2 * embed_dim)
            if time_fusion != "ada":
                self.time_ada = QuantLinear(embed_dim, 6 * embed_dim)
        else:
            self.time_pe = PEWrapper("abs", embed_dim, 2 if cls_dim is not None else 1)

        def block(with_skip: bool):
            return DiTBlock(
                embed_dim, num_heads,
                context_dim=embed_dim if context_dim is not None and not self.concat else None,
                mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale, qk_norm=qk_norm,
                act_layer=act_layer, norm_layer=norm_layer, time_fusion=time_fusion,
                ada_sola_rank=ada_sola_rank, ada_sola_alpha=ada_sola_alpha,
                skip=with_skip, skip_norm=skip_norm and with_skip,
                rope_mode=rope_mode, context_norm=context_norm, extras=extras,
                attention_impl=attention_impl)

        half = depth // 2
        self.in_blocks = nn.ModuleList([block(False) for _ in range(half)])
        self.mid_block = block(False)
        self.out_blocks = nn.ModuleList([block(skip) for _ in range(half)])
        self.final_block = FinalBlock(embed_dim, patch_size, self.out_chans,
                                      norm_layer=norm_layer, use_conv=use_conv,
                                      use_adanorm=self.use_adanorm, input_type=input_type,
                                      img_size=img_size)

    def embed(self, x, timesteps, context, x_mask=None, context_mask=None, cls_token=None):
        """The tokens entering the first block and the block inputs:
        ``(x, time_token, time_ada, time_ada_final, context_token, x_mask,
        context_mask)``.  ``concat``/``joint`` put the embedded context
        before x (its mask before x's), ``token`` the time token (and the
        class token) before both."""
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        x = self.x_pe(self.patch_embed(x))
        B = x.shape[0]
        context_token = None
        if self.context_embed is not None:
            context_token = self.context_pe(self.context_embed(context))
            if self.concat:
                x, x_mask = prefix_context(x, x_mask, context_token, context_mask,
                                           self.context_max_length)
                context_token = context_mask = None

        time_token = self.time_embed(timesteps)
        cls_emb = None
        if self.cls_embed is not None:
            if cls_token is None:
                raise ValueError("a model with cls_dim needs cls_token")
            cls_emb = self.cls_embed(cls_token)
        time_ada = time_ada_final = None
        if self.use_adanorm:
            if cls_emb is not None:
                time_token = time_token + cls_emb
            time_token = F.silu(time_token)
            time_ada_final = self.time_ada_final(time_token)
            if self.time_ada is not None:
                time_ada = self.time_ada(time_token)
        else:
            tt = time_token[:, None, :]
            if cls_emb is not None:
                tt = torch.cat([tt, cls_emb[:, None, :]], dim=1)
            tt = self.time_pe(tt)
            x = torch.cat([tt.to(x.dtype), x], dim=1)
            if x_mask is not None:
                x_mask = torch.cat([torch.ones(B, tt.shape[1], dtype=torch.bool,
                                               device=x.device), x_mask.bool()], dim=1)
            time_token = None
        return x, time_token, time_ada, time_ada_final, context_token, x_mask, context_mask

    def forward(self, x, timesteps, context, x_mask=None, context_mask=None, cls_token=None,
                controlnet_skips=None, deep_cache=None, collect_deep_k=None):
        """x: (B, T, in_chans), or (B, H, W, in_chans) for ``input_type='2d'``;
        timesteps: (B,) or scalar, a tensor on x's device under CUDA graph
        capture (a Python number is copied from the host, which capture
        forbids); context: (B, Lc, context_dim), padded to
        ``context_max_length`` under ``concat``/``joint``; context_mask:
        (B, Lc) bool; cls_token: (B, cls_dim) for a model with ``cls_dim``.

        Layer caching (1 <= k < depth//2):

          * ``collect_deep_k=k``: the full forward, returning ``(out,
            deep)`` with ``deep`` the activation after
            ``out_blocks[half-k-1]``;
          * ``deep_cache=(k, deep)``: run ``in_blocks[:k]``, substitute
            ``deep`` for the middle of the U, run ``out_blocks[half-k:]``
            and the final block.  Exact at the step that collected ``deep``.

        ``controlnet_skips``: depth//2 tensors (B, extras + L, D) from
        ``DiTControlNet``; they do not combine with ``deep_cache``.
        """
        half = len(self.in_blocks)
        if deep_cache is not None and collect_deep_k is not None:
            raise ValueError("pass deep_cache or collect_deep_k, not both")
        if deep_cache is not None and controlnet_skips is not None:
            raise ValueError("layer caching (deep_cache) and ControlNet skips do not combine")
        cache_k = deep_cache[0] if deep_cache is not None else None
        for k in (cache_k, collect_deep_k):
            if k is not None and not 1 <= k < half:
                raise ValueError(f"layer cache k={k} must satisfy 1 <= k < {half}")
        (x, time_token, time_ada, time_ada_final, context_token, x_mask,
         context_mask) = self.embed(x, timesteps, context, x_mask, context_mask, cls_token)

        args = (time_token, time_ada)
        ctx_args = (context_token, x_mask, context_mask)
        if self.use_checkpoint and torch.is_grad_enabled():
            kw = dict(use_reentrant=False, preserve_rng_state=False)  # blocks draw nothing
            if resolve_remat_policy(self.remat_policy) == "dots":
                kw["context_fn"] = functools.partial(
                    tc.create_selective_checkpoint_contexts, _dots_saveable)

            def run(blk, x, skip=None):
                return tc.checkpoint(blk, x, *args, skip, *ctx_args, **kw)
        else:
            def run(blk, x, skip=None):
                return blk(x, *args, skip, *ctx_args)

        skips = []
        for blk in self.in_blocks[:half if cache_k is None else cache_k]:
            x = run(blk, x)
            if self.skip:
                skips.append(x)
        deep = None
        if cache_k is None:
            x = run(self.mid_block, x)
            out_blocks = self.out_blocks
        else:
            x = deep_cache[1].to(x.dtype)
            out_blocks = self.out_blocks[half - cache_k:]
        cn = list(controlnet_skips) if controlnet_skips is not None else []
        for i, blk in enumerate(out_blocks):
            skip = skips.pop() if self.skip else None
            if cn:
                if self.skip:
                    skip = skip + cn.pop()
                else:
                    x = x + cn.pop()
            x = run(blk, x, skip)
            if collect_deep_k is not None and i == half - collect_deep_k - 1:
                deep = x
        out = self.final_block(x, time_ada_final, self.extras)
        return (out, deep) if collect_deep_k is not None else out
