"""UDiT: U-shaped 1D diffusion transformer with long skips
(counterpart of ``ezaudio_tpu/models/udit.py::UDiT``).

This slice covers the EzAudio settings: 1d input, AdaLN-SOLA time fusion
(shared ``time_ada`` -> 6*dim and ``time_ada_final`` -> 2*dim), per-block
cross-attention to the context (none with ``context_dim=None``, the MAE
pretraining stage), ``none`` positional embeddings.
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

from ezaudio_tpu_torch.models.blocks import DiTBlock, FinalBlock
from ezaudio_tpu_torch.ops.embeddings import (MLPEmbedder, PatchEmbed1D, PEWrapper,
                                              TimestepEmbedder)
from ezaudio_tpu_torch.ops.quant import QuantLinear

REMAT_POLICIES = ("full", "dots")


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
    def __init__(self, img_size: int = 500, patch_size: int = 1, in_chans: int = 257,
                 input_type: str = "1d", out_chans: Optional[int] = None,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, qk_norm: Optional[str] = None,
                 act_layer: str = "geglu", norm_layer: str = "layernorm",
                 context_norm: bool = False, use_checkpoint: bool = False,
                 remat_policy: str = "auto",
                 time_fusion: str = "ada_sola_bias", ada_sola_rank: int = 32,
                 ada_sola_alpha: float = 32, cls_dim: Optional[int] = None,
                 context_dim: Optional[int] = 1024, context_fusion: str = "cross",
                 context_max_length: Optional[int] = None,
                 context_pe_method: str = "none", pe_method: str = "none",
                 rope_mode: str = "none", use_conv: bool = True, skip: bool = True,
                 skip_norm: bool = True):
        super().__init__()
        if input_type != "1d":
            raise NotImplementedError(f"input_type={input_type!r}")
        if cls_dim is not None:
            raise NotImplementedError("cls_dim")
        if context_dim is not None and context_fusion != "cross":
            raise NotImplementedError(f"context_fusion={context_fusion!r}")
        self.out_chans = out_chans or in_chans
        self.skip = skip
        self.use_checkpoint = use_checkpoint
        self.remat_policy = remat_policy
        self.patch_embed = PatchEmbed1D(patch_size, in_chans, embed_dim)
        self.x_pe = PEWrapper(pe_method)
        self.context_embed = (MLPEmbedder(context_dim, embed_dim)
                              if context_dim is not None else None)
        self.context_pe = PEWrapper(context_pe_method)
        self.time_embed = TimestepEmbedder(embed_dim)
        self.time_ada_final = QuantLinear(embed_dim, 2 * embed_dim)
        self.time_ada = QuantLinear(embed_dim, 6 * embed_dim)

        def block(with_skip: bool):
            return DiTBlock(
                embed_dim, num_heads, context_dim=embed_dim if context_dim is not None else None,
                mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale, qk_norm=qk_norm,
                act_layer=act_layer, norm_layer=norm_layer, time_fusion=time_fusion,
                ada_sola_rank=ada_sola_rank, ada_sola_alpha=ada_sola_alpha,
                skip=with_skip, skip_norm=skip_norm and with_skip,
                rope_mode=rope_mode, context_norm=context_norm)

        half = depth // 2
        self.in_blocks = nn.ModuleList([block(False) for _ in range(half)])
        self.mid_block = block(False)
        self.out_blocks = nn.ModuleList([block(skip) for _ in range(half)])
        self.final_block = FinalBlock(embed_dim, patch_size, self.out_chans,
                                      norm_layer=norm_layer, use_conv=use_conv)

    def forward(self, x, timesteps, context, x_mask=None, context_mask=None,
                controlnet_skips=None, deep_cache=None, collect_deep_k=None):
        """x: (B, T, in_chans); timesteps: (B,) or scalar, a tensor on
        x's device under CUDA graph capture (a Python number is copied
        from the host, which capture forbids); context:
        (B, Lc, context_dim); context_mask: (B, Lc) bool.

        Layer caching (1 <= k < depth//2):

          * ``collect_deep_k=k``: the full forward, returning ``(out,
            deep)`` with ``deep`` the activation after
            ``out_blocks[half-k-1]``;
          * ``deep_cache=(k, deep)``: run ``in_blocks[:k]``, substitute
            ``deep`` for the middle of the U, run ``out_blocks[half-k:]``
            and the final block.  Exact at the step that collected ``deep``.

        ``controlnet_skips``: depth//2 tensors (B, L, D) from
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
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        x = self.x_pe(self.patch_embed(x))
        context_token = (self.context_pe(self.context_embed(context))
                         if self.context_embed is not None else None)

        time_token = F.silu(self.time_embed(timesteps))
        time_ada_final = self.time_ada_final(time_token)
        time_ada = self.time_ada(time_token)

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
        out = self.final_block(x, time_ada_final)
        return (out, deep) if collect_deep_k is not None else out
