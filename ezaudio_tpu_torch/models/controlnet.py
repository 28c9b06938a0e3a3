"""DiTControlNet: a conditioned copy of the UDiT in-block stack
(counterpart of ``ezaudio_tpu/models/controlnet.py``).

  * ``ControlNetEmbed``: Conv1d(k1) stem into ``blocks[0]`` channels;
    with ``cond_mask``, masked frames take ``mask_embed`` and a mask row
    joins the channels (``blocks[0] + 1``); a pyramid of [Conv k3 p1, SiLU,
    Conv k3 p1 s2, SiLU] per stage; Conv1d(k1) out to the model width;
  * ``DiTControlNet``: patch embed plus the embedded condition, the
    positional embedding, the context (cross-attended, or prefixed to x
    under ``concat``/``joint``; none over a base with ``context_dim``
    None, the MAE pretraining stage) and time embedders, ``depth // 2`` DiT in-blocks (attention on
    kernel 1), each followed by its ``controlnet_zero_blocks`` projection,
    scaled by ``conditioning_scale``: the skips ``MaskDiT.forward_backbone``
    adds to the base model's long skips.

Inputs are channel-last (B, L, C).  Parameter names follow the reference
torch state dict (``controlnet_pre.conv_in``, ``controlnet_pre.blocks.0.0``,
``in_blocks.3``, ``controlnet_zero_blocks.3``, ``time_embed.mlp.0`` ...),
so a reference ControlNet state dict loads as it is.  The linears are
``QuantLinear`` (int8 under ``quant_context('int8')``, as the JAX package's
``Linear``); the pyramid convs stay float.

Training (``train=True`` with no ``cond_mask_infer``) masks the condition
at random as the JAX package does: per-sample ratios in
``cond_mask_ratio``, span masks of ``cond_mask_span`` frames
(``span_mask.py``), applied to a ``cond_mask_prob`` share of the batch.
The draws come in ``mask_draws`` (:meth:`ControlNetEmbed.draw_mask`), so a
test can hand in the JAX package's (ROADMAP F1).  :func:`trainable_mask`
names the subset a fine-tune trains (``controlnet_pre``, the in-blocks and
the zero projections); :func:`zero_projections_` zeroes what the JAX
package's init zeroes, the start of a fine-tune.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.models.blocks import ADA_MODES, DiTBlock
from ezaudio_tpu_torch.models.span_mask import span_mask_from_draws, train_mask_draws
from ezaudio_tpu_torch.models.udit import CONTEXT_FUSIONS, prefix_context
from ezaudio_tpu_torch.ops.convs import Conv1d
from ezaudio_tpu_torch.ops.embeddings import (MLPEmbedder, PatchEmbed1D, PEWrapper,
                                              TimestepEmbedder)
from ezaudio_tpu_torch.ops.quant import QuantLinear

# the submodules a ControlNet takes over from its base UDiT
SHARED_WITH_BASE = ("patch_embed", "x_pe", "context_embed", "context_pe", "time_embed",
                    "time_ada", "in_blocks")
# the submodules a fine-tune trains (reference controlnet.py:238-250)
TRAINABLE = ("controlnet_pre", "in_blocks", "controlnet_zero_blocks")


class ControlNetEmbed(nn.Module):
    def __init__(self, in_chans: int, out_chans: int, blocks: Sequence[int],
                 cond_mask: bool = False, cond_mask_prob: Optional[float] = None,
                 cond_mask_ratio: Optional[Sequence[float]] = None,
                 cond_mask_span: Optional[int] = None):
        super().__init__()
        blocks = list(blocks)
        self.conv_in = Conv1d(in_chans, blocks[0], 1)
        self.cond_mask = cond_mask
        self.cond_mask_prob = cond_mask_prob
        self.cond_mask_ratio = tuple(cond_mask_ratio) if cond_mask_ratio else None
        self.cond_mask_span = cond_mask_span
        if cond_mask:
            self.mask_embed = nn.Parameter(torch.zeros(blocks[0]))
            blocks[0] += 1
        self.blocks = nn.ModuleList([
            nn.Sequential(Conv1d(cin, cin, 3, padding=1), nn.SiLU(),
                          Conv1d(cin, cout, 3, padding=1, stride=2), nn.SiLU())
            for cin, cout in zip(blocks[:-1], blocks[1:])])
        self.conv_out = Conv1d(blocks[-1], out_chans, 1)

    def draw_mask(self, generator, batch: int, length: int, device) -> Dict[str, torch.Tensor]:
        """The training mask's draws, in the JAX package's order: ``ratio``
        (B,) uniform in ``cond_mask_ratio``, the span mask's ``span_round``
        (B,) and ``span_scores`` (B, n_pos), the selection uniforms
        ``select`` (B,).  ``length`` is the condition's frames."""
        return train_mask_draws(generator, batch, length, self.cond_mask_ratio,
                                self.cond_mask_span, device)

    def forward(self, conditioning, cond_mask_infer=None, train: bool = False,
                mask_draws: Optional[Dict[str, torch.Tensor]] = None):
        """conditioning (B, L, in_chans) -> (B, L / 2^(len(blocks)-1),
        out_chans).  ``cond_mask_infer`` (B, L, 1), True where a frame is
        masked, broadcasts over the channels; None masks none, or with
        ``train`` a random share drawn from ``mask_draws``
        (:meth:`draw_mask`)."""
        x = self.conv_in(conditioning.transpose(1, 2))  # (B, C, L) inside
        if self.cond_mask:
            B, C, L = x.shape
            if train and cond_mask_infer is None:
                if mask_draws is None:
                    raise ValueError("train=True masks the condition at random: pass "
                                     "mask_draws (ControlNetEmbed.draw_mask)")
                d = mask_draws
                span = span_mask_from_draws(d["span_round"], d["span_scores"], L, d["ratio"],
                                            self.cond_mask_span)
                # only a cond_mask_prob share of the batch is masked
                span = span & (d["select"] < self.cond_mask_prob)[:, None]
                mask = span[:, None, :].expand(B, C, L)
            elif cond_mask_infer is None:
                mask = torch.zeros_like(x, dtype=torch.bool)
            else:
                mask = cond_mask_infer.bool().expand(B, L, C).transpose(1, 2)
            x = torch.where(mask, self.mask_embed.to(x.dtype)[None, :, None], x)
            x = torch.cat([x, mask[:, :1].to(x.dtype)], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.conv_out(x).transpose(1, 2)


class DiTControlNet(nn.Module):
    """Conditioned half-depth UDiT returning ``depth // 2`` skip tensors.
    ``udit`` is the base model's UDiT config: the AdaLN time fusions only
    (``token`` raises, as the JAX package asserts), the context by
    cross-attention or ``concat``/``joint`` (the embedded context, padded to
    ``context_max_length``, prefixed to x; the skips then cover it too).
    With ``context_dim`` None there is no ``context_embed``, no
    ``context_pe`` and no cross-attention, and the context is ignored."""

    def __init__(self, udit: dict, cond_in: int = 1, cond_blocks: Sequence[int] = (64, 128),
                 cond_mask: bool = False, cond_mask_prob: Optional[float] = None,
                 cond_mask_ratio: Optional[Sequence[float]] = None,
                 cond_mask_span: Optional[int] = None):
        super().__init__()
        cfg = dict(udit)
        time_fusion = cfg.get("time_fusion", "ada_sola_bias")
        if time_fusion not in ADA_MODES:
            raise NotImplementedError(f"ControlNet time_fusion={time_fusion!r}: the AdaLN "
                                      "family only")
        fusion = cfg.get("context_fusion", "cross")
        has_context = cfg.get("context_dim") is not None
        if has_context and fusion not in CONTEXT_FUSIONS:
            raise NotImplementedError(f"context_fusion={fusion!r}")
        self.concat = has_context and fusion != "cross"
        self.context_max_length = cfg.get("context_max_length")
        if self.concat and self.context_max_length is None:
            raise ValueError(f"context_fusion={fusion!r} needs context_max_length")
        extras = self.context_max_length if self.concat else 0
        dim = cfg["embed_dim"]
        patch = cfg.get("patch_size", 1)
        self.patch_embed = PatchEmbed1D(patch, cfg["in_chans"], dim)
        self.x_pe = PEWrapper(cfg.get("pe_method", "none"), dim, cfg["img_size"] // patch)
        self.controlnet_pre = ControlNetEmbed(cond_in, dim, cond_blocks, cond_mask,
                                              cond_mask_prob, cond_mask_ratio, cond_mask_span)
        self.context_embed = self.context_pe = None
        if has_context:
            self.context_embed = MLPEmbedder(cfg["context_dim"], dim)
            self.context_pe = PEWrapper(cfg.get("context_pe_method", "none"), dim,
                                        self.context_max_length)
        self.time_embed = TimestepEmbedder(dim)
        self.time_ada = QuantLinear(dim, 6 * dim) if time_fusion != "ada" else None
        half = cfg["depth"] // 2
        self.in_blocks = nn.ModuleList([DiTBlock(
            dim, cfg["num_heads"], context_dim=dim if has_context and not self.concat else None,
            mlp_ratio=cfg.get("mlp_ratio", 4.0),
            qkv_bias=cfg.get("qkv_bias", False), qk_scale=cfg.get("qk_scale"),
            qk_norm=cfg.get("qk_norm"), act_layer=cfg.get("act_layer", "gelu"),
            norm_layer=cfg.get("norm_layer", "layernorm"),
            time_fusion=time_fusion,
            ada_sola_rank=cfg.get("ada_sola_rank", 32),
            ada_sola_alpha=cfg.get("ada_sola_alpha", 32),
            rope_mode=cfg.get("rope_mode", "none"),
            context_norm=cfg.get("context_norm", False), extras=extras)
            for _ in range(half)])
        self.controlnet_zero_blocks = nn.ModuleList([QuantLinear(dim, dim)
                                                     for _ in range(half)])

    def forward(self, x, timesteps, context=None, x_mask=None, context_mask=None, condition=None,
                cond_mask_infer=None, conditioning_scale: float = 1.0, train: bool = False,
                mask_draws=None):
        """x: (B, T, in_chans), MaskDiT's concat; timesteps (B,) or scalar;
        context (B, Lc, context_dim), or None without a context;
        condition (B, T * 2^(stages), cond_in).
        ``train`` with ``mask_draws`` masks the condition at random
        (:meth:`ControlNetEmbed.draw_mask`).  Returns the list of
        depth // 2 skips (B, extras + T, embed_dim)."""
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        x = self.patch_embed(x) + self.controlnet_pre(condition, cond_mask_infer, train,
                                                      mask_draws)
        x = self.x_pe(x)
        context_token = None
        if self.context_embed is not None:
            context_token = self.context_pe(self.context_embed(context))
        if self.concat:
            x, x_mask = prefix_context(x, x_mask, context_token, context_mask,
                                       self.context_max_length)
            context_token = context_mask = None
        time_token = F.silu(self.time_embed(timesteps))
        time_ada = self.time_ada(time_token) if self.time_ada is not None else None
        skips = []
        for blk, zero in zip(self.in_blocks, self.controlnet_zero_blocks):
            x = blk(x, time_token, time_ada, None, context_token, x_mask, context_mask)
            skips.append(zero(x) * conditioning_scale)
        return skips


def controlnet_from_config(model_cfg: dict, controlnet_cfg: dict) -> DiTControlNet:
    """Build from the reference config layout: the ``model:`` block (its
    MAE keys dropped) and the ``controlnet:`` block, the training-time
    masking keys (``cond_mask_prob``, ``cond_mask_ratio``,
    ``cond_mask_span``) included."""
    cfg = dict(model_cfg)
    for k in ("mae", "mae_prob", "mask_ratio", "mask_span", "input_type"):
        cfg.pop(k, None)
    return DiTControlNet(cfg, cond_in=controlnet_cfg["cond_in"],
                         cond_blocks=controlnet_cfg["cond_blocks"],
                         cond_mask=controlnet_cfg.get("cond_mask", False),
                         cond_mask_prob=controlnet_cfg.get("cond_mask_prob"),
                         cond_mask_ratio=controlnet_cfg.get("cond_mask_ratio"),
                         cond_mask_span=controlnet_cfg.get("cond_mask_span"))


def trainable_mask(controlnet: DiTControlNet) -> Dict[str, bool]:
    """Parameter name -> True for the subset a fine-tune trains
    (``TRAINABLE``: the condition embedder, the in-blocks and the zero
    projections); the embedders copied from the base stay as they are."""
    return {n: n.split(".", 1)[0] in TRAINABLE for n, _ in controlnet.named_parameters()}


@torch.no_grad()
def init_from_base_(controlnet: DiTControlNet, base_udit: nn.Module) -> DiTControlNet:
    """Copy the base UDiT's embedders and in-blocks into ``controlnet``
    (``SHARED_WITH_BASE``), value by value: the ControlNet keeps its own
    parameters, so loading ControlNet weights leaves the base as it is."""
    for name in SHARED_WITH_BASE:
        mine = getattr(controlnet, name)
        if mine is not None:  # time_ada is None under time_fusion='ada'
            mine.load_state_dict(getattr(base_udit, name).state_dict())
    return controlnet


@torch.no_grad()
def zero_projections_(controlnet: DiTControlNet) -> DiTControlNet:
    """Zero what the JAX package's init zeroes in the ControlNet's own
    parameters: the output projections (``controlnet_pre.conv_out`` and
    every ``controlnet_zero_blocks`` linear, weight and bias) and the
    condition mask's ``mask_embed``.  Then the ControlNet adds nothing at
    any conditioning scale, and a fine-tune starts where JAX's does (the
    rest is the base's, :func:`init_from_base_`, or drawn as JAX draws it)."""
    pre = controlnet.controlnet_pre
    for m in [pre.conv_out, *controlnet.controlnet_zero_blocks]:
        for p in m.parameters():
            p.zero_()
    if pre.cond_mask:
        pre.mask_embed.zero_()
    return controlnet
