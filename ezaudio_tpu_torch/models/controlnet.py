"""DiTControlNet: a conditioned copy of the UDiT in-block stack
(counterpart of ``ezaudio_tpu/models/controlnet.py``).

  * ``ControlNetEmbed``: Conv1d(k1) stem into ``blocks[0]`` channels;
    with ``cond_mask``, masked frames take ``mask_embed`` and a mask row
    joins the channels (``blocks[0] + 1``); a pyramid of [Conv k3 p1, SiLU,
    Conv k3 p1 s2, SiLU] per stage; Conv1d(k1) out to the model width;
  * ``DiTControlNet``: patch embed plus the embedded condition, the
    context and time embedders, ``depth // 2`` DiT in-blocks (attention on
    kernel 1), each followed by its ``controlnet_zero_blocks`` projection,
    scaled by ``conditioning_scale``: the skips ``MaskDiT.forward_backbone``
    adds to the base model's long skips.

Inputs are channel-last (B, L, C).  Parameter names follow the reference
torch state dict (``controlnet_pre.conv_in``, ``controlnet_pre.blocks.0.0``,
``in_blocks.3``, ``controlnet_zero_blocks.3``, ``time_embed.mlp.0`` ...),
so a reference ControlNet state dict loads as it is.  The linears are
``QuantLinear`` (int8 under ``quant_context('int8')``, as the JAX package's
``Linear``); the pyramid convs stay float.  Training-time random condition
masking raises until training is ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ezaudio_tpu_torch.models.blocks import DiTBlock
from ezaudio_tpu_torch.ops.convs import Conv1d
from ezaudio_tpu_torch.ops.embeddings import (MLPEmbedder, PatchEmbed1D, PEWrapper,
                                              TimestepEmbedder)
from ezaudio_tpu_torch.ops.quant import QuantLinear

# the submodules a ControlNet takes over from its base UDiT
SHARED_WITH_BASE = ("patch_embed", "x_pe", "context_embed", "context_pe", "time_embed",
                    "time_ada", "in_blocks")


class ControlNetEmbed(nn.Module):
    def __init__(self, in_chans: int, out_chans: int, blocks: Sequence[int],
                 cond_mask: bool = False):
        super().__init__()
        blocks = list(blocks)
        self.conv_in = Conv1d(in_chans, blocks[0], 1)
        self.cond_mask = cond_mask
        if cond_mask:
            self.mask_embed = nn.Parameter(torch.zeros(blocks[0]))
            blocks[0] += 1
        self.blocks = nn.ModuleList([
            nn.Sequential(Conv1d(cin, cin, 3, padding=1), nn.SiLU(),
                          Conv1d(cin, cout, 3, padding=1, stride=2), nn.SiLU())
            for cin, cout in zip(blocks[:-1], blocks[1:])])
        self.conv_out = Conv1d(blocks[-1], out_chans, 1)

    def forward(self, conditioning, cond_mask_infer=None, train: bool = False):
        """conditioning (B, L, in_chans) -> (B, L / 2^(len(blocks)-1),
        out_chans).  ``cond_mask_infer`` (B, L, 1), True where a frame is
        masked, broadcasts over the channels; None masks none."""
        x = self.conv_in(conditioning.transpose(1, 2))  # (B, C, L) inside
        if self.cond_mask:
            if train and cond_mask_infer is None:
                raise NotImplementedError(
                    "random condition masking (training) is not ported yet")
            B, C, L = x.shape
            if cond_mask_infer is None:
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
    ``udit`` is the base model's UDiT config (cross-attention context,
    AdaLN-SOLA time fusion, as the port's UDiT)."""

    def __init__(self, udit: dict, cond_in: int = 1, cond_blocks: Sequence[int] = (64, 128),
                 cond_mask: bool = False):
        super().__init__()
        cfg = dict(udit)
        if cfg.get("context_dim") is None or cfg.get("context_fusion", "cross") != "cross":
            raise NotImplementedError(f"context_fusion={cfg.get('context_fusion')!r}")
        dim = cfg["embed_dim"]
        patch = cfg.get("patch_size", 1)
        self.patch_embed = PatchEmbed1D(patch, cfg["in_chans"], dim)
        self.x_pe = PEWrapper(cfg.get("pe_method", "none"))
        self.controlnet_pre = ControlNetEmbed(cond_in, dim, cond_blocks, cond_mask)
        self.context_embed = MLPEmbedder(cfg["context_dim"], dim)
        self.context_pe = PEWrapper(cfg.get("context_pe_method", "none"))
        self.time_embed = TimestepEmbedder(dim)
        self.time_ada = QuantLinear(dim, 6 * dim)
        half = cfg["depth"] // 2
        self.in_blocks = nn.ModuleList([DiTBlock(
            dim, cfg["num_heads"], context_dim=dim, mlp_ratio=cfg.get("mlp_ratio", 4.0),
            qkv_bias=cfg.get("qkv_bias", False), qk_scale=cfg.get("qk_scale"),
            qk_norm=cfg.get("qk_norm"), act_layer=cfg.get("act_layer", "gelu"),
            norm_layer=cfg.get("norm_layer", "layernorm"),
            time_fusion=cfg.get("time_fusion", "ada_sola_bias"),
            ada_sola_rank=cfg.get("ada_sola_rank", 32),
            ada_sola_alpha=cfg.get("ada_sola_alpha", 32),
            rope_mode=cfg.get("rope_mode", "none"),
            context_norm=cfg.get("context_norm", False)) for _ in range(half)])
        self.controlnet_zero_blocks = nn.ModuleList([QuantLinear(dim, dim)
                                                     for _ in range(half)])

    def forward(self, x, timesteps, context, x_mask=None, context_mask=None, condition=None,
                cond_mask_infer=None, conditioning_scale: float = 1.0, train: bool = False):
        """x: (B, T, in_chans), MaskDiT's concat; timesteps (B,) or scalar;
        context (B, Lc, context_dim); condition (B, T * 2^(stages), cond_in).
        Returns the list of depth // 2 skips (B, T, embed_dim)."""
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        x = self.patch_embed(x) + self.controlnet_pre(condition, cond_mask_infer, train)
        x = self.x_pe(x)
        context_token = self.context_pe(self.context_embed(context))
        time_token = F.silu(self.time_embed(timesteps))
        time_ada = self.time_ada(time_token)
        skips = []
        for blk, zero in zip(self.in_blocks, self.controlnet_zero_blocks):
            x = blk(x, time_token, time_ada, None, context_token, x_mask, context_mask)
            skips.append(zero(x) * conditioning_scale)
        return skips


def controlnet_from_config(model_cfg: dict, controlnet_cfg: dict) -> DiTControlNet:
    """Build from the reference config layout: the ``model:`` block (its
    MAE keys dropped) and the ``controlnet:`` block, whose training-time
    masking keys (``cond_mask_prob``, ``cond_mask_ratio``,
    ``cond_mask_span``) wait for training."""
    cfg = dict(model_cfg)
    for k in ("mae", "mae_prob", "mask_ratio", "mask_span", "input_type"):
        cfg.pop(k, None)
    return DiTControlNet(cfg, cond_in=controlnet_cfg["cond_in"],
                         cond_blocks=controlnet_cfg["cond_blocks"],
                         cond_mask=controlnet_cfg.get("cond_mask", False))


@torch.no_grad()
def init_from_base_(controlnet: DiTControlNet, base_udit: nn.Module) -> DiTControlNet:
    """Copy the base UDiT's embedders and in-blocks into ``controlnet``
    (``SHARED_WITH_BASE``), value by value: the ControlNet keeps its own
    parameters, so loading ControlNet weights leaves the base as it is."""
    for name in SHARED_WITH_BASE:
        getattr(controlnet, name).load_state_dict(getattr(base_udit, name).state_dict())
    return controlnet
