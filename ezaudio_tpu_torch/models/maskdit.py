"""MaskDiT: MAE-masked wrapper around UDiT, inference branches
(counterpart of ``ezaudio_tpu/models/maskdit.py::MaskDiT``).

The UDiT input is ``cat([x, gt, mask_row], channel)`` (2*C + 1 = 257
channels for EzAudio):

  * generation (no ``gt``): gt = ``mask_embed`` everywhere, mask row 1;
  * editing (``gt`` + ``mae_mask_infer``): masked positions take
    ``mask_embed``, the rest keep ``gt``; the mask row is the mask.

``forward_model=False`` returns that concat (and the mask) without running
UDiT, and ``forward_backbone`` runs UDiT on it: the two phases between
which a ControlNet step computes its skips.  Training-time random span
masking (``gt`` without a mask) raises until training is ported.  Latents
are channel-last (B, L, C).
"""

from __future__ import annotations

import torch
from torch import nn

from ezaudio_tpu_torch.models.udit import UDiT


class MaskDiT(nn.Module):
    def __init__(self, mae: bool = False, udit: dict | None = None):
        super().__init__()
        kwargs = dict(udit or {})
        self.model = UDiT(**kwargs)
        self.mae = mae
        if mae:
            out_chans = kwargs.get("out_chans") or kwargs.get("in_chans")
            self.mask_embed = nn.Parameter(torch.zeros(out_chans))

    def forward(self, x, timesteps, context=None, x_mask=None, context_mask=None,
                gt=None, mae_mask_infer=None, forward_model=True, controlnet_skips=None,
                collect_deep_k=None, deep_cache=None):
        """Returns (output, mae_mask) with mae_mask float (B, L, C); with
        ``forward_model=False`` the output is UDiT's input, the concat.
        ``collect_deep_k`` / ``deep_cache`` go to UDiT's layer caching;
        with ``collect_deep_k`` the output is the pair ``(out, deep)``."""
        B, L, C = x.shape
        mae_mask = torch.ones_like(x)
        if self.mae:
            embed = self.mask_embed.to(x.dtype)[None, None, :].expand(B, L, -1)
            if gt is not None:
                if mae_mask_infer is None:
                    raise NotImplementedError(
                        "random span masking (training) is not ported yet")
                mask = mae_mask_infer.bool().expand(gt.shape)
                gt = torch.where(mask, embed, gt)
                mae_mask = mask.to(x.dtype)
            else:
                gt = embed
            x = torch.cat([x, gt, mae_mask[:, :, 0:1]], dim=-1)
        if not forward_model:
            return x, mae_mask
        out = self.model(x, timesteps, context, x_mask=x_mask, context_mask=context_mask,
                         controlnet_skips=controlnet_skips,
                         collect_deep_k=collect_deep_k, deep_cache=deep_cache)
        return out, mae_mask

    def forward_backbone(self, x_concat, timesteps, context=None, x_mask=None,
                         context_mask=None, controlnet_skips=None):
        """UDiT on an already concatenated input (``forward_model=False``'s
        output), the ControlNet step's second phase; returns its output."""
        return self.model(x_concat, timesteps, context, x_mask=x_mask,
                          context_mask=context_mask, controlnet_skips=controlnet_skips)


_MAE_ONLY_KEYS = ("mae_prob", "mask_ratio", "mask_span", "input_type")


def maskdit_from_config(model_cfg: dict) -> MaskDiT:
    """Build MaskDiT from a reference-format ``model:`` config block."""
    cfg = dict(model_cfg)
    mae = cfg.pop("mae", False)
    for k in _MAE_ONLY_KEYS:
        cfg.pop(k, None)
    return MaskDiT(mae=mae, udit=cfg)
