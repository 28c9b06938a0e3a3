"""MaskDiT: MAE-masked wrapper around UDiT
(counterpart of ``ezaudio_tpu/models/maskdit.py::MaskDiT``).

The UDiT input is ``cat([x, gt, mask_row], channel)`` (2*C + 1 = 257
channels for EzAudio):

  * generation (no ``gt``): gt = ``mask_embed`` everywhere, mask row 1;
  * editing (``gt`` + ``mae_mask_infer``): masked positions take
    ``mask_embed``, the rest keep ``gt``; the mask row is the mask;
  * training (``gt`` alone): per-sample ratios in ``mask_ratio``, span
    masks of ``mask_span`` frames, applied to a ``mae_prob`` share of the
    batch; the other samples get a fully masked ``gt``.  The draws come
    in ``mask_draws`` (:meth:`MaskDiT.draw_mask`), so a test can hand in
    the JAX package's (ROADMAP F1).

``forward_model=False`` returns that concat (and the mask) without running
UDiT, and ``forward_backbone`` runs UDiT on it: the two phases between
which a ControlNet step computes its skips.  Latents are channel-last
(B, L, C).
"""

from __future__ import annotations

import torch
from torch import nn

from ezaudio_tpu_torch.models.span_mask import span_mask_from_draws, train_mask_draws
from ezaudio_tpu_torch.models.udit import UDiT


class MaskDiT(nn.Module):
    def __init__(self, mae: bool = False, udit: dict | None = None, mae_prob: float = 0.5,
                 mask_ratio=(0.25, 1.0), mask_span: int = 10):
        super().__init__()
        kwargs = dict(udit or {})
        self.model = UDiT(**kwargs)
        self.mae = mae
        self.mae_prob = float(mae_prob)
        self.mask_ratio = tuple(float(r) for r in mask_ratio)
        self.mask_span = int(mask_span)
        if mae:
            out_chans = kwargs.get("out_chans") or kwargs.get("in_chans")
            self.mask_embed = nn.Parameter(torch.zeros(out_chans))

    def draw_mask(self, generator, batch: int, length: int, device) -> dict:
        """The training branch's draws: ``ratio`` (B,) uniform in
        ``mask_ratio``, the span mask's ``span_round`` (B,) and
        ``span_scores`` (B, n_pos), and the MAE selection uniforms
        ``select`` (B,)."""
        return train_mask_draws(generator, batch, length, self.mask_ratio, self.mask_span,
                                device)

    def forward(self, x, timesteps, context=None, x_mask=None, context_mask=None,
                cls_token=None, gt=None, mae_mask_infer=None, forward_model=True,
                controlnet_skips=None, collect_deep_k=None, deep_cache=None, mask_draws=None):
        """Returns (output, mae_mask) with mae_mask float (B, L, C); with
        ``forward_model=False`` the output is UDiT's input, the concat.
        ``collect_deep_k`` / ``deep_cache`` go to UDiT's layer caching;
        with ``collect_deep_k`` the output is the pair ``(out, deep)``.
        ``gt`` without ``mae_mask_infer`` is the training branch, which
        needs ``mask_draws`` (:meth:`draw_mask`)."""
        B, L, C = x.shape
        mae_mask = torch.ones_like(x)
        if self.mae:
            embed = self.mask_embed.to(x.dtype)[None, None, :].expand(B, L, -1)
            if gt is not None and mae_mask_infer is not None:
                mask = mae_mask_infer.bool().expand(gt.shape)
                gt = torch.where(mask, embed, gt)
                mae_mask = mask.to(x.dtype)
            elif gt is not None:
                if mask_draws is None:
                    raise ValueError("gt without mae_mask_infer is the training branch: "
                                     "pass mask_draws (MaskDiT.draw_mask)")
                d = mask_draws
                span = span_mask_from_draws(d["span_round"], d["span_scores"], L,
                                            d["ratio"], self.mask_span)
                mask = span[:, :, None].expand(gt.shape)
                # samples not selected for MAE get a fully masked gt
                sel = (d["select"] < self.mae_prob)[:, None, None]
                gt = torch.where(sel & mask | ~sel, embed, gt)
                mae_mask = torch.where(sel, mask.to(x.dtype), torch.ones_like(mae_mask))
            else:
                gt = embed
            x = torch.cat([x, gt, mae_mask[:, :, 0:1]], dim=-1)
        if not forward_model:
            return x, mae_mask
        out = self.model(x, timesteps, context, x_mask=x_mask, context_mask=context_mask,
                         cls_token=cls_token, controlnet_skips=controlnet_skips,
                         collect_deep_k=collect_deep_k, deep_cache=deep_cache)
        return out, mae_mask

    def forward_backbone(self, x_concat, timesteps, context=None, x_mask=None,
                         context_mask=None, cls_token=None, controlnet_skips=None):
        """UDiT on an already concatenated input (``forward_model=False``'s
        output), the ControlNet step's second phase; returns its output."""
        return self.model(x_concat, timesteps, context, x_mask=x_mask,
                          context_mask=context_mask, cls_token=cls_token,
                          controlnet_skips=controlnet_skips)


def maskdit_from_config(model_cfg: dict) -> MaskDiT:
    """Build MaskDiT from a reference-format ``model:`` config block: the
    MAE keys, and every UDiT switch.  MaskDiT concatenates along the
    channels of a 1d sequence, so an ``input_type`` other than ``'1d'``
    raises (the JAX reader drops the key)."""
    cfg = dict(model_cfg)
    input_type = cfg.pop("input_type", "1d")
    if input_type != "1d":
        raise NotImplementedError(f"MaskDiT input_type={input_type!r}: only '1d'")
    return MaskDiT(mae=cfg.pop("mae", False), mae_prob=cfg.pop("mae_prob", 0.5),
                   mask_ratio=cfg.pop("mask_ratio", (0.25, 1.0)),
                   mask_span=cfg.pop("mask_span", 10), udit=cfg)
