"""The alternative CFG and conditioning wrappers (counterpart of
``ezaudio_tpu/models/cfg_wrappers.py``; the reference's non-MaskDiT
conditioners, conditioners.py:10-120):

  * ``EmbeddingCFG``: a learned null embedding ``cfg_embedding``, drawn
    N(0, 1) / sqrt(C), swapped in for a row with probability ``cfg_prob``;
    a dropped row's mask keeps position 0 alone;
  * ``DiscreteCFG``: token-id dropout, a dropped row becomes
    ``[replace_id, 0, 0, ...]``;
  * ``CFGModel``: a backbone whose context goes through an EmbeddingCFG;
  * ``ConcatModel``: a strided conv pyramid (``down.<i>``: kernel 2s,
    stride s, padding ceil(s/2), channels doubled) brings the condition to
    the latent frame rate, an EmbeddingCFG drops it, and it joins x on the
    channels before the backbone (which then gets no context).

Dropout applies whenever ``cfg_prob > 0``: the caller passes 0 at
inference, as the reference's callers do.  The drop decision of a row is
``uniform < cfg_prob``, drawn from an explicit ``generator``; ``drop``
(B,) bool hands the decisions in instead (a parity test gives the JAX
package's, which torch cannot draw: ROADMAP F1).  Inputs are channel-last.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ezaudio_tpu_torch.ops.convs import Conv1d


def _drop(batch: int, cfg_prob: float, drop, generator, device):
    if drop is not None:
        return torch.as_tensor(drop, device=device).bool()
    return torch.rand(batch, generator=generator, device=device) < cfg_prob


class EmbeddingCFG(nn.Module):
    """Learned null embedding swapped in with probability ``cfg_prob``."""

    def __init__(self, in_channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        null = torch.randn(in_channels, generator=generator,
                           device=None if generator is None else generator.device)
        null = null / math.sqrt(in_channels)
        self.cfg_embedding = nn.Parameter(null)

    def forward(self, condition, condition_mask=None, cfg_prob: float = 0.0, drop=None,
                generator: Optional[torch.Generator] = None):
        """condition (B, L, C), condition_mask (B, L) bool or None; returns
        both, the dropped rows replaced."""
        if cfg_prob <= 0:
            return condition, condition_mask
        d = _drop(condition.shape[0], cfg_prob, drop, generator, condition.device)
        null = self.cfg_embedding.to(condition.dtype)[None, None, :].expand_as(condition)
        condition = torch.where(d[:, None, None], null, condition)
        if condition_mask is not None:
            first = torch.zeros_like(condition_mask, dtype=torch.bool)
            first[:, 0] = True
            condition_mask = torch.where(d[:, None], first, condition_mask.bool())
        return condition, condition_mask


class DiscreteCFG(nn.Module):
    """Token-id CFG dropout: dropped rows become ``[replace_id, 0, 0, ...]``."""

    def __init__(self, replace_id: int = 2):
        super().__init__()
        self.replace_id = replace_id

    def forward(self, context, context_mask=None, cfg_prob: float = 0.0, drop=None,
                generator: Optional[torch.Generator] = None):
        """context (B, L) ids, context_mask (B, L) bool or None."""
        if cfg_prob <= 0:
            return context, context_mask
        d = _drop(context.shape[0], cfg_prob, drop, generator, context.device)
        dropped = torch.zeros_like(context)
        dropped[:, 0] = self.replace_id
        context = torch.where(d[:, None], dropped, context)
        if context_mask is not None:
            first = torch.zeros_like(context_mask, dtype=torch.bool)
            first[:, 0] = True
            context_mask = torch.where(d[:, None], first, context_mask.bool())
        return context, context_mask


class CFGModel(nn.Module):
    """``backbone`` with an EmbeddingCFG-dropped context (``context_cfg``)."""

    def __init__(self, context_dim: int, backbone: nn.Module,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.context_cfg = EmbeddingCFG(context_dim, generator)
        self.backbone = backbone

    def forward(self, x, timesteps, context, x_mask=None, context_mask=None,
                cfg_prob: float = 0.0, drop=None, generator: Optional[torch.Generator] = None):
        context, context_mask = self.context_cfg(context, context_mask, cfg_prob, drop,
                                                 generator)
        return self.backbone(x, timesteps, context, x_mask=x_mask, context_mask=context_mask)


class ConcatModel(nn.Module):
    """Channel-concat conditioning: ``down`` brings the condition (B, T,
    in_dim) to x's frames, ``context_cfg`` drops it, and ``[condition, x]``
    goes to ``backbone`` with no context."""

    def __init__(self, backbone: nn.Module, in_dim: int, strides: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = backbone
        convs, dim = [], in_dim
        for s in strides:
            convs.append(Conv1d(dim, dim * 2, 2 * s, stride=s, padding=math.ceil(s / 2)))
            dim *= 2
        self.down = nn.ModuleList(convs)
        self.context_cfg = EmbeddingCFG(dim, generator)

    def forward(self, x, timesteps, context, x_mask=None, cfg_prob: float = 0.0, drop=None,
                generator: Optional[torch.Generator] = None):
        h = context.transpose(1, 2)
        for conv in self.down:
            h = conv(h)
        context, _ = self.context_cfg(h.transpose(1, 2), None, cfg_prob, drop, generator)
        if context.shape[1] != x.shape[1]:
            raise ValueError(f"condition frames {context.shape[1]} after the pyramid, "
                             f"x frames {x.shape[1]}")
        x = torch.cat([context.to(x.dtype), x], dim=-1)
        return self.backbone(x, timesteps, None, x_mask=x_mask, context_mask=None)
