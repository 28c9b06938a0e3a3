"""Fixed-shape span masking (counterpart of
``ezaudio_tpu/models/span_mask.py::compute_span_mask``), split in two so
that a test can hand in the JAX package's draws (ROADMAP F1):
:func:`span_mask_draws` makes the random numbers from a
``torch.Generator``, :func:`span_mask_from_draws` is a deterministic
function of them.

  * number of spans: ``num = max(min_masks, floor(p * L / span + U[0, 1)))``,
    clipped to the candidates;
  * span starts: ``num`` distinct positions of ``[0, L - span)``, the
    top-k of i.i.d. uniform scores (``torch.topk`` for ``lax.top_k``);
  * the mask is the union of the ``[start, start + span)`` intervals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def span_mask_draws(generator: Optional[torch.Generator], batch: int, length: int,
                    mask_length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rounding uniforms (batch,) and the start scores (batch, n_pos),
    ``n_pos = max(1, length - mask_length)`` candidate starts."""
    u = torch.rand(batch, generator=generator, device=device)
    scores = torch.rand(batch, max(1, length - mask_length), generator=generator,
                        device=device)
    return u, scores


def span_mask_from_draws(u: torch.Tensor, scores: torch.Tensor, length: int,
                         mask_prob: torch.Tensor, mask_length: int,
                         min_masks: int = 1) -> torch.Tensor:
    """Boolean mask (batch, length), True = masked; ``mask_prob`` (batch,)."""
    n_pos = scores.shape[1]
    max_spans = min(length // mask_length + 1, n_pos)
    num = torch.floor(mask_prob * length / float(mask_length) + u).to(torch.int32)
    num = num.clamp(min(min_masks, max_spans), max_spans)
    starts = torch.topk(scores, max_spans, dim=1).indices  # distinct
    valid = torch.arange(max_spans, device=u.device)[None, :] < num[:, None]
    starts = torch.where(valid, starts, -(length + mask_length))  # inert sentinel
    pos = torch.arange(length, device=u.device)[None, None, :]
    s = starts[:, :, None]
    return ((pos >= s) & (pos < s + mask_length)).any(dim=1)

