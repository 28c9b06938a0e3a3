"""Plain scaled dot-product attention
(counterpart of ``ezaudio_tpu/ops/attention.py::dot_product_attention``).

``mask`` is boolean, True = attend; masked logits are filled with the most
negative finite value of the softmax dtype before an f32 softmax (reference
attention.py:20-27).  The DiT itself goes through
``ops/kernels/attention.py::fused_attention``, whose plain version
(``attention_plain``) is this function with a (B, Lk) key mask.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None):
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D); ``mask``
    broadcasts against (B, H, Lq, Lk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * scale
    if mask is not None:
        neg = torch.finfo(logits.dtype).max
        logits = logits.masked_fill(~mask, -neg)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
