"""Plain scaled dot-product attention and the attention-implementation
switch (counterpart of ``ezaudio_tpu/ops/attention.py`` and of
``attention_impl_context`` in ``ezaudio_tpu/models/blocks.py``).

``mask`` is boolean, True = attend; masked logits are filled with the most
negative finite value of the softmax dtype before the softmax (reference
attention.py:20-27).  The DiT goes through
``ops/kernels/attention.py::fused_attention``, whose plain version
(``attention_plain``) is :func:`dot_product_attention` with f32 logits and
a (B, Lk) key mask, unless ``attention_impl_context`` names one of
``BF16_IMPLS``: the JAX package's einsum formulations with bf16 logits and
softmax, another function than kernel 1's, which run here as plain torch
ops on every device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

# attention implementations of the JAX package whose logits and softmax are
# bf16 (``models/blocks.py:236-250``); the others compute kernel 1's function
BF16_IMPLS = ("bf16", "chunked_bf16")

_state = threading.local()


@contextlib.contextmanager
def attention_impl_context(impl: Optional[str]):
    """The attention implementation of the DiT's blocks inside, per thread;
    ``None`` keeps the enclosing one."""
    prev = getattr(_state, "impl", None)
    _state.impl = impl if impl is not None else prev
    try:
        yield
    finally:
        _state.impl = prev


def current_attention_impl() -> Optional[str]:
    return getattr(_state, "impl", None)


def _softmax(x):
    """``jax.nn.softmax`` in x's dtype, op by op: max, exp of the shifted
    logits, division by their sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def dot_product_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          softmax_dtype: torch.dtype = torch.float32):
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D); ``mask``
    broadcasts against (B, H, Lq, Lk).  ``softmax_dtype``: the dtype of the
    logits and the softmax (f32, or bf16 for the ``BF16_IMPLS``); ``p`` is
    rounded to v's dtype and P.V accumulates in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    f32 = softmax_dtype == torch.float32
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if not f32:  # einsum(preferred_element_type=bf16) * bf16(scale), as JAX
        scale = float(torch.tensor(scale, dtype=softmax_dtype))
        logits = logits.to(softmax_dtype)
    logits = logits * scale
    if mask is not None:
        neg = torch.finfo(logits.dtype).max
        logits = logits.masked_fill(~mask, -neg)
    weights = torch.softmax(logits, dim=-1) if f32 else _softmax(logits)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def chunked_dot_product_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                                  scale: Optional[float] = None, q_chunk: int = 128,
                                  softmax_dtype: torch.dtype = torch.float32):
    """:func:`dot_product_attention` over query tiles of ``q_chunk`` rows,
    so one (B, H, q_chunk, Lk) score tile is live at a time; ``mask`` must
    not depend on the query (shape (..., 1, Lk))."""
    if mask is not None and (mask.ndim != 4 or mask.shape[2] != 1):
        raise ValueError("chunked attention needs a query-independent mask, "
                         f"got {tuple(mask.shape)}")
    return torch.cat([dot_product_attention(q[:, :, i: i + q_chunk], k, v, mask, scale,
                                            softmax_dtype)
                      for i in range(0, q.shape[2], q_chunk)], dim=2)
