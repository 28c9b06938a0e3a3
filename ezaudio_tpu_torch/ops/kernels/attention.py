"""Kernel 1: attention forward (``csrc/attention.cu``) and its plain twin.

``fused_attention(q, k, v, key_mask, scale)`` computes, per (batch, head),
``o = softmax(scale * q k^T + bias) v`` with ``bias`` = 0 or -1e30 from
the (B, Lk) key mask — the function of
``ezaudio_tpu/ops/pallas/attention.py::fused_attention``.  A CPU tensor
goes to :func:`attention_plain`; a CUDA tensor launches the kernel or
raises.  ``fused_attention.launches`` counts kernel launches, and
``fused_attention.launches_by_dtype`` counts them by input dtype.

Differentiable as ``_fused_attention_diff`` is: with grad enabled and an
input that requires grad, the call goes through :class:`FusedAttention`,
whose forward is the kernel (the plain twin on the CPU) and whose
backward recomputes the plain twin and takes its vjp
(``_fused_attention_bwd``).  It saves q, k, v and the mask, never the
score matrix.  Only forward launches are counted.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ezaudio_tpu_torch.ops.attention import dot_product_attention
from ezaudio_tpu_torch.ops.kernels import _build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, Lk) bool key mask -> additive f32 bias, 0 or -1e30."""
    return torch.where(key_mask.bool(), 0.0, _NEG).to(torch.float32)


def _plain(q, k, v, key_mask, scale):
    mask = None if key_mask is None else key_mask.bool()[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask, scale=scale)


def attention_plain(q, k, v, key_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """The kernel's function in plain PyTorch: :func:`dot_product_attention`
    (f32 scores and softmax, ``p`` rounded to the value dtype, f32
    accumulation) with the (B, Lk) key mask broadcast over heads and
    queries.  A masked logit of ``-finfo.max`` there and one of ``s - 1e30``
    in the kernel both give ``p = 0`` beside any attended key."""
    mask = None if key_mask is None else key_mask.bool()[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask, scale=scale)


def _lib():
    lib = _build.load("attention")
    fn = lib.ez_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
    return fn


class FusedAttention(torch.autograd.Function):
    """Kernel forward, plain-recompute backward: the gradients of q, k and
    v are the vjp of :func:`attention_plain` at the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, key_mask)
        return _forward(q, k, v, key_mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            o = _plain(*inputs, key_mask, ctx.scale)
            dq, dk, dv = torch.autograd.grad(o, inputs, g)
        return dq, dk, dv, None, None


def fused_attention(q, k, v, key_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D), optional (B, Lk)
    boolean key mask (True = attend); differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttention.apply(q, k, v, key_mask, scale)
    return _forward(q, k, v, key_mask, scale)


def _forward(q, k, v, key_mask, scale):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"fused_attention: shapes {q.shape} {k.shape} {v.shape}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: dtypes {q.dtype} {k.dtype} {v.dtype}")
    if D > 128:
        raise ValueError(f"fused_attention: head_dim {D} > 128")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("fused_attention: q, k, v must be contiguous on one device")
    bias = None
    if key_mask is not None:
        if key_mask.shape != (B, Lk) or key_mask.device != q.device:
            raise ValueError(f"fused_attention: key_mask {tuple(key_mask.shape)}")
        bias = key_bias(key_mask).contiguous()
    o = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), o.data_ptr(),
                 B, H, Lq, Lk, D, float(scale), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ez_attention_fwd")
    _build.count(fused_attention, q.dtype)
    return o


fused_attention.launches = 0
fused_attention.launches_by_dtype = {}
