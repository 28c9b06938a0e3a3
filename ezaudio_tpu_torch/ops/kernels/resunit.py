"""Kernel 2: fused Oobleck ResidualUnit (``csrc/resunit.cu``) and its
plain twin.

``fused_residual_unit(x, w7, b7, w1, b1, a1, be1, a2, be2, dilation)``
computes ``x + W1 . snake2(conv7_d(snake1(x)) + b7) + b1`` on channel-last
``x`` (B, L, C) — the function of
``ezaudio_tpu/ops/pallas/resunit.py::fused_residual_unit``, with its
layouts: ``w7`` (7, C, C) as (tap, in, out), ``w1`` (C, C) as (in, out),
``a*``/``be*`` the exp'd per-channel snake parameters.  A CPU tensor goes
to :func:`residual_unit_plain`; a CUDA tensor launches the kernel or
raises.  ``fused_residual_unit.launches`` counts kernel launches, and
``fused_residual_unit.launches_by_dtype`` counts them by input dtype.

Differentiable as the JAX ``custom_vjp`` is: with grad enabled and an
input that requires grad, the call goes through
:class:`FusedResidualUnit`, whose forward is the kernel (the plain twin on
the CPU) and whose backward is the vjp of :func:`residual_unit_plain` at
the saved inputs (``_fru_bwd``), for all nine tensor inputs.  Only forward
launches are counted.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ezaudio_tpu_torch.ops.activations import snake_beta_vae
from ezaudio_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def residual_unit_plain(x, w7, b7, w1, b1, a1, be1, a2, be2, dilation: int):
    """The kernel's function in plain PyTorch, in every dtype: the Pallas
    kernel's (``ezaudio_tpu/ops/pallas/resunit.py::_resunit_kernel``).
    snake1 in f32, rounded to x's dtype; the conv7 taps and ``b7`` summed
    in f32; snake2 in f32, rounded; the 1x1 product, ``b1`` and the
    residual add in f32; one final rounding.  In f32 this is the JAX
    package's ``residual_unit_reference``."""
    dt = x.dtype
    xf = x.float()
    a1, be1, a2, be2 = (t.float() for t in (a1, be1, a2, be2))
    h = snake_beta_vae(xf, a1, be1).to(dt).float()
    h = F.conv1d(h.transpose(1, 2), w7.float().permute(2, 1, 0), b7.float(),
                 padding=3 * dilation, dilation=dilation).transpose(1, 2)
    g = snake_beta_vae(h, a2, be2).to(dt).float()
    return (xf + (g @ w1.float() + b1.float())).to(dt)


def _lib():
    lib = _build.load("resunit")
    fn = lib.ez_resunit_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
    return fn


class FusedResidualUnit(torch.autograd.Function):
    """Kernel forward, plain-recompute backward."""

    @staticmethod
    def forward(ctx, dilation, *args):
        ctx.dilation = dilation
        ctx.save_for_backward(*args)
        return _forward(*args, dilation)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = _plain(*inputs, ctx.dilation)
            grads = torch.autograd.grad(y, inputs, g)
        return (None, *grads)


_plain = residual_unit_plain


def fused_residual_unit(x, w7, b7, w1, b1, a1, be1, a2, be2, dilation: int):
    """Channel-last ``x`` (B, L, C) -> (B, L, C); differentiable in all
    nine tensor inputs."""
    args = (x, w7, b7, w1, b1, a1, be1, a2, be2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedResidualUnit.apply(int(dilation), *args)
    return _forward(*args, dilation)


def _forward(x, w7, b7, w1, b1, a1, be1, a2, be2, dilation: int):
    if x.device.type == "cpu":
        return residual_unit_plain(x, w7, b7, w1, b1, a1, be1, a2, be2, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: unsupported device {x.device}")
    B, L, C = x.shape
    d = int(dilation)
    if w7.shape != (7, C, C) or w1.shape != (C, C) or b7.shape != (C,) or b1.shape != (C,):
        raise ValueError("fused_residual_unit: weight shapes do not match C")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w7, b7, w1, b1)):
        raise TypeError("fused_residual_unit: x and weights must share a float32/bfloat16 dtype")
    for t in (x, w7, b7, w1, b1):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_residual_unit: inputs must be contiguous on one device")
    ab = torch.stack([a1, be1, a2, be2]).to(device=x.device, dtype=torch.float32).contiguous()
    if ab.shape != (4, C):
        raise ValueError("fused_residual_unit: snake parameters must be (C,)")
    y = torch.empty_like(x)
    err = _lib()(x.data_ptr(), w7.data_ptr(), b7.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), ab.data_ptr(), y.data_ptr(), B, L, C, d,
                 _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    # the kernel decides what it takes (C, dilation, shared memory, alignment)
    _build.check(err, f"ez_resunit_fwd on x {tuple(x.shape)} {x.dtype}, dilation {d}")
    _build.count(fused_residual_unit, x.dtype)
    return y


fused_residual_unit.launches = 0
fused_residual_unit.launches_by_dtype = {}
