"""Dynamic int8 (W8A8) quantization of the DiT's linear layers
(counterpart of ``ezaudio_tpu/ops/quant.py`` and of the int8 branch of
``ezaudio_tpu/ops/convs.py::Linear``).

Scheme, as the JAX package: symmetric and zero-point-free; weights per
output channel, activations per row (token), both ``amax / 127`` with a
floor of 1e-8, rounded half to even and clipped to +-127; the product
accumulates in int32 and is rescaled in f32 as ``y * x_scale * w_scale``.
Inference only (``round`` has no gradient).

The int8 x int8 -> int32 product (:func:`int8_matmul`) runs on a CUDA
tensor as ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM), whose
checks ask for more than 16 rows and K, N multiples of 8: fewer rows are
padded with zero rows, which leaves the int32 sums as they are.  A refused
product raises; nothing falls back to a float product.  On a CPU tensor
the plain version computes the same sums exactly in float64 (integers up
to 2^53; here at most K * 127^2).

``quant_context('int8')`` opts the :class:`QuantLinear` layers with
``in * out >= MIN_QUANT_ELEMENTS`` into the int8 route while it is open;
``EZAUDIO_QUANT=int8`` in the environment does the same where no context
says otherwise, and ``quant_context('off')`` turns both off.  Only the
DiT builds :class:`QuantLinear`: T5 and the VAE stay in float.  In a
bf16 model the product returns f32 and is cast to the activations' dtype
before the bias, as the JAX ``Linear`` casts ``int8_dot``'s output.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Layers smaller than this (in_features * out_features) stay in float:
# the quantize and rescale cost outweighs the int8 product on tiny matmuls.
MIN_QUANT_ELEMENTS = 256 * 256
_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def quantize_symmetric(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim``: ``(q, scale)`` with
    ``x ~= q * scale``, q int8 in [-127, 127], ``scale`` keeping ``dim`` as 1."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    # a divisor on x's device: CUDA multiplies by the reciprocal of a host
    # scalar divisor, one ulp away from the division the plain version makes
    scale = amax.clamp(min=1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for int8 ``a`` (M, K) and ``b`` (N, K) as int32, exact:
    float64 holds every partial sum (|sum| <= K * 127^2 < 2^53)."""
    return (a.double() @ b.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` (M, K) times int8 ``b`` (N, K) transposed -> int32 (M, N).
    A CPU tensor takes :func:`int8_matmul_plain`; a CUDA tensor goes to
    ``torch._int_mm`` (a row-major, b column-major), or raises."""
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    M = a.shape[0]
    if M < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - M))
    return torch._int_mm(a.contiguous(), b.contiguous().t())[:M]


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``x @ W.T`` for a weight quantized per output channel: ``wq`` (N, K)
    int8 and ``ws`` (N, 1) f32 from ``quantize_symmetric(W, -1)``; ``x``
    (..., K) is quantized per row.  Returns f32 (..., N)."""
    K, N = x.shape[-1], wq.shape[0]
    xq, xs = quantize_symmetric(x.float(), -1)
    y = int8_matmul(xq.reshape(-1, K), wq).reshape(*x.shape[:-1], N)
    return y.float() * xs * ws.reshape(N)


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with dynamic W8A8 quantization, ``w`` (K, N) as the JAX
    package lays it out (quantized per output channel, along K)."""
    wq, ws = quantize_symmetric(w.float().t(), -1)
    return int8_linear(x, wq, ws)


# ---------------------------------------------------------------------------
# Ambient quant mode, per thread: opts the DiT into int8 without threading a
# flag through every module.
# ---------------------------------------------------------------------------

_state = threading.local()


@contextlib.contextmanager
def quant_context(mode: Optional[str]):
    """``with quant_context('int8'):`` routes the large :class:`QuantLinear`
    layers through int8 inside.  ``None`` defers to ``EZAUDIO_QUANT``;
    ``'off'`` disables quantization, the environment's included."""
    if mode not in (None, "int8", "off"):
        raise ValueError(f"quant mode must be None, 'int8' or 'off', got {mode!r}")
    prev = getattr(_state, "mode", None)
    _state.mode = mode
    try:
        yield
    finally:
        _state.mode = prev


def current_quant_mode() -> Optional[str]:
    mode = getattr(_state, "mode", None)
    if mode == "off":
        return None
    if mode is None:
        mode = os.environ.get("EZAUDIO_QUANT") or None
    return mode


class QuantLinear(nn.Linear):
    """``nn.Linear`` (same parameters and names) whose product goes through
    :func:`int8_linear` while the quant mode is ``'int8'`` and the layer has
    at least ``MIN_QUANT_ELEMENTS`` weights.  The quantized weight is kept
    while the weight tensor is unchanged (its storage and version)."""

    _wq_key = None

    def _weight_key(self):
        return (self.weight.data_ptr(), self.weight._version, self.weight.device)

    def cast_(self, dtype, cast=None):
        """Cast weight and bias to ``dtype`` (``utils.cast_params_``),
        quantizing the int8 weight first from the f32 weight: the JAX
        package quantizes its f32 parameter, not a bf16 copy.  With
        ``cast``, weight and bias go to it and nothing is quantized."""
        if cast is not None:
            for name, _ in self.named_parameters(recurse=False):
                cast(self, name)
            return
        if self.weight.dtype == dtype:
            return
        self._wq = quantize_symmetric(self.weight.detach().float(), -1)
        for p in self.parameters(recurse=False):
            p.data = p.data.to(dtype)
        self._wq_key = self._weight_key()

    def forward(self, x):
        if (current_quant_mode() != "int8"
                or self.in_features * self.out_features < MIN_QUANT_ELEMENTS):
            return super().forward(x)
        key = self._weight_key()
        if self._wq_key != key:
            self._wq = quantize_symmetric(self.weight.detach().float(), -1)
            self._wq_key = key
        y = int8_linear(x, *self._wq).to(x.dtype)
        return y if self.bias is None else y + self.bias
