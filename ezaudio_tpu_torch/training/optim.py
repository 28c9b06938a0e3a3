"""AdamW with the reference's weight-decay split, warmup, global-norm clip
and gradient accumulation (counterpart of
``ezaudio_tpu/training/optim.py::make_optimizer``) that computes what the
JAX package's optax chain computes:

  * ``clip_by_global_norm``: gradients with a global norm ``n >= clip``
    become ``(g / n) * clip``; no ``+1e-6`` in the divisor, unlike
    ``torch.nn.utils.clip_grad_norm_``;
  * ``adamw``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    bias-corrected by ``1 - b^t`` with ``t`` the count after the update,
    ``u = mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the root), plus
    ``weight_decay * p`` where :func:`decay_mask` says so, times
    ``-lr(count)`` with ``count`` taken before it is incremented (the
    first warmup step moves nothing);
  * ``MultiSteps``: with ``accumulation_steps = k`` the micro-step
    gradients are averaged (Welford, as optax), and the clip, the update
    and the count fire once per k micro-steps.

The clip, the accumulation and the schedule are written here; the moment
update is ``torch.optim.AdamW`` (the same math: eps outside the root,
bias correction, decay as ``lr * wd * p``), in two parameter groups
(decayed, and with ``weight_decay`` 0) and fused on CUDA, its ``lr`` set
from the schedule before each step.  It updates the parameters in place,
which bumps their version counters: an int8 weight that ``QuantLinear``
cached is quantized again at its next use.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

_UNPORTED = "is not ported yet (ROADMAP queue 1 item 6)"


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True iff it is the weight of an ``nn.Linear``
    (``QuantLinear`` too) or of a convolution: the leaves the JAX package
    names ``kernel``.  Biases, norms, ``mask_embed`` and
    ``scale_shift_table`` are not decayed."""
    convs = (nn.Linear, nn.modules.conv._ConvNd)
    out = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = (pname == "weight"
                                                           and isinstance(m, convs))
    return {n: out[n] for n, _ in model.named_parameters()}


def warmup_lr_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    """``lr * min(count / warmup, 1)`` in f32: the reference's 'customized'."""
    def fn(count: int) -> float:
        if warmup_steps <= 0:
            return base_lr
        ratio = np.float32(count) / np.float32(warmup_steps)
        return float(np.float32(base_lr) * np.minimum(ratio, np.float32(1.0)))
    return fn


def cosine_lr_schedule(base_lr: float, decay_steps: int,
                       eta_min: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(base_lr, decay_steps, alpha)`` in f32."""
    alpha = np.float32(eta_min / max(base_lr, 1e-12))

    def fn(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c
                                                          / np.float32(decay_steps)))
        return float(np.float32(base_lr) * ((np.float32(1) - alpha) * cos + alpha))
    return fn


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element, f32, on the device.
    Each tensor's squares go through ``sum`` (a cascade sum on the CPU):
    torch's CPU ``vector_norm`` and ``_foreach_norm`` of a 16M-element f32
    tensor read 7e-4 off its float64 value (torch 2.13)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class AdamW:
    """The optax chain of :func:`make_optimizer` over named parameters.
    :meth:`update` takes the gradients of one micro-step and updates the
    parameters in place when an accumulation window closes."""

    def __init__(self, named_params, lr: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float, decay: Dict[str, bool],
                 grad_clip: Optional[float], accumulation_steps: int):
        self.params = dict(named_params)
        self.lr = lr
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.k = int(accumulation_steps)
        self.count = 0       # updates applied: the schedule's and Adam's count
        self.mini_step = 0   # micro-steps into the accumulation window
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if self.k > 1 else None)
        groups = [dict(params=[p for n, p in self.params.items() if decay[n] == d],
                       weight_decay=weight_decay if d else 0.0) for d in (True, False)]
        self.fused = bool(self.params) and all(p.is_cuda for p in self.params.values())
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=lr(0),
                                       betas=(b1, b2), eps=eps,
                                       fused=True if self.fused else None)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor],
               grad_norm: Optional[torch.Tensor] = None) -> bool:
        """One micro-step; returns whether the parameters moved.  The
        gradients given are not changed; ``grad_norm``, their global norm
        where the caller has it, spares computing it again for the clip."""
        names = list(self.params)
        gs = [grads[n] for n in names]
        if self.acc is not None:
            acc = [self.acc[n] for n in names]
            # Welford: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(gs, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            del delta
            emit = self.mini_step == self.k - 1
            self.mini_step = (self.mini_step + 1) % self.k
            if not emit:
                return False
            gs, grad_norm = acc, None
        if self.grad_clip is not None:
            n = global_norm(gs) if grad_norm is None else grad_norm
            if not bool(n < self.grad_clip):  # one sync a step
                gs = torch._foreach_div(gs, n)
                torch._foreach_mul_(gs, self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(self.count)
        self.count += 1
        params = list(self.params.values())
        for p, g in zip(params, gs):
            p.grad = g.contiguous()
        self.adamw.step()
        for p in params:
            p.grad = None
        if self.acc is not None:
            torch._foreach_zero_(list(self.acc.values()))
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "names": list(self.params),
                "adamw": self.adamw.state_dict(), "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if state["names"] != list(self.params) or (self.acc is None) != (state["acc"] is None):
            raise ValueError("optimizer state does not match the parameters")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.adamw.load_state_dict(state["adamw"])
        for n, t in (self.acc or {}).items():
            t.copy_(state["acc"][n])


def make_optimizer(model: nn.Module, learning_rate: float = 5e-5, beta1: float = 0.9,
                   beta2: float = 0.999, weight_decay: float = 0.01,
                   adam_epsilon: float = 1e-8, warmup: int = 5000,
                   grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1,
                   schedule: str = "customized", total_steps: int = 1_000_000,
                   optimizer: str = "adamw", mu_dtype: Optional[str] = None) -> AdamW:
    """AdamW over ``model``'s trainable parameters with the reference's
    opt_config defaults.  ``optimizer='adafactor'`` and ``mu_dtype``
    raise ``NotImplementedError``."""
    if optimizer != "adamw":
        raise NotImplementedError(f"optimizer={optimizer!r} {_UNPORTED}")
    if mu_dtype is not None:
        raise NotImplementedError(f"mu_dtype={mu_dtype!r} {_UNPORTED}")
    if schedule == "customized":
        lr = warmup_lr_schedule(learning_rate, warmup)
    elif schedule == "cosine":
        lr = cosine_lr_schedule(learning_rate, total_steps)
    else:
        raise NotImplementedError(schedule)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    mask = decay_mask(model)
    return AdamW(named, lr, beta1, beta2, adam_epsilon, weight_decay,
                 {n: mask[n] for n, _ in named}, grad_clip, accumulation_steps)


def named_grads(named_params, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{name: d loss / d param}`` for ``named_params`` (zeros where the
    loss does not reach a parameter, as JAX's gradient has)."""
    names, params = zip(*named_params)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}
