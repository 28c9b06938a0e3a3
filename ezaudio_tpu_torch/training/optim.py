"""The optimizers of the JAX package's ``training/optim.py::make_optimizer``
(and the ControlNet trainer's plain ``optax.adamw``), computing what its
optax chains compute:

  * ``clip_by_global_norm``: gradients with a global norm ``n >= clip``
    become ``(g / n) * clip``; no ``+1e-6`` in the divisor, unlike
    ``torch.nn.utils.clip_grad_norm_``;
  * ``adamw``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    bias-corrected by ``1 - b^t`` with ``t`` the count after the update,
    ``u = mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the root), plus
    ``weight_decay * p`` where :func:`decay_mask` says so, times
    ``-lr(count)`` with ``count`` taken before it is incremented (the
    first warmup step moves nothing).  ``mu_dtype='bfloat16'`` computes
    the new first moment in f32, uses it for this step's update and
    stores it rounded to bf16 (optax's ``tree.cast`` after the update);
  * ``adafactor`` (optax 0.2.6's chain, in its order): the factored RMS
    of the gradient (decay ``1 - (count + 1)^-0.8``, eps 1e-30 added to
    ``g^2``, factored over the two largest axes when the second largest
    has at least ``factor_min_dim`` entries), a clip of each tensor's
    update to RMS 1, ``* lr(count)``, the momentum ``beta1`` as an EMA
    without debias (kept in ``mu_dtype``), the decoupled decay
    ``learning_rate * weight_decay * p`` on the decay mask, the sign flip;
  * ``MultiSteps``: with ``accumulation_steps = k`` the micro-step
    gradients are averaged (Welford, as optax), and the clip, the update
    and the count fire once per k micro-steps.

The clip, the accumulation and the schedule are :class:`Optimizer`'s; the
update is one of three rules.  f32 AdamW is ``torch.optim.AdamW`` (the
same math), in two parameter groups (decayed, and with ``weight_decay``
0) and fused on CUDA, its ``lr`` set from the schedule before each step;
AdamW with a bf16 first moment (``torch._foreach`` ops) and Adafactor (a
loop over the tensors) are written here.  Each updates the parameters in place, which bumps
their version counters: an int8 weight that ``QuantLinear`` cached is
quantized again at its next use.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

OPTIMIZERS = ("adamw", "adafactor")
MU_DTYPES = {None: None, "bfloat16": torch.bfloat16}


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


def _f32(x: float) -> float:
    return float(np.float32(x))


def _weak(x: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing uses it beside ``like``:
    rounded to ``like``'s dtype."""
    return float(torch.tensor(x, dtype=like.dtype))


class TorchAdamW:
    """f32 AdamW: ``torch.optim.AdamW`` in a decayed and an undecayed group."""

    def __init__(self, params: Dict[str, torch.Tensor], b1, b2, eps, weight_decay,
                 decay: Dict[str, bool]):
        groups = [dict(params=[p for n, p in params.items() if decay[n] == d],
                       weight_decay=weight_decay if d else 0.0) for d in (True, False)]
        fused = bool(params) and all(p.is_cuda for p in params.values())
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=0.0,
                                       betas=(b1, b2), eps=eps,
                                       fused=True if fused else None)

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], lr: float,
             count: int) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g.contiguous()
        self.adamw.step()
        for p in params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])


class AdamMu:
    """AdamW with the first moment kept in ``mu_dtype`` (optax's
    ``scale_by_adam(mu_dtype=)``): ``b1`` rounded to ``mu_dtype`` (JAX's
    weak typing) times ``mu`` in f32, the new moment in f32, used in f32,
    stored rounded."""

    def __init__(self, params: Dict[str, torch.Tensor], b1, b2, eps, weight_decay,
                 decay: Dict[str, bool], mu_dtype: torch.dtype):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.decayed = [decay[n] for n in params]
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params.values()]
        self.nu = [torch.zeros_like(p) for p in params.values()]

    def step(self, params, grads, lr: float, count: int) -> None:
        b1, b2, t = self.b1, self.b2, count + 1
        mu = torch._foreach_mul([g.float() for g in grads], _f32(1 - b1))
        # b1 rounded to mu's dtype (JAX's weak typing), the product in f32 (the
        # jitted step keeps it unrounded)
        torch._foreach_add_(mu, [m.float() * _weak(b1, m) for m in self.mu])
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=_f32(1 - b2))
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        den = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        if self.wd:
            dec = [i for i, d in enumerate(self.decayed) if d]
            torch._foreach_add_([upd[i] for i in dec], [params[i] for i in dec], alpha=self.wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        for dst, src in zip(self.mu, mu):
            dst.copy_(src)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)


def factored_dims(shape, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: (second largest axis, largest axis), or
    None when the tensor is not factored."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """optax 0.2.6's ``adafactor`` chain without parameter scaling (see the
    module docstring); the learning rate is the schedule's."""

    def __init__(self, params: Dict[str, torch.Tensor], momentum: Optional[float],
                 mu_dtype: Optional[torch.dtype], weight_decay_rate: Optional[float],
                 decay: Dict[str, bool], factor_min_dim: int, decay_rate: float = 0.8,
                 eps: float = 1e-30, clipping_threshold: float = 1.0):
        self.momentum, self.wd = momentum, weight_decay_rate
        self.decay_rate, self.eps, self.threshold = decay_rate, eps, clipping_threshold
        self.decayed = [decay[n] for n in params]
        self.dims = [factored_dims(tuple(p.shape), factor_min_dim) for p in params.values()]
        self.v_row, self.v_col, self.v = [], [], []
        for p, dims in zip(params.values(), self.dims):
            if dims is None:
                self.v.append(torch.zeros_like(p))
                self.v_row.append(None)
                self.v_col.append(None)
            else:
                d1, d0 = dims
                self.v_row.append(torch.zeros_like(p.select(d0, 0)))
                self.v_col.append(torch.zeros_like(p.select(d1, 0)))
                self.v.append(None)
        self.ema = ([torch.zeros_like(p, dtype=mu_dtype or torch.float32)
                     for p in params.values()] if momentum else None)

    def step(self, params, grads, lr: float, count: int) -> None:
        beta = _f32(1.0 - (count + 1.0) ** -self.decay_rate)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            g2 = g.square() + self.eps
            if self.dims[i] is not None:
                d1, d0 = self.dims[i]
                vr = self.v_row[i].mul_(beta).add_(g2.mean(d0), alpha=_f32(1 - beta))
                vc = self.v_col[i].mul_(beta).add_(g2.mean(d1), alpha=_f32(1 - beta))
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(rd1, keepdim=True)).pow(-0.5)
                u = g * row.unsqueeze(d0) * vc.pow(-0.5).unsqueeze(d1)
            else:
                v = self.v[i].mul_(beta).add_(g2, alpha=_f32(1 - beta))
                u = g * v.pow(-0.5)
            u = u / torch.clamp(u.square().mean().sqrt() / self.threshold, min=1.0)
            u = u * lr
            if self.ema is not None:
                e = self.ema[i]
                u = u * _f32(1 - self.momentum) + e.float() * _weak(self.momentum, e)
                self.ema[i].copy_(u)
            if self.wd and self.decayed[i]:
                u = u + self.wd * p
            p.sub_(u)

    def state_dict(self) -> dict:
        return {"v_row": self.v_row, "v_col": self.v_col, "v": self.v, "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        for key in ("v_row", "v_col", "v", "ema"):
            for dst, src in zip(getattr(self, key) or [], state[key] or []):
                if dst is not None:
                    dst.copy_(src)


class Optimizer:
    """An optax chain over named parameters: the global-norm clip and the
    accumulation window here, the update by ``rule`` (:class:`TorchAdamW`,
    :class:`AdamMu` or :class:`Adafactor`).  :meth:`update` takes the
    gradients of one micro-step and updates the parameters in place when
    an accumulation window closes."""

    def __init__(self, named_params, lr: Callable[[int], float], rule,
                 grad_clip: Optional[float], accumulation_steps: int):
        self.params = dict(named_params)
        self.lr = lr
        self.rule = rule
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.k = int(accumulation_steps)
        self.count = 0       # updates applied: the schedule's and the moments' count
        self.mini_step = 0   # micro-steps into the accumulation window
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if self.k > 1 else None)

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
        self.rule.step(list(self.params.values()), gs, self.lr(self.count), self.count)
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(list(self.acc.values()))
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "names": list(self.params),
                "rule": type(self.rule).__name__, "state": self.rule.state_dict(),
                "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if (state["names"] != list(self.params) or state["rule"] != type(self.rule).__name__
                or (self.acc is None) != (state["acc"] is None)):
            raise ValueError("optimizer state does not match the parameters or the rule")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.rule.load_state_dict(state["state"])
        for n, t in (self.acc or {}).items():
            t.copy_(state["acc"][n])


def make_optimizer(model: nn.Module, learning_rate: float = 5e-5, beta1: float = 0.9,
                   beta2: float = 0.999, weight_decay: float = 0.01,
                   adam_epsilon: float = 1e-8, warmup: int = 5000,
                   grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1,
                   schedule: str = "customized", total_steps: int = 1_000_000,
                   optimizer: str = "adamw", mu_dtype: Optional[str] = None,
                   factor_min_dim: int = 128) -> Optimizer:
    """The JAX package's optimizer over ``model``'s trainable parameters,
    with the reference's opt_config defaults.  ``optimizer`` is
    ``'adamw'`` or ``'adafactor'``; ``mu_dtype`` (``'bfloat16'``) keeps the
    first moment (Adafactor's momentum) in that dtype."""
    if optimizer not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer={optimizer!r}: one of {OPTIMIZERS}")
    if mu_dtype not in MU_DTYPES:
        raise NotImplementedError(f"mu_dtype={mu_dtype!r}: one of {list(MU_DTYPES)}")
    if schedule == "customized":
        lr = warmup_lr_schedule(learning_rate, warmup)
    elif schedule == "cosine":
        lr = cosine_lr_schedule(learning_rate, total_steps)
    else:
        raise NotImplementedError(schedule)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    mask = decay_mask(model)
    decay = {n: mask[n] for n in named}
    mu = MU_DTYPES[mu_dtype]
    if optimizer == "adafactor":
        # the decay is a raw per-step shrink after the lr: lr * wd at the base lr
        rule = Adafactor(named, beta1 or None, mu,
                         learning_rate * weight_decay if weight_decay else None, decay,
                         factor_min_dim)
    elif mu is None:
        rule = TorchAdamW(named, beta1, beta2, adam_epsilon, weight_decay, decay)
    else:
        rule = AdamMu(named, beta1, beta2, adam_epsilon, weight_decay, decay, mu)
    return Optimizer(named.items(), lr, rule, grad_clip, accumulation_steps)


def make_adamw(named_params: Dict[str, torch.Tensor], lr: Callable[[int], float],
               grad_clip: Optional[float], b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    """``clip_by_global_norm(grad_clip)`` then ``optax.adamw(lr)`` at its
    defaults: weight decay 1e-4 on every parameter given, no mask (the
    ControlNet trainer's chain)."""
    rule = TorchAdamW(named_params, b1, b2, eps, weight_decay,
                      {n: True for n in named_params})
    return Optimizer(named_params.items(), lr, rule, grad_clip, 1)


def named_grads(named_params, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{name: d loss / d param}`` for ``named_params`` (zeros where the
    loss does not reach a parameter, as JAX's gradient has)."""
    names, params = zip(*named_params)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}
