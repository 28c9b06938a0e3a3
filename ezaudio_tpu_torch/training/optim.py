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
    tensor read 7e-4 off its float64 value (torch 2.13).

    A DTensor (a parameter sharded by ``parallel/sharding.py``: FSDP2's
    or tensor parallelism's) counts its whole value: its shard's squares,
    summed over the mesh dimensions it is sharded on (one all-reduce per
    group), and never over those it is replicated on; a plain tensor is
    whole on every rank and counts once."""
    import torch.distributed as dist

    plain, sharded = [], {}
    for t in tensors:
        mesh = getattr(t, "device_mesh", None)
        if mesh is None:
            plain.append(t.float().square().sum())
            continue
        dims = tuple(i for i, pl in enumerate(t.placements) if pl.is_shard())
        sharded.setdefault((id(mesh), dims), (mesh, dims, []))[2].append(
            t.to_local().float().square().sum())
    parts = plain
    for mesh, dims, sums in sharded.values():
        total = torch.stack(sums).sum()
        for i in dims:
            if mesh.size(i) > 1:
                dist.all_reduce(total, group=mesh.get_group(i))
        parts.append(total)
    return torch.stack(parts).sum().sqrt()


def _layout_groups(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` that one ``torch._foreach`` call can take
    together: plain tensors, and DTensors by mesh and placements (a
    foreach op refuses a mix)."""
    groups: Dict[object, List[int]] = {}
    for i, t in enumerate(tensors):
        mesh = getattr(t, "device_mesh", None)
        groups.setdefault(None if mesh is None else (id(mesh), tuple(t.placements)),
                          []).append(i)
    return list(groups.values())


def foreach(op: str, *args, **kw):
    """``torch._foreach_<op>(*args, **kw)`` over tensors of mixed layouts
    (``_layout_groups`` of the first list): one call per group, the lists
    among ``args`` split alike; the results (if any) in the input order."""
    fn = getattr(torch, f"_foreach_{op}")
    groups = _layout_groups(args[0])
    if len(groups) == 1:
        return fn(*args, **kw)
    out = [None] * len(args[0])
    for idx in groups:
        res = fn(*[[a[i] for i in idx] if isinstance(a, list) else a for a in args], **kw)
        for i, r in zip(idx, res or ()):
            out[i] = r
    return out if not op.endswith("_") else None


def _f32(x: float) -> float:
    return float(np.float32(x))


def _weak(x: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing uses it beside ``like``:
    rounded to ``like``'s dtype."""
    return float(torch.tensor(x, dtype=like.dtype))


class TorchAdamW:
    """f32 AdamW: ``torch.optim.AdamW`` with one parameter group per decay
    and layout (``_layout_groups``: plain tensors, or DTensors of one mesh
    and placements, since a fused or foreach kernel takes one layout per
    call), fused on the GPU.  Its state dict keeps a single device's two
    groups (decayed, then undecayed), so a checkpoint reads the same with
    the parameters sharded or whole."""

    def __init__(self, params: Dict[str, torch.Tensor], b1, b2, eps, weight_decay,
                 decay: Dict[str, bool]):
        # the single-device order: torch's state is keyed by the index in it
        self.order = [(n, p) for d in (True, False) for n, p in params.items()
                      if decay[n] == d]
        groups, self.decays, self.canon = [], [], []  # canon: internal -> single-device
        for d in (True, False):
            idx = [i for i, (n, _) in enumerate(self.order) if decay[n] == d]
            for part in _layout_groups([self.order[i][1] for i in idx]):
                members = [idx[j] for j in part]
                groups.append(dict(params=[self.order[i][1] for i in members],
                                   weight_decay=weight_decay if d else 0.0))
                self.decays.append(d)
                self.canon += members
        fused = bool(params) and all(p.is_cuda for p in params.values())
        self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps,
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
        sd = self.adamw.state_dict()
        groups = {}
        for d, g in zip(self.decays, sd["param_groups"]):
            merged = groups.setdefault(d, dict(g, params=[]))
            merged["params"] += [self.canon[i] for i in g["params"]]
        return {"adamw": {"state": {self.canon[i]: st for i, st in sd["state"].items()},
                          "param_groups": [dict(g, params=sorted(g["params"]))
                                           for _, g in sorted(groups.items(),
                                                              key=lambda kv: not kv[0])]}}

    def load_state_dict(self, state: dict) -> None:
        inner = state["adamw"]
        present = [d for d in (True, False) if d in self.decays]
        if len(inner["param_groups"]) != len(present):
            raise ValueError("optimizer state does not match the parameter groups")
        by_decay = dict(zip(present, inner["param_groups"]))
        inv = {c: i for i, c in enumerate(self.canon)}
        groups, start = [], 0
        for d, g in zip(self.decays, self.adamw.param_groups):
            n = len(g["params"])
            groups.append(dict(by_decay[d], params=list(range(start, start + n))))
            start += n
        self.adamw.load_state_dict({"state": {inv[c]: st for c, st in inner["state"].items()},
                                    "param_groups": groups})

    def map_state(self, state: dict, fn) -> dict:
        """``state`` with each moment ``t`` of parameter ``name`` replaced by
        ``fn(name, t, param)``."""
        inner = dict(state["adamw"])
        inner["state"] = {i: {k: (fn(self.order[i][0], v, self.order[i][1])
                                  if k != "step" and isinstance(v, torch.Tensor) else v)
                              for k, v in st.items()}
                          for i, st in inner["state"].items()}
        return {"adamw": inner}


class AdamMu:
    """AdamW with the first moment kept in ``mu_dtype`` (optax's
    ``scale_by_adam(mu_dtype=)``): ``b1`` rounded to ``mu_dtype`` (JAX's
    weak typing) times ``mu`` in f32, the new moment in f32, used in f32,
    stored rounded."""

    def __init__(self, params: Dict[str, torch.Tensor], b1, b2, eps, weight_decay,
                 decay: Dict[str, bool], mu_dtype: torch.dtype):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.names = list(params)
        self.decayed = [decay[n] for n in params]
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params.values()]
        self.nu = [torch.zeros_like(p) for p in params.values()]

    def step(self, params, grads, lr: float, count: int) -> None:
        b1, b2, t = self.b1, self.b2, count + 1
        mu = foreach("mul", [g.float() for g in grads], _f32(1 - b1))
        # b1 rounded to mu's dtype (JAX's weak typing), the product in f32 (the
        # jitted step keeps it unrounded)
        foreach("add_", mu, [m.float() * _weak(b1, m) for m in self.mu])
        foreach("mul_", self.nu, b2)
        foreach("addcmul_", self.nu, grads, grads, value=_f32(1 - b2))
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        den = foreach("div", self.nu, c2)
        foreach("sqrt_", den)
        foreach("add_", den, self.eps)
        upd = foreach("div", mu, c1)
        foreach("div_", upd, den)
        if self.wd:
            dec = [i for i, d in enumerate(self.decayed) if d]
            foreach("add_", [upd[i] for i in dec], [params[i] for i in dec], alpha=self.wd)
        foreach("add_", params, upd, alpha=-lr)
        for dst, src in zip(self.mu, mu):
            dst.copy_(src)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu}

    def map_state(self, state: dict, fn) -> dict:
        return {k: [fn(n, t, like) for n, t, like in zip(self.names, state[k], getattr(self, k))]
                for k in ("mu", "nu")}

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
        self.names = list(params)
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

    def map_state(self, state: dict, fn) -> dict:
        out = {}
        for k in ("v_row", "v_col", "v", "ema"):
            if state[k] is None:
                out[k] = None
                continue
            out[k] = [None if t is None else fn(n, t, like)
                      for n, t, like in zip(self.names, state[k], getattr(self, k))]
        return out

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
        # parallel.sharding.ShardedParams when the parameters are sharded: the
        # state dict then holds whole tensors (the single-device layout)
        self.sharding = None

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
            delta = foreach("sub", gs, acc)
            foreach("div_", delta, float(self.mini_step + 1))
            foreach("add_", acc, delta)
            del delta
            emit = self.mini_step == self.k - 1
            self.mini_step = (self.mini_step + 1) % self.k
            if not emit:
                return False
            gs, grad_norm = acc, None
        if self.grad_clip is not None:
            n = global_norm(gs) if grad_norm is None else grad_norm
            if not bool(n < self.grad_clip):  # one sync a step
                gs = foreach("div", gs, n)
                foreach("mul_", gs, self.grad_clip)
        self.rule.step(list(self.params.values()), gs, self.lr(self.count), self.count)
        self.count += 1
        if self.acc is not None:
            foreach("zero_", list(self.acc.values()))
        return True

    def state_dict(self) -> dict:
        rule_state, acc = self.rule.state_dict(), self.acc
        if self.sharding is not None:
            full = lambda n, t, like: self.sharding.to_full(n, t)  # noqa: E731
            rule_state = self.rule.map_state(rule_state, full)
            acc = acc and {n: full(n, t, None) for n, t in acc.items()}
        return {"count": self.count, "mini_step": self.mini_step, "names": list(self.params),
                "rule": type(self.rule).__name__, "state": rule_state, "acc": acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if (state["names"] != list(self.params) or state["rule"] != type(self.rule).__name__
                or (self.acc is None) != (state["acc"] is None)):
            raise ValueError("optimizer state does not match the parameters or the rule")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        rule_state, acc = state["state"], state["acc"]
        if self.sharding is not None:
            shard = self.sharding.from_full
            rule_state = self.rule.map_state(rule_state, shard)
            acc = acc and {n: shard(n, t, self.acc[n]) for n, t in acc.items()}
        self.rule.load_state_dict(rule_state)
        for n, t in (self.acc or {}).items():
            t.copy_(acc[n])


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
