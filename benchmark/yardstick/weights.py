"""Seeded random weights for a configuration, made on the device.

The names and shapes come from the plain reference's modules, built on the
``meta`` device.  Each parameter draws from a uniform law by its kind (the
port's and the JAX package's init rules, with uniform laws of the same
spread for the normal ones): a convolution's weight and bias
U(+-1/sqrt(fan_in)); a norm's weight 1 and bias 0; any other matrix
xavier-uniform; any other vector U(+-0.02 sqrt 3), the law of N(0, 0.02)'s
spread.  Parameters of one law sit side by side in one flat f32 buffer, so
the draw is one ``uniform_`` call per law, a few dozen in all, from a
``torch.Generator`` on the device.  The same seed gives the same weights
on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from yardstick import reference as ref

VECTOR_BOUND = 0.02 * math.sqrt(3.0)


def _law(module: nn.Module, pname: str, p: torch.Tensor) -> Tuple[float, float]:
    """``(lo, hi)`` of the uniform law of ``module.pname``; ``lo == hi`` is a constant."""
    if isinstance(module, ref.NORMS):
        return (1.0, 1.0) if pname == "weight" else (0.0, 0.0)
    if isinstance(module, ref.Conv1d):
        b = 1.0 / math.sqrt(module.weight[0].numel())
        return -b, b
    if p.ndim >= 2:
        fan_out, fan_in = p.shape[0], p[0].numel()
        b = math.sqrt(6.0 / (fan_in + fan_out))
        return -b, b
    return -VECTOR_BOUND, VECTOR_BOUND


def layout(root: nn.Module) -> List[Tuple[str, tuple, Tuple[float, float]]]:
    """``(name, shape, law)`` of every parameter of ``root``, grouped by law."""
    rows = []
    for mname, m in root.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            rows.append((name, tuple(p.shape), _law(m, pname, p)))
    rows.sort(key=lambda r: r[2])
    return rows


def reference_modules(config: dict) -> Dict[str, nn.Module]:
    """The reference's ``t5``, ``dit`` and ``vae`` on the meta device."""
    with torch.device("meta"):
        pipe = ref.Pipeline(config)
    return {"t5": pipe.t5, "dit": pipe.dit, "vae": pipe.vae}


def make_weights(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{component: {name: tensor}}`` for ``t5``, ``dit`` and ``vae``: views
    into one f32 buffer per component, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out = {}
    for comp, module in reference_modules(config).items():
        rows = layout(module)
        total = sum(math.prod(s) for _, s, _ in rows)
        flat = torch.empty(total, device=device, dtype=torch.float32)
        i = 0
        sd = {}
        start, law0 = 0, rows[0][2]
        for name, shape, law in rows + [("", (0,), None)]:
            if law != law0:  # close the run of one law
                lo, hi = law0
                run = flat[start:i]
                run.fill_(lo) if lo == hi else run.uniform_(lo, hi, generator=gen)
                start, law0 = i, law
            n = math.prod(shape)
            if name:
                sd[name] = flat[i:i + n].view(shape)
            i += n
        out[comp] = sd
    return out


@torch.no_grad()
def load_into(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy ``sd`` into ``module``'s parameters by name.  Every parameter of
    the module must be given and every given tensor used; its buffers are
    its own."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(sd))
    extra = sorted(set(sd) - set(params))
    if missing or extra:
        raise ValueError(f"weights do not match {type(module).__name__}: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for name, p in params.items():
        if p.shape != sd[name].shape:
            raise ValueError(f"{name}: {tuple(p.shape)} against {tuple(sd[name].shape)}")
        p.copy_(sd[name])


def reference_pipeline(config: dict, weights: Dict[str, Dict[str, torch.Tensor]], device,
                       prec: str = "f32") -> "ref.Pipeline":
    """The reference with ``weights``, in ``prec``, frozen."""
    with torch.device("meta"):
        pipe = ref.Pipeline(config)
    pipe = pipe.to_empty(device=device)
    for comp in ("t5", "dit", "vae"):
        load_into(getattr(pipe, comp), weights[comp])
    ref.set_precision(pipe, prec)
    return pipe.requires_grad_(False).eval()
