"""Numerical-safety and debugging aids (counterpart of ``ezaudio_tpu/debug.py``).

  * :func:`enable_nan_checks` — while on, every operator whose floating
    output holds a NaN or an infinity raises ``FloatingPointError`` naming
    the operator (a ``TorchDispatchMode`` over every op, forward and
    backward, on any device), as ``jax_debug_nans``/``jax_debug_infs`` do
    for the JAX package; anomaly mode is no counterpart, it only watches
    the backward;
  * :func:`assert_tree_finite` — host-side check of a nested dict or list,
    a state dict or a module's parameters and buffers;
  * :func:`finite_guard` — on the device: if any tensor of the updates is
    not finite, all are replaced by the fallback (zeros by default), with
    no host synchronisation.

The JAX package's ``interpret_pallas`` has no counterpart: a CUDA kernel of
the port has no interpreter mode, and its plain twin is what runs on the
CPU (``ops/kernels``).
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op with a non-finite
    floating (or complex) output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and t.numel() and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(f"{func}: non-finite output of shape "
                                         f"{tuple(t.shape)}")
        return out


_ACTIVE: Optional[NanCheckMode] = None


def enable_nan_checks(enable: bool = True) -> None:
    """Turn the NaN/Inf check of every op on (or off) for this thread."""
    global _ACTIVE
    if enable and _ACTIVE is None:
        _ACTIVE = NanCheckMode()
        _ACTIVE.__enter__()
    elif not enable and _ACTIVE is not None:
        mode, _ACTIVE = _ACTIVE, None
        mode.__exit__(None, None, None)


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, torch.nn.Module):
        yield from _leaves(dict(tree.state_dict(keep_vars=True)), prefix)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming (up to 10 of) the leaves of
    ``tree`` that hold a NaN or an infinity."""
    bad: List[str] = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
        if (t.is_floating_point() or t.is_complex()) and not bool(torch.isfinite(t).all()):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad[:10]}")


def finite_guard(updates, fallback=None) -> Tuple[Any, torch.Tensor]:
    """If ANY tensor of ``updates`` (a nested dict, list or tuple) is not
    finite, replace the whole tree with ``fallback`` (zeros by default).
    Returns ``(updates, was_bad)``, ``was_bad`` a 0-d bool tensor on the
    updates' device.  Use around optimizer updates to ride out loss spikes
    without a NaN'd model."""
    leaves = [t for t in tree_flatten(updates)[0] if isinstance(t, torch.Tensor)]
    ok = torch.stack([torch.isfinite(t).all() for t in leaves]).all()
    if fallback is None:
        fallback = tree_map(lambda u: torch.zeros_like(u) if isinstance(u, torch.Tensor) else u,
                            updates)
    flat_u, spec = tree_flatten(updates)
    flat_f = tree_flatten(fallback)[0]
    guarded = [torch.where(ok, u, f) if isinstance(u, torch.Tensor) else u
               for u, f in zip(flat_u, flat_f)]
    return tree_unflatten(guarded, spec), ~ok
