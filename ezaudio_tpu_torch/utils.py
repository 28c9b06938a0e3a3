"""Small shared utilities (reference ``src/utils/utils.py`` equivalents)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


def scale_shift(x, scale: float, shift: float):
    """Latents into model space (reference utils.py:20-21)."""
    return (x + shift) * scale


def scale_shift_re(x, scale: float, shift: float):
    """Latents back from model space (reference utils.py:24-25)."""
    return (x / scale) - shift


def randn(shape, generator: Optional[torch.Generator], device, dtype=torch.float32):
    """A standard-normal draw from ``generator``, made in float32 and cast
    to ``dtype``: a bf16 model at a seed starts from the rounded draws of
    the f32 model at that seed.

    Every draw of the port's entry points goes through this one function
    (initial latents, the VAE posterior sample, the DDIM eta noise), so a
    parity test can substitute the JAX package's ``jax.random`` draws,
    which torch cannot reproduce (ROADMAP F1).
    """
    x = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return x.to(dtype)


@torch.no_grad()
def cast_params_(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast ``module``'s floating parameters and buffers to ``dtype`` in
    place, once: the bf16 copies the JAX package makes at every use of its
    f32 parameters (``kernel.astype(dtype)``), which round the same way.

    A module with a ``cast_(dtype)`` method casts itself and its children
    instead: the norms, the VAE snakes, RoPE and T5's position bias keep
    f32 where the JAX package computes with its f32 parameters, and
    ``QuantLinear`` quantizes its int8 weight from the f32 weight first.
    """
    own = getattr(module, "cast_", None)
    if own is not None:
        own(dtype)
        return module
    for p in module.parameters(recurse=False):
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    for name, b in module.named_buffers(recurse=False):
        if b.is_floating_point():
            module._buffers[name] = b.to(dtype)
    for child in module.children():
        cast_params_(child, dtype)
    return module


@torch.no_grad()
def init_seeded_(module: torch.nn.Module, generator: torch.Generator,
                 norm_types: tuple) -> torch.nn.Module:
    """Seeded random weights for a tower built without a checkpoint: the
    modules of ``norm_types`` get weight 1 + N(0, 0.02) and bias N(0, 0.02),
    every other matrix (and kernel, and table) xavier-uniform over its first
    axis and the rest, every other vector N(0, 0.02).  0-d parameters are
    left as built."""
    done = set()
    for m in module.modules():
        if isinstance(m, norm_types):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.normal_(0.0, 0.02, generator=generator)
            done.update((id(m.weight), id(m.bias)))
    for p in module.parameters():
        if id(p) in done or p.ndim == 0:
            continue
        if p.ndim >= 2:
            bound = math.sqrt(6.0 / (p[0].numel() + p.shape[0]))
            p.uniform_(-bound, bound, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return module


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    ``None`` means CUDA; with no usable GPU that raises instead of
    running on the CPU unasked.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
