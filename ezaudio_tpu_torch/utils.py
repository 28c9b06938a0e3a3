"""Small shared utilities (reference ``src/utils/utils.py`` equivalents)."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

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


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN restricted to its deterministic algorithms while open, the
    caller's setting restored after, as the JAX package's steps are on the
    TPU: the same inputs give the same gradients in every run, so a restart
    retakes the steps after its checkpoint exactly.  (cuDNN's default
    algorithms may sum a conv's gradient in a run-dependent order: on the
    H100 a bf16 run and its restart parted at the fifth or sixth step.)
    Every train step enters it (``training/trainer.py::StepLoop``,
    ``training/codec_trainer.py::CodecTrainStep``)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _cast_in_place(dtype: torch.dtype):
    def cast(module: torch.nn.Module, name: str) -> None:
        if name in module._parameters:
            p = module._parameters[name]
            p.data = p.data.to(dtype)
        else:
            module._buffers[name] = module._buffers[name].to(dtype)
    return cast


@torch.no_grad()
def cast_params_(module: torch.nn.Module, dtype: torch.dtype,
                 cast: Optional[Callable[[torch.nn.Module, str], None]] = None
                 ) -> torch.nn.Module:
    """Cast ``module``'s floating parameters and buffers to ``dtype`` in
    place, once: the bf16 copies the JAX package makes at every use of its
    f32 parameters (``kernel.astype(dtype)``), which round the same way.

    A module with a ``cast_(dtype, cast)`` method casts itself and its
    children instead: the norms, the VAE and feed-forward snakes, RoPE, the
    positional embeddings and T5's position bias keep f32 where the JAX
    package computes with its f32 parameters,
    and ``QuantLinear`` quantizes its int8 weight from the f32 weight first.

    With ``cast``, ``cast(module, name)`` is called for each parameter or
    buffer these rules cast, in place of the cast (:func:`mixed_precision`
    collects them so).
    """
    own = getattr(module, "cast_", None)
    if own is not None:
        own(dtype, cast)
        return module
    visit = cast or _cast_in_place(dtype)
    for name, p in module.named_parameters(recurse=False):
        if p.is_floating_point():
            visit(module, name)
    for name, b in module.named_buffers(recurse=False):
        if b.is_floating_point():
            visit(module, name)
    for child in module.children():
        cast_params_(child, dtype, cast)
    return module


@contextlib.contextmanager
def mixed_precision(module: torch.nn.Module, dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Compute ``module`` in ``dtype`` while its parameters stay f32 masters:
    inside, each parameter (and buffer) :func:`cast_params_` would cast is
    replaced by a differentiable ``dtype`` copy of itself, made once on entry, so the
    layers compute the bf16 model's function (``cast_params_``'s rules:
    norms and RoPE in f32, convolutions summing in f32) and gradients flow
    through the casts to the f32 parameters, as flax's ``kernel.astype``
    at each use does.  The backward (and remat's recompute in it) must
    run inside too.  ``None`` or f32 changes nothing."""
    if dtype is None or dtype == torch.float32:
        yield
        return
    plan: List[Tuple[Dict[str, torch.Tensor], str]] = []
    cast_params_(module, dtype, lambda m, n: plan.append(
        (m._parameters if n in m._parameters else m._buffers, n)))
    masters = [slots[n] for slots, n in plan]
    try:
        for (slots, n), t in zip(plan, masters):
            slots[n] = t.to(dtype)
        yield
    finally:
        for (slots, n), t in zip(plan, masters):
            slots[n] = t


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
