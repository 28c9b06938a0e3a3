"""Small shared utilities (reference ``src/utils/utils.py`` equivalents)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def scale_shift_re(x, scale: float, shift: float):
    """Latents back from model space (reference utils.py:24-25)."""
    return (x / scale) - shift


def randn(shape, generator: Optional[torch.Generator], device, dtype=torch.float32):
    """A standard-normal draw from ``generator``.

    Every draw of the port's entry points goes through this one function
    (initial latents, the VAE posterior sample, the DDIM eta noise), so a
    parity test can substitute the JAX package's ``jax.random`` draws,
    which torch cannot reproduce (ROADMAP F1).
    """
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


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
