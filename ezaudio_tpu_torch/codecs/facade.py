"""Autoencoder facade, decode side (counterpart of
``ezaudio_tpu/codecs/facade.py::AutoencoderFacade``).

``decode(latent (B, L, C)) -> audio (B, T, 1)`` through the kernel-routed
decoder (``oobleck_fast.decode_fused``), as the JAX facade routes it.
This slice covers the EzAudio setting ``quantization_first=True`` (the
bottleneck sample happens at encode, so decode takes the latent as is).
"""

from __future__ import annotations

import torch

from ezaudio_tpu_torch.codecs.oobleck import AudioVAE
from ezaudio_tpu_torch.codecs.oobleck_fast import decode_fused


class AutoencoderFacade:
    def __init__(self, model: AudioVAE, quantization_first: bool = True):
        if not quantization_first:
            raise NotImplementedError("quantization_first=False is not ported yet")
        self.model = model
        self.quantization_first = quantization_first
        self.downsampling_ratio = model.downsampling_ratio

    @torch.no_grad()
    def decode(self, embedding: torch.Tensor) -> torch.Tensor:
        """latent (B, L, C) -> audio (B, T, 1)."""
        return decode_fused(self.model.decoder, embedding)
