"""Autoencoder facade (counterpart of
``ezaudio_tpu/codecs/facade.py::AutoencoderFacade``).

``encode(audio (B, T, 1)) -> latent (B, L, C)`` and ``decode(latent) ->
audio (B, T, 1)`` through the kernel-routed encoder and decoder
(``oobleck_fast.encode_fused`` / ``decode_fused``), as the JAX facade
routes them.  With ``quantization_first`` (the EzAudio setting) the VAE
posterior is sampled at encode, so decode takes the latent as is.  Also
carries the chunked overlap-discard ``encode_audio`` / ``decode_audio`` of
the reference (``autoencoders.py:428-559``), index arithmetic on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ezaudio_tpu_torch.codecs.oobleck import AudioVAE, vae_sample
from ezaudio_tpu_torch.codecs.oobleck_fast import decode_fused, encode_fused


class AutoencoderFacade:
    def __init__(self, model: AudioVAE, quantization_first: bool = True):
        if not quantization_first:
            raise NotImplementedError("quantization_first=False is not ported yet")
        self.model = model
        self.quantization_first = quantization_first
        self.downsampling_ratio = model.downsampling_ratio

    @torch.no_grad()
    def encode(self, audio, generator: Optional[torch.Generator] = None,
               sample: bool = True) -> torch.Tensor:
        """audio (B, T, 1) -> latent (B, L, C): a posterior sample drawn
        from ``generator``, or the posterior mean with ``sample=False``."""
        ms = encode_fused(self.model.encoder, self._tensor(audio))
        return vae_sample(ms, sample, generator)

    @torch.no_grad()
    def decode(self, embedding) -> torch.Tensor:
        """latent (B, L, C) -> audio (B, T, 1)."""
        return decode_fused(self.model.decoder, self._tensor(embedding))

    def _tensor(self, x) -> torch.Tensor:
        """``x`` (array or tensor) in the codec's dtype on its device."""
        w = self.model.decoder.layers[0].weight
        return torch.as_tensor(x, dtype=w.dtype, device=w.device)

    def __call__(self, audio=None, embedding=None, **kw):
        if audio is not None:
            return self.encode(audio, **kw)
        if embedding is not None:
            return self.decode(embedding)
        raise ValueError("Either audio or embedding must be provided.")

    # ------------------------------------------------------------------
    # Chunked long-audio paths (autoencoders.py:428-559): every chunk is
    # one codec call; the overlap halves at inner seams are discarded.
    # ------------------------------------------------------------------
    def encode_audio(self, audio, chunked: bool = False, overlap: int = 32,
                     chunk_size: int = 128, **kw):
        spl = self.downsampling_ratio
        chunk_samps, overlap_samps = chunk_size * spl, overlap * spl
        total = audio.shape[1]
        # a short input fits one call; the stitching below needs one full chunk
        if not chunked or total <= chunk_samps:
            return self.encode(audio, **kw)
        hop = chunk_samps - overlap_samps
        starts = list(range(0, total - chunk_samps + 1, hop))
        if not starts or starts[-1] + chunk_samps != total:
            starts.append(total - chunk_samps)
        y_size = total // spl
        out = None  # allocated from the first chunk's channel count
        ol = overlap // 2
        n = len(starts)
        for i, s0 in enumerate(starts):
            z = self.encode(audio[:, s0: s0 + chunk_samps], **kw)
            if out is None:
                out = z.new_zeros((audio.shape[0], y_size, z.shape[2]))
            t0, t1 = ((s0 // spl, s0 // spl + chunk_size) if i < n - 1
                      else (y_size - z.shape[1], y_size))
            c0, c1 = 0, z.shape[1]
            if i > 0:
                t0 += ol
                c0 += ol
            if i < n - 1:
                t1 -= ol
                c1 -= ol
            out[:, t0:t1] = z[:, c0:c1]
        return out

    def decode_audio(self, latents, chunked: bool = False, overlap: int = 32,
                     chunk_size: int = 128):
        spl = self.downsampling_ratio
        total = latents.shape[1]
        if not chunked or total <= chunk_size:
            return self.decode(latents)
        hop = chunk_size - overlap
        starts = list(range(0, total - chunk_size + 1, hop))
        if not starts or starts[-1] + chunk_size != total:
            starts.append(total - chunk_size)
        y_size = total * spl
        out = None
        ol = (overlap // 2) * spl
        n = len(starts)
        for i, s0 in enumerate(starts):
            w = self.decode(latents[:, s0: s0 + chunk_size])
            if out is None:
                out = w.new_zeros((latents.shape[0], y_size, w.shape[2]))
            t0, t1 = ((s0 * spl, (s0 + chunk_size) * spl) if i < n - 1
                      else (y_size - w.shape[1], y_size))
            c0, c1 = 0, w.shape[1]
            if i > 0:
                t0 += ol
                c0 += ol
            if i < n - 1:
                t1 -= ol
                c1 -= ol
            out[:, t0:t1] = w[:, c0:c1]
        return out
