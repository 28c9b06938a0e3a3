"""Autoencoder facade (counterpart of
``ezaudio_tpu/codecs/facade.py::AutoencoderFacade``): one interface over the
latent codecs, ``encode(audio (B, T, 1)) -> latent (B, L, C)`` and
``decode(latent) -> audio (B, T, 1)``.

``model_type`` is the reference's switch (``autoencoder_wrapper.py``):
``'stable_vae'`` (the Oobleck VAE, EzAudio's codec; encoder and decoder
through ``oobleck_fast``, every ResidualUnit on kernel 2), ``'dac'`` or
``'encodec'`` (residual-VQ codecs, plain torch).  ``quantization_first``
decides where the bottleneck runs: at encode (EzAudio's ``q_first: true``:
the VAE posterior sampled, or the RVQ round trip), or at decode (encode
returns the encoder's raw output: the VAE's mean || scale, DAC's and
EnCodec's continuous latent).  Also carries the chunked overlap-discard
``encode_audio`` / ``decode_audio`` of the reference
(``autoencoders.py:428-559``), index arithmetic on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.codecs.oobleck import vae_sample
from ezaudio_tpu_torch.codecs.oobleck_fast import decode_fused, encode_fused

MODEL_TYPES = ("stable_vae", "dac", "encodec")


class AutoencoderFacade:
    def __init__(self, model, quantization_first: bool = True,
                 model_type: str = "stable_vae"):
        if model_type not in MODEL_TYPES:
            raise ValueError(f"model_type {model_type!r}: one of {MODEL_TYPES}")
        self.model = model
        self.quantization_first = quantization_first
        self.model_type = model_type
        if model_type == "stable_vae":
            self.latent_channels = model.latent_dim
            self.downsampling_ratio = model.downsampling_ratio
        else:
            self.latent_channels = (model.latent_dim if model_type == "dac"
                                    else model.dimension)
            self.downsampling_ratio = model.hop_length

    @torch.no_grad()
    def encode(self, audio, generator: Optional[torch.Generator] = None,
               sample: bool = True, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """audio (B, T, 1) -> latent (B, L, C).  The VAE with
        ``quantization_first`` draws its posterior sample from ``generator``
        (``sample=False``: the mean); without, it returns mean || scale.
        ``rows=(start, total)``: ``audio`` is rows ``start .. start + B`` of
        a batch of ``total`` (one rank's share of a data-parallel batch);
        the posterior noise is drawn for all ``total`` rows and these rows
        kept, so the sample is the whole batch's."""
        a, m = self._tensor(audio), self.model
        if self.model_type == "encodec":
            z = m.encoder(a)
            return m.quantizer.decode(m.quantizer.encode(z)) if self.quantization_first else z
        if self.model_type == "dac":
            return m.encode(a)[0] if self.quantization_first else m.encode_latent(a)
        ms = encode_fused(m.encoder, a)
        if not self.quantization_first:
            return ms
        noise = None
        if rows is not None and sample:
            start, total = rows
            shape = (total,) + tuple(ms.shape[1:-1]) + (ms.shape[-1] // 2,)
            noise = utils.randn(shape, generator, ms.device, ms.dtype)[start:start + len(ms)]
        return vae_sample(ms, sample, generator, noise=noise)

    @torch.no_grad()
    def decode(self, embedding, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """latent (B, L, C) -> audio (B, T, 1).  Without
        ``quantization_first`` the bottleneck runs here first (the VAE's
        posterior sample drawn from ``generator``)."""
        z, m = self._tensor(embedding), self.model
        if self.model_type == "encodec":
            if not self.quantization_first:
                z = m.quantizer.decode(m.quantizer.encode(z))
            return m.decoder(z)
        if self.model_type == "dac":
            if not self.quantization_first:
                z = m.quantizer(z)[0]
            return m.decode(z)
        if not self.quantization_first:
            z = vae_sample(z, True, generator)
        return decode_fused(m.decoder, z)

    def _tensor(self, x) -> torch.Tensor:
        """``x`` (array or tensor) in the codec's dtype on its device."""
        w = next(self.model.parameters())
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
