"""Kernel-routed Oobleck encode and decode (counterpart of
``ezaudio_tpu/codecs/oobleck_fast.py::{encode,decode}_fused``).

Walks an :class:`~ezaudio_tpu_torch.codecs.oobleck.OobleckEncoder`'s or
``OobleckDecoder``'s own modules and runs every ResidualUnit through
kernel 2 (``ops/kernels/resunit.py``: snake -> dilated conv7 -> snake ->
conv1x1 -> residual in one pass).  Stems, strided and transposed convs,
snakes and heads stay the modules' own.  The kernel is channel-last, so the
activations are transposed around each block's three units.
"""

from __future__ import annotations

from ezaudio_tpu_torch.codecs.oobleck import (DecoderBlock, EncoderBlock, OobleckDecoder,
                                              OobleckEncoder, ResidualUnit)
from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit


def resunit_fused(x, unit: ResidualUnit):
    """One ResidualUnit on channel-last ``x`` (B, L, C) through the kernel."""
    act1, conv1, act2, conv2 = unit.layers
    return fused_residual_unit(
        x, conv1.weight.permute(2, 1, 0).contiguous(), conv1.bias,
        conv2.weight[:, :, 0].t().contiguous(), conv2.bias,
        act1.alpha.exp(), act1.beta.exp(), act2.alpha.exp(), act2.beta.exp(),
        unit.dilation)


def _units_fused(x, units):
    """ResidualUnits on (B, C, T) ``x`` through the kernel, channel-last inside."""
    h = x.transpose(1, 2).contiguous()
    for unit in units:
        h = resunit_fused(h, unit)
    return h.transpose(1, 2)


def encode_fused(encoder: OobleckEncoder, audio):
    """``encoder(audio)`` with the ResidualUnits on kernel 2: (B, T, in)
    -> (B, T/prod(strides), 2*latent) (mean || scale)."""
    x = audio.transpose(1, 2)
    for layer in encoder.layers:
        if isinstance(layer, EncoderBlock):
            x = _units_fused(x, layer.layers[:3])
            x = layer.layers[4](layer.layers[3](x))
        else:  # stem conv, final snake, head conv
            x = layer(x)
    return x.transpose(1, 2)


def decode_fused(decoder: OobleckDecoder, z):
    """``decoder(z)`` with the ResidualUnits on kernel 2: (B, L, latent)
    -> (B, L*prod(strides), out_channels)."""
    x = z.transpose(1, 2)
    for layer in decoder.layers:
        if isinstance(layer, DecoderBlock):
            # rebind x first: the block's input must not stay alive across its units
            x = layer.layers[1](layer.layers[0](x))
            x = _units_fused(x, layer.layers[2:])
        else:  # stem conv, final snake, head conv, tanh
            x = layer(x)
    return x.transpose(1, 2)
