"""Kernel-routed Oobleck decode (counterpart of
``ezaudio_tpu/codecs/oobleck_fast.py::decode_fused``).

Walks an :class:`~ezaudio_tpu_torch.codecs.oobleck.OobleckDecoder`'s own
modules and runs every ResidualUnit through kernel 2
(``ops/kernels/resunit.py``: snake -> dilated conv7 -> snake -> conv1x1 ->
residual in one pass).  Stem, up-convs, snakes and head stay the modules'
``conv1d`` / ``conv_transpose1d``.  The kernel is channel-last, so the
activations are transposed around each block's three units.
"""

from __future__ import annotations

from ezaudio_tpu_torch.codecs.oobleck import DecoderBlock, OobleckDecoder, ResidualUnit
from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit


def resunit_fused(x, unit: ResidualUnit):
    """One ResidualUnit on channel-last ``x`` (B, L, C) through the kernel."""
    act1, conv1, act2, conv2 = unit.layers
    return fused_residual_unit(
        x, conv1.weight.permute(2, 1, 0).contiguous(), conv1.bias,
        conv2.weight[:, :, 0].t().contiguous(), conv2.bias,
        act1.alpha.exp(), act1.beta.exp(), act2.alpha.exp(), act2.beta.exp(),
        unit.dilation)


def decode_fused(decoder: OobleckDecoder, z):
    """``decoder(z)`` with the ResidualUnits on kernel 2: (B, L, latent)
    -> (B, L*prod(strides), out_channels)."""
    x = z.transpose(1, 2)
    for layer in decoder.layers:
        if isinstance(layer, DecoderBlock):
            x = layer.layers[1](layer.layers[0](x))
            h = x.transpose(1, 2).contiguous()
            for unit in layer.layers[2:]:
                h = resunit_fused(h, unit)
            x = h.transpose(1, 2)
        else:  # stem conv, final snake, head conv, tanh
            x = layer(x)
    return x.transpose(1, 2)
