"""The work counts against hand-worked values at tiny shapes."""

import pytest

from yardstick import flops


def test_attention_launch_counts_each_byte_once():
    ops, nbytes = flops.attention_launch(2, 3, 5, 7, 4, "bfloat16", masked=True)
    assert ops == 4 * 2 * 3 * 5 * 7 * 4
    assert nbytes == 2 * 2 * 3 * 4 * (2 * 5 + 2 * 7) + 4 * 2 * 7
    ops, nbytes = flops.attention_launch(1, 1, 2, 2, 8, "float32", masked=False)
    assert (ops, nbytes) == (128, 4 * 8 * 8)


def test_resunit_launch():
    ops, nbytes = flops.resunit_launch(2, 10, 4, "float32")
    assert ops == 2 * 2 * 10 * 4 * 4 * 8
    assert nbytes == 4 * (2 * 2 * 10 * 4 + 8 * 16 + 8) + 16 * 4


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert flops.roofline_s(0, 3.35e12, "float32") == pytest.approx(1.0)


def test_dit_forward_by_hand(tiny):
    m = dict(tiny["model"])
    D, H, inner, r, C = 32, 4, 128, 4, 8
    B, L, Lc = 2, 20, 12
    block = (2 * 6 * r * D + 2 * 6 * r * 6 * D) * B + 2 * 4 * D * D * B * L \
        + 4 * B * H * L * L * (D // H) + 2 * 2 * D * D * B * L + 2 * 2 * D * D * B * Lc \
        + 4 * B * H * L * Lc * (D // H) + 2 * 3 * D * inner * B * L
    skip = 2 * 2 * D * D * B * L
    embeds = 2 * 17 * D * B * L + 2 * (16 * D + D * D) * B * Lc \
        + 2 * (256 * D + D * D + 6 * D * D + 2 * D * D) * B + 2 * (D * C + 3 * C * C) * B * L
    assert flops.dit_forward_flops(m, B, L, Lc) == pytest.approx(embeds + 7 * block + 3 * skip)


def test_t5_and_call_flops(tiny):
    t5 = tiny["t5"]
    d, inner, ff, heads, dk = 16, 16, 32, 4, 4
    per_layer = 2 * 4 * d * inner * 3 * 12 + 4 * 3 * heads * 12 * 12 * dk + 2 * 3 * d * ff * 3 * 12
    assert flops.t5_flops(t5, 3, 12) == pytest.approx(2 * per_layer)
    call = flops.t2a_call_flops(tiny, 3, 0.2, 5)
    assert call == pytest.approx(flops.t5_flops(t5, 3, 12)
                                 + 5 * flops.dit_forward_flops(tiny["model"], 6, 20, 12))


def test_decode_launches_follow_the_decoder(tiny):
    launches = flops.decode_resunit_launches(tiny, 5, 0.2, "float32", chunk=4)
    # two chunks (4 + 1 clips), each 3 units after each of the 2 upsamplings
    assert len(launches) == 2 * 2 * 3
    assert launches[0] == flops.resunit_launch(4, 60, 4, "float32")
    assert launches[3] == flops.resunit_launch(4, 120, 4, "float32")
    assert launches[6] == flops.resunit_launch(1, 60, 4, "float32")
