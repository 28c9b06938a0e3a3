"""The work of the measured paths, from a configuration's widths and a
cell's shapes: model FLOPs of the DiT and T5, and the operations and
bytes of the two hand-written kernels.  Nothing here reads the program.

Model FLOPs count 2 per weight per token that weight sees (the frames; the
text tokens for the context projections; one token per sample for the
time embedding and AdaLN), and 4 B H Lq Lk D for each attention's two
products.  Biases, norms, softmax, elementwise work and the VAE are not
counted.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores; TF32 tensor cores,
# the highest rate the card publishes for f32 inputs; HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _attn(batch: int, heads: int, lq: int, lk: int, dh: int) -> float:
    return 4.0 * batch * heads * lq * lk * dh


def dit_block_flops(m: dict, batch: int, frames: int, text: int, skip: bool) -> float:
    """One DiT block: optional skip fusion, self- and cross-attention, GEGLU MLP."""
    D, H = m["embed_dim"], m["num_heads"]
    inner = int(D * m["mlp_ratio"])
    r = m["ada_sola_rank"]
    tok = batch * frames
    f = 2.0 * (2 * D * D) * tok if skip else 0.0
    f += 2.0 * (D * 6 * r + 6 * r * 6 * D) * batch        # AdaLN-SOLA, one token a sample
    f += 2.0 * 4 * D * D * tok + _attn(batch, H, frames, frames, D // H)
    f += 2.0 * 2 * D * D * tok + 2.0 * 2 * D * D * batch * text
    f += _attn(batch, H, frames, text, D // H)
    f += 2.0 * (D * 2 * inner + inner * D) * tok
    return f


def dit_forward_flops(m: dict, batch: int, frames: int, text: int) -> float:
    """One MaskDiT call on ``batch`` rows."""
    D, C = m["embed_dim"], m["out_chans"]
    half = m["depth"] // 2
    tok = batch * frames
    f = 2.0 * m["in_chans"] * D * tok                                  # patch embed
    f += 2.0 * (m["context_dim"] * D + D * D) * batch * text           # context embed
    f += 2.0 * (256 * D + D * D + D * 6 * D + D * 2 * D) * batch       # time embed, AdaLN heads
    f += 2.0 * (D * C + C * C * 3) * tok                               # final linear and conv
    f += (half + 1) * dit_block_flops(m, batch, frames, text, False)
    f += half * dit_block_flops(m, batch, frames, text, True)
    return f


def t5_flops(t5: dict, batch: int, tokens: int) -> float:
    d, inner, ff = t5["d_model"], t5["num_heads"] * t5["d_kv"], t5["d_ff"]
    tok = batch * tokens
    per_layer = (2.0 * 4 * d * inner * tok + _attn(batch, t5["num_heads"], tokens, tokens,
                                                    t5["d_kv"]) + 2.0 * 3 * d * ff * tok)
    return t5["num_layers"] * per_layer


def frames_of(config: dict, seconds: float) -> int:
    return int(seconds * config["autoencoder"]["latent_sr"])


def t2a_call_flops(config: dict, batch: int, seconds: float, steps: int) -> float:
    """A ``generate_audio`` call with CFG on every step: T5 on the prompts
    (the empty prompt's embedding is computed once, not per call) and
    ``steps`` DiT calls on the CFG pair."""
    m, text = config["model"], config["text_encoder"]["max_length"]
    return (t5_flops(config["t5"], batch, text)
            + steps * dit_forward_flops(m, 2 * batch, frames_of(config, seconds), text))


# ---------------------------------------------------------------- kernels

def roofline_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time of a launch: the larger of its operations over the
    dtype's peak and its bytes over the bandwidth."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def attention_launch(batch, heads, lq, lk, dh, dtype: str, masked: bool):
    """Kernel 1, one launch: ``(ops, bytes)``; q, k, v and o once each, the
    f32 key bias once when masked."""
    s = DTYPE_BYTES[dtype]
    nbytes = s * batch * heads * dh * (2 * lq + 2 * lk) + (4 * batch * lk if masked else 0)
    return _attn(batch, heads, lq, lk, dh), nbytes


def dit_attention_launches(config: dict, batch: int, seconds: float, dtype: str):
    """The kernel 1 launches of one uncached DiT call on ``batch`` rows: a
    self- and a cross-attention per block."""
    m = config["model"]
    D, H = m["embed_dim"], m["num_heads"]
    L, Lc = frames_of(config, seconds), config["text_encoder"]["max_length"]
    blocks = 2 * (m["depth"] // 2) + 1
    return ([attention_launch(batch, H, L, L, D // H, dtype, False)] * blocks
            + [attention_launch(batch, H, L, Lc, D // H, dtype, True)] * blocks)


def resunit_launch(batch, length, channels, dtype: str):
    """Kernel 2, one launch: snake, dilated width-7 conv, snake, 1x1 conv and
    the residual; ``(ops, bytes)`` with x and y, both convs' weights and
    biases once, and the four f32 snake vectors."""
    s = DTYPE_BYTES[dtype]
    C = channels
    ops = 2.0 * batch * length * C * C * 8
    nbytes = s * (2 * batch * length * C + 8 * C * C + 2 * C) + 4 * 4 * C
    return ops, nbytes


def decode_resunit_launches(config: dict, clips: int, seconds: float, dtype: str,
                            chunk: int = 4):
    """The kernel 2 launches of decoding ``clips`` clips in chunks of
    ``chunk``: three units after each decoder block's upsampling."""
    dec = config["vae"]["model"]["decoder"]["config"]
    ch, strides = dec["channels"], list(dec["strides"])
    mults = [1] + list(dec["c_mults"])
    out = []
    for start in range(0, clips, chunk):
        b = min(chunk, clips - start)
        length = frames_of(config, seconds)
        for i in range(len(strides), 0, -1):
            length *= strides[i - 1]
            out += [resunit_launch(b, length, mults[i - 1] * ch, dtype)] * 3
    return out


def bound_seconds(launches, dtype: str) -> float:
    return math.fsum(roofline_s(o, b, dtype) for o, b in launches)
