"""The plain reference of the measured models, in plain PyTorch.

It imports nothing of the program.  It is written from the published
EzAudio architecture (arXiv 2409.10819, github.com/haidog-yaqub/EzAudio):
the FLAN-T5 encoder, MaskDiT over the U-shaped DiT (AdaLN-SOLA with a
bias table, GEGLU, qk-LayerNorm, shared RoPE, cross-attention to the
text, long skips, a width-3 output conv), the Oobleck VAE and the DDIM
sampler with CFG and rescale.  Parameter names are those
of the reference torch checkpoints, so one flat dict of weights
(:mod:`weights`) fills both this and the program under test.

Every product runs in float32 with TF32 off, softmax and norms in f32.
``set_precision(module, mode)`` lowers the products of every linear and
convolution to another precision for the control of a comparison, by
rounding both operands and summing in f32, alike on every device:
``'tf32'`` (a 10-bit mantissa, as TF32 tensor cores read their inputs) or
``'fp8'`` (float8 e4m3 with a per-tensor scale).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest), the operand
    rounding of a TF32 tensor-core product; the gradient passes straight
    through."""
    i = x.detach().float().contiguous().view(torch.int32)
    q = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (q - x).detach()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in f32;
    the gradient passes straight through."""
    s = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class _Prec:
    prec = "f32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.prec == "fp8":
            return _fp8(t)
        return _tf32(t) if self.prec == "tf32" else t


class Linear(nn.Module, _Prec):
    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return F.linear(self.operand(x), self.operand(self.weight), self.bias)


class Conv1d(nn.Module, _Prec):
    def __init__(self, c_in, c_out, k, stride=1, padding=0, dilation=1, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x):
        return F.conv1d(self.operand(x), self.operand(self.weight), self.bias, self.stride,
                        self.padding, self.dilation)


class ConvTranspose1d(Conv1d):
    def __init__(self, c_in, c_out, k, stride=1, padding=0):
        super().__init__(c_in, c_out, k, stride, padding)
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k))

    def forward(self, x):
        return F.conv_transpose1d(self.operand(x), self.operand(self.weight), self.bias,
                                  self.stride, self.padding)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """T5's layer norm: no mean, no bias."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


NORMS = (LayerNorm, RMSNorm)


def set_precision(module: nn.Module, prec: str) -> nn.Module:
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r}: one of {PRECISIONS}")
    for m in module.modules():
        if isinstance(m, _Prec):
            m.prec = prec
    return module


@contextlib.contextmanager
def math_mode(prec: str):
    """TF32 off for the products, whatever ``prec`` (lower precisions are
    emulated on the operands), restored after."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


def attention(q, k, v, key_mask=None, scale=None):
    """softmax(q k^T scale) v over (B, H, L, D); ``key_mask`` (B, Lk), True = attend."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


# ---------------------------------------------------------------- tokens, T5

def hash_tokenize(texts: Sequence[str], vocab_size: int, max_length: int):
    """T5 id conventions (pad 0, eos 1 appended) over a stable hash of the
    lower-cased whitespace words: ``(ids, mask)`` int64 / bool numpy."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros((len(texts), max_length), bool)
    for b, text in enumerate(texts):
        toks = [2 + int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                % (vocab_size - 2) for w in text.lower().split()]
        toks = toks[: max_length - 1] + [1]
        ids[b, : len(toks)] = toks
        mask[b, : len(toks)] = True
    return ids, mask


def t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional relative-position buckets (T5)."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    rp = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(rp.float() / exact) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    return out + torch.where(rp < exact, rp, large.clamp(max=num_buckets - 1))


class _T5Attn(nn.Module):
    def __init__(self, d, heads, d_kv, buckets, rel):
        super().__init__()
        inner = heads * d_kv
        self.q, self.k, self.v = (Linear(d, inner, False) for _ in range(3))
        self.o = Linear(inner, d, False)
        if rel:
            self.relative_attention_bias = nn.Embedding(buckets, heads)


class T5(nn.Module):
    """The FLAN-T5 encoder: RMS norms, relative position bias from layer 0,
    unscaled attention, gated-GELU (tanh) feed-forward."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = c = dict(cfg)
        d = c["d_model"]
        self.embed_tokens = nn.Embedding(c["vocab_size"], d)
        self.block = nn.ModuleList()
        for i in range(c["num_layers"]):
            blk = nn.Module()
            sa, ff = nn.Module(), nn.Module()
            sa.SelfAttention = _T5Attn(d, c["num_heads"], c["d_kv"],
                                       c["relative_attention_num_buckets"], i == 0)
            sa.layer_norm = RMSNorm(d, c["layer_norm_epsilon"])
            ff.DenseReluDense = nn.Module()
            ff.DenseReluDense.wi_0 = Linear(d, c["d_ff"], False)
            ff.DenseReluDense.wi_1 = Linear(d, c["d_ff"], False)
            ff.DenseReluDense.wo = Linear(c["d_ff"], d, False)
            ff.layer_norm = RMSNorm(d, c["layer_norm_epsilon"])
            blk.layer = nn.ModuleList([sa, ff])
            self.block.append(blk)
        self.final_layer_norm = RMSNorm(d, c["layer_norm_epsilon"])

    def bias(self, mask, L: int):
        """The relative position bias of layer 0 plus the key mask's -inf."""
        c = self.cfg
        pos = torch.arange(L, device=mask.device)
        buckets = t5_bucket(pos[None, :] - pos[:, None], c["relative_attention_num_buckets"],
                            c["relative_attention_max_distance"])
        rel = self.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = rel[buckets].permute(2, 0, 1)[None]
        return bias.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))

    def block_forward(self, i: int, x, bias):
        c = self.cfg
        B, L, _ = x.shape
        H, Dk = c["num_heads"], c["d_kv"]
        sa, ff = self.block[i].layer
        a = sa.SelfAttention
        h = sa.layer_norm(x)
        q, k, v = (t(h).view(B, L, H, Dk).transpose(1, 2) for t in (a.q, a.k, a.v))
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        x = x + a.o(torch.matmul(w, v).transpose(1, 2).reshape(B, L, -1))
        f = ff.DenseReluDense
        h = ff.layer_norm(x)
        return x + f.wo(F.gelu(f.wi_0(h), approximate="tanh") * f.wi_1(h))

    def forward(self, ids, mask):
        x = self.embed_tokens(ids)
        bias = self.bias(mask, x.shape[1])
        for i in range(len(self.block)):
            x = self.block_forward(i, x, bias)
        return self.final_layer_norm(x)


# ---------------------------------------------------------------- the DiT

def timestep_embedding(t, dim: int = 256, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope(x):
    """Half-split rotary embedding over the positions of (B, H, L, D)."""
    L, D = x.shape[-2], x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float32) / D))
    ang = torch.outer(torch.arange(L, device=x.device, dtype=torch.float32), inv)
    ang = torch.cat([ang, ang], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * ang.cos() + torch.cat([-x2, x1], dim=-1) * ang.sin()


class Attn(nn.Module):
    def __init__(self, dim, heads, rope_self: bool):
        super().__init__()
        self.heads, self.rope_self = heads, rope_self
        self.to_q, self.to_k, self.to_v = (Linear(dim, dim, False) for _ in range(3))
        self.norm_q, self.norm_k = LayerNorm(dim // heads), LayerNorm(dim // heads)
        self.proj = Linear(dim, dim)

    def forward(self, x, ctx=None, key_mask=None):
        B, L, D = x.shape
        ctx = x if ctx is None else ctx
        Dh = D // self.heads
        q = self.norm_q(self.to_q(x).view(B, L, -1, Dh).transpose(1, 2))
        k = self.norm_k(self.to_k(ctx).view(B, ctx.shape[1], -1, Dh).transpose(1, 2))
        v = self.to_v(ctx).view(B, ctx.shape[1], -1, Dh).transpose(1, 2)
        if self.rope_self:
            q, k = rope(q), rope(k)
        o = attention(q, k, v, key_mask)
        return self.proj(o.transpose(1, 2).reshape(B, L, D))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, rank, alpha, skip: bool):
        super().__init__()
        if skip:
            self.skip_norm = LayerNorm(2 * dim)
            self.skip_linear = Linear(2 * dim, dim)
        self.skip = skip
        self.adaln = nn.Module()
        self.adaln.lora_a = Linear(dim, 6 * rank, False)
        self.adaln.lora_b = Linear(6 * rank, 6 * dim, False)
        self.adaln.scale_shift_table = nn.Parameter(torch.empty(6, dim))
        self.scaling = alpha / rank
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.norm_context = LayerNorm(dim)
        self.attn = Attn(dim, heads, True)
        self.cross_attn = Attn(dim, heads, False)
        inner = int(dim * mlp_ratio)
        self.mlp = nn.Module()
        self.mlp.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(inner, dim)])
        self.mlp.net[0].proj = Linear(dim, 2 * inner)

    def forward(self, x, tt, time_ada, ctx, ctx_mask, skip=None):
        if self.skip:
            x = self.skip_linear(self.skip_norm(torch.cat([x, skip], dim=-1)))
        a = self.adaln
        mod = time_ada + a.lora_b(a.lora_a(tt)) * self.scaling
        mod = mod.reshape(-1, 6, x.shape[-1]) + a.scale_shift_table[None]
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=1)
        x = x + (1 - g1) * self.attn(self.norm1(x) * (1 + sc1) + sh1)
        x = x + self.cross_attn(self.norm2(x), self.norm_context(ctx), ctx_mask)
        h = self.mlp.net[0].proj(self.norm3(x) * (1 + sc2) + sh2)
        u, gate = h.chunk(2, dim=-1)
        return x + (1 - g2) * self.mlp.net[2](u * F.gelu(gate))


class MaskDiT(nn.Module):
    """MaskDiT around the U-shaped DiT of the EzAudio configurations
    (1-d input, patch 1, AdaLN-SOLA-bias, cross-attention, shared RoPE,
    GEGLU, qk-LayerNorm, long skips with their norm, the output conv)."""

    def __init__(self, m: dict):
        super().__init__()
        for key, want in (("input_type", "1d"), ("patch_size", 1), ("time_fusion", "ada_sola_bias"),
                          ("context_fusion", "cross"), ("rope_mode", "shared"),
                          ("act_layer", "geglu"), ("qk_norm", "layernorm"), ("skip", True),
                          ("skip_norm", True), ("use_conv", True), ("pe_method", "none"),
                          ("context_pe_method", "none"), ("context_norm", True), ("mae", True)):
            if m.get(key) != want:
                raise NotImplementedError(f"reference MaskDiT: {key}={m.get(key)!r}")
        D, C = m["embed_dim"], m["out_chans"]
        self.cfg = dict(m)
        self.mask_embed = nn.Parameter(torch.empty(C))
        u = self.model = nn.Module()
        u.patch_embed = nn.Module()
        u.patch_embed.proj = Conv1d(m["in_chans"], D, 1)
        u.context_embed = nn.ModuleList([Linear(m["context_dim"], D), nn.SiLU(), Linear(D, D)])
        u.time_embed = nn.Module()
        u.time_embed.mlp = nn.ModuleList([Linear(256, D), nn.SiLU(), Linear(D, D)])
        u.time_ada_final = Linear(D, 2 * D)
        u.time_ada = Linear(D, 6 * D)
        half = m["depth"] // 2
        blk = lambda skip: Block(D, m["num_heads"], m["mlp_ratio"], m["ada_sola_rank"],  # noqa: E731
                                 m["ada_sola_alpha"], skip)
        u.in_blocks = nn.ModuleList([blk(False) for _ in range(half)])
        u.mid_block = blk(False)
        u.out_blocks = nn.ModuleList([blk(True) for _ in range(half)])
        u.final_block = nn.Module()
        u.final_block.norm = LayerNorm(D)
        u.final_block.linear = Linear(D, C)
        u.final_block.final_layer = Conv1d(C, C, 3, padding=1)

    def concat_input(self, x):
        """The UDiT input of generation: ``[x, mask embedding, mask row]``."""
        B, L, C = x.shape
        embed = self.mask_embed[None, None, :].expand(B, L, C)
        return torch.cat([x, embed, torch.ones_like(x[..., :1])], dim=-1)

    def forward(self, x, t, ctx, ctx_mask):
        u = self.model
        h = self.concat_input(x)
        t = torch.as_tensor(t, device=x.device)
        t = t.expand(x.shape[0]) if t.ndim == 0 else t
        w = u.patch_embed.proj.operand(u.patch_embed.proj.weight[:, :, 0])
        h = F.linear(u.patch_embed.proj.operand(h), w, u.patch_embed.proj.bias)
        ce = u.context_embed
        c = ce[2](F.silu(ce[0](ctx)))
        te = u.time_embed.mlp
        tt = F.silu(te[2](F.silu(te[0](timestep_embedding(t)))))
        ada_final, ada = u.time_ada_final(tt), u.time_ada(tt)[:, None, :]
        tt = tt[:, None, :]
        skips = []
        for blk in u.in_blocks:
            h = blk(h, tt, ada, c, ctx_mask)
            skips.append(h)
        h = u.mid_block(h, tt, ada, c, ctx_mask)
        for blk in u.out_blocks:
            h = blk(h, tt, ada, c, ctx_mask, skips.pop())
        fb = u.final_block
        shift, scale = ada_final.reshape(-1, 2, h.shape[-1]).chunk(2, dim=1)
        h = fb.linear(fb.norm(h) * (1 + scale) + shift)
        return fb.final_layer(h.transpose(1, 2)).transpose(1, 2)


# ---------------------------------------------------------------- the VAE

def snake(x, alpha, beta):
    return x + (1.0 / (beta.exp()[None, :, None] + 1e-9)) * torch.sin(
        x * alpha.exp()[None, :, None]).square()


class Snake(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))
        self.beta = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return snake(x, self.alpha, self.beta)


class ResUnit(nn.Module):
    def __init__(self, c, d):
        super().__init__()
        self.layers = nn.Sequential(Snake(c), Conv1d(c, c, 7, padding=3 * d, dilation=d),
                                    Snake(c), Conv1d(c, c, 1))

    def forward(self, x):
        return x + self.layers(x)


class VAE(nn.Module):
    """The Oobleck VAE: ``encoder`` to mean || scale, ``decoder`` from the
    latent; (B, C, T) inside, channel-last (B, L, C) outside."""

    def __init__(self, vae_cfg: dict):
        super().__init__()
        m = vae_cfg["model"]
        dec = m["decoder"]["config"]
        ch, strides = dec["channels"], tuple(dec["strides"])
        mults = (1,) + tuple(dec["c_mults"])
        lat = m["latent_dim"]
        enc = [Conv1d(m.get("io_channels", 1), ch, 7, padding=3)]
        for i, s in enumerate(strides):
            cin, cout = mults[i] * ch, mults[i + 1] * ch
            enc.append(nn.Module())
            enc[-1].layers = nn.Sequential(
                *(ResUnit(cin, d) for d in (1, 3, 9)), Snake(cin),
                Conv1d(cin, cout, 2 * s, stride=s, padding=math.ceil(s / 2)))
        enc += [Snake(mults[-1] * ch), Conv1d(mults[-1] * ch, 2 * lat, 3, padding=1)]
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(enc)
        decl = [Conv1d(lat, mults[-1] * ch, 7, padding=3)]
        for i in range(len(strides), 0, -1):
            cin, cout, s = mults[i] * ch, mults[i - 1] * ch, strides[i - 1]
            decl.append(nn.Module())
            decl[-1].layers = nn.Sequential(
                Snake(cin), ConvTranspose1d(cin, cout, 2 * s, stride=s, padding=math.ceil(s / 2)),
                *(ResUnit(cout, d) for d in (1, 3, 9)))
        decl += [Snake(ch), Conv1d(ch, m.get("io_channels", 1), 7, padding=3, bias=False)]
        if dec.get("final_tanh", False):
            raise NotImplementedError("reference VAE: final_tanh")
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(decl)

    @staticmethod
    def _run(layers, x):
        for layer in layers:
            x = layer.layers(x) if hasattr(layer, "layers") and not isinstance(
                layer, ResUnit) else layer(x)
        return x

    def decode(self, z):
        """z (B, L, latent) -> waveform (B, T)."""
        return self._run(self.decoder.layers, z.transpose(1, 2))[:, 0]


# ---------------------------------------------------------------- samplers

class Schedule:
    """Scaled-linear betas, zero terminal SNR, trailing spacing, v-prediction."""

    def __init__(self, diff: dict):
        for key, want in (("beta_schedule", "scaled_linear"), ("prediction_type", "v_prediction"),
                          ("timestep_spacing", "trailing"), ("rescale_betas_zero_snr", True),
                          ("clip_sample", False)):
            if diff.get(key) != want:
                raise NotImplementedError(f"reference schedule: {key}={diff.get(key)!r}")
        n = self.n = int(diff["num_train_timesteps"])
        betas = np.linspace(diff["beta_start"] ** 0.5, diff["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        s = np.sqrt(np.cumprod(1.0 - betas))
        s = (s - s[-1]) * s[0] / (s[0] - s[-1])
        self.abar = (s ** 2)  # float64

    def timesteps(self, steps: int) -> np.ndarray:
        return np.round(np.arange(self.n, 0, -self.n / steps)).astype(np.int64) - 1


def rescale_cfg(pred, cond, rescale: float):
    dims = tuple(range(1, cond.ndim))
    r = pred * (cond.std(dim=dims, keepdim=True) / pred.std(dim=dims, keepdim=True))
    return rescale * r + (1.0 - rescale) * pred


def guided(out, scale: float, rescale: float):
    cond, uncond = out.chunk(2, dim=0)
    pred = uncond + scale * (cond - uncond)
    return rescale_cfg(pred, cond, rescale) if rescale > 0 else pred


def ddim_update(sched: Schedule, steps: int, i: int, x, v, noise, eta: float):
    """DDIM step ``i`` of ``steps`` from ``x`` and the guided v-prediction
    ``v``, with eta noise ``noise``."""
    ts = sched.timesteps(steps)
    prev = ts[i] - sched.n // steps
    a_t = float(sched.abar[ts[i]])
    a_p = float(sched.abar[prev]) if prev >= 0 else 1.0
    x0 = math.sqrt(a_t) * x - math.sqrt(1 - a_t) * v
    eps = math.sqrt(a_t) * v + math.sqrt(1 - a_t) * x
    std = eta * math.sqrt((1 - a_p) / (1 - a_t) * (1 - a_t / a_p))
    out = math.sqrt(a_p) * x0 + math.sqrt(max(1 - a_p - std ** 2, 0.0)) * eps
    return out + std * noise if eta > 0 else out


def ddim_sample(model_fn, sched: Schedule, x, steps: int, cfg: float, rescale: float,
                eta: float, step_noise):
    """DDIM with CFG on the pair ``[x; x]`` and eta noise ``step_noise(i)``."""
    for i, t in enumerate(sched.timesteps(steps)):
        v = guided(model_fn(torch.cat([x, x]), int(t)), cfg, rescale)
        x = ddim_update(sched, steps, i, x, v, step_noise(i) if eta > 0 else None, eta)
    return x


# ---------------------------------------------------------------- the pipeline

class Pipeline(nn.Module):
    """T5, MaskDiT and the VAE of one configuration (``config`` holds the
    ``model``, ``t5``, ``vae``, ``autoencoder``, ``text_encoder`` and
    ``diff`` blocks of a benchmark configuration file)."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = config
        self.t5 = T5(config["t5"])
        self.dit = MaskDiT(config["model"])
        self.vae = VAE(config["vae"])
        self.sched = Schedule(config["diff"])
        ae = config["autoencoder"]
        self.scale, self.shift = float(ae.get("scale", 1.0)), float(ae.get("shift", 0.0))

    def tokens(self, texts: Sequence[str], device):
        ids, mask = hash_tokenize(texts, self.config["t5"]["vocab_size"],
                                  self.config["text_encoder"]["max_length"])
        return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)

    def embed(self, texts: Sequence[str], device):
        ids, mask = self.tokens(texts, device)
        return self.t5(ids, mask), mask

    def context(self, texts, device):
        cond, cmask = self.embed(texts, device)
        unc, umask = self.embed([""] * len(texts), device)
        return torch.cat([cond, unc]), torch.cat([cmask, umask])

    def generate(self, texts: List[str], noise, recipe: dict, step_noise=None):
        """Waveforms (B, T) of ``texts`` from the starting ``noise`` (B, L, C)."""
        if recipe["sampler"] != "ddim":
            raise NotImplementedError(recipe["sampler"])
        ctx, cmask = self.context(texts, noise.device)
        fn = lambda x, t: self.dit(x, t, ctx, cmask)  # noqa: E731
        lat = ddim_sample(fn, self.sched, noise, recipe["steps"], recipe["guidance_scale"],
                          recipe["guidance_rescale"], recipe["eta"], step_noise)
        return self.vae.decode(lat / self.scale - self.shift)
