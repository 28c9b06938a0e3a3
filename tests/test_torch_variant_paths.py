"""The UDiT variants on the port's paths, on the CPU against the JAX
package: ``DiTControlNet`` with concat context, the CFG wrappers
(``models/cfg_wrappers.py``) with the JAX drop decisions handed in, and
one tiny ``EzAudio(config=<variant>)`` end to end (eta 0, injected
initial latents; staged, ``fused=True`` and int8), plus the bf16 dtype
rule of the new leaves.  f32, ``jax_default_matmul_precision='highest'``;
the JAX side is built by a shape-only seeded ``Module.init``."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict
from ezaudio_tpu_torch.convert.from_jax import (cfg_wrapper_state_dict_from_jax,
                                                controlnet_state_dict_from_jax,
                                                maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax,
                                                udit_state_dict_from_jax,
                                                vae_state_dict_from_jax)
from ezaudio_tpu_torch.models import cfg_wrappers as tcfg
from ezaudio_tpu_torch.models.controlnet import controlnet_from_config
from ezaudio_tpu_torch.models.udit import UDiT
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.test_torch_controlnet import _seeded_init
from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

ATOL = 1e-5
# the golden's switch set at the tiny config's widths; the context is the
# 12-token tokenizer output
VARIANT_MODEL = dict(
    TINY_CONFIG["model"], qkv_bias=True, qk_norm="rmsnorm", norm_layer="rmsnorm",
    act_layer="gelu", context_norm=False, time_fusion="ada_single", ada_sola_rank=None,
    ada_sola_alpha=None, context_fusion="concat",
    context_max_length=TINY_CONFIG["text_encoder"]["max_length"], context_pe_method="sinu",
    pe_method="abs", rope_mode="x_only", use_conv=False, skip_norm=False)
VARIANT = dict(TINY_CONFIG, model=VARIANT_MODEL)
CN_CFG = dict(cond_in=1, cond_blocks=[8, 16], cond_mask=True, cond_mask_prob=0.25,
              cond_mask_ratio=[0.25, 0.5], cond_mask_span=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant_init(rng, context_len):
    """``_seeded_init`` whose MaskDiT shape pass gets a context of
    ``context_len`` tokens: the JAX ``EzAudio`` traces its init with a
    1-token context, which concat fusion refuses."""
    seeded = _seeded_init(rng)

    def init(self, rngs, *args, **kw):
        if len(args) >= 3 and getattr(args[2], "ndim", 0) == 3:
            c = args[2]
            args = (*args[:2], jnp.zeros((c.shape[0], context_len, c.shape[2]), c.dtype),
                    *args[3:])
        return seeded(self, rngs, *args, **kw)

    return init


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny EzAudio at the variant and the port on its weights."""
    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _variant_init(np.random.default_rng(21),
                                                    VARIANT_MODEL["context_max_length"]))
        jez = JaxEzAudio(config=VARIANT, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    ez = EzAudio(config=VARIANT, t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                 vae_config=TINY_VAE_CONFIG, device="cpu")
    load_state_dict_strict(ez.dit, maskdit_state_dict_from_jax(
        jax.device_get(jez.dit_params["params"]), VARIANT_MODEL), "jax")
    ez.t5.load_state_dict(t5_state_dict_from_jax(jez.t5_params, TINY_T5.num_layers))
    ez.autoencoder.model.load_state_dict(vae_state_dict_from_jax(jez.autoencoder.params))
    return jez, ez


def test_generate_audio_matches_jax(tiny_pair):
    """Two prompts, CFG 3 + rescale 0.75, 3 DDIM steps, eta 0, the same
    initial latents: waveform atol 1e-4 and corr > 0.9999 (the main
    path's rule, tests/test_torch_pipeline.py); ``fused=True`` equal to
    staged; DPM with layer caching by the same rule."""
    jez, ez = tiny_pair
    prompts = ["a dog barking", "rain on a tin roof"]
    noise = np.random.default_rng(2).standard_normal((2, 50, 8)).astype(np.float32)
    kw = dict(length=1.0, guidance_scale=3.0, guidance_rescale=0.75, ddim_steps=3, eta=0.0,
              random_seed=0, initial_latents=noise)
    _, want = jez.generate_audio(prompts, **kw)
    _, got = ez.generate_audio(prompts, **kw)
    assert got.shape == want.shape == (2, 800)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    _, fused = ez.generate_audio(prompts, fused=True, **kw)
    np.testing.assert_array_equal(fused, got)
    # layer caching in concat mode: the cached deep activation covers the
    # context prefix too
    kw = dict(kw, sampler="dpm", layer_cache=(1, 2))
    _, want = jez.generate_audio(prompts, **kw)
    _, got = ez.generate_audio(prompts, **kw)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_int8_matches_jax(tiny_pair, monkeypatch):
    """The variant's MaskDiT with every linear on the int8 route
    (MIN_QUANT_ELEMENTS = 0 on both sides), by tests/test_torch_quant.py's
    rule: (a) with JAX's ``int8_dot`` in every ``QuantLinear`` (each new
    linear among them) the output is bit-equal; (b) against JAX's MaskDiT
    under its ``quant_context('int8')``: corr > 0.9999, atol 0.05 (an int8
    forward is discontinuous).  ``generate_audio(quant='int8')`` runs."""
    import ezaudio_tpu.ops.quant as jq

    from ezaudio_tpu_torch.ops import quant

    monkeypatch.setattr(jq, "MIN_QUANT_ELEMENTS", 0)
    monkeypatch.setattr(quant, "MIN_QUANT_ELEMENTS", 0)
    jez, ez = tiny_pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 50, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    cmask = np.ones((2, 12), bool)
    cmask[0, 4:] = False
    t = np.array([10, 500])

    def port():
        with torch.no_grad(), quant.quant_context("int8"):
            return ez.dit(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          context_mask=torch.from_numpy(cmask))[0].numpy()

    seen = set()
    orig = quant.QuantLinear.forward

    def counted(self, h):
        seen.add(id(self))
        return orig(self, h)

    monkeypatch.setattr(quant.QuantLinear, "forward", counted)
    got = port()
    assert {id(m) for m in ez.dit.modules() if isinstance(m, quant.QuantLinear)} <= seen

    def jax_forward(self, h):
        y = jq.int8_dot(jnp.asarray(h.numpy()), jnp.asarray(self.weight.numpy().T))
        y = torch.from_numpy(np.array(y))
        return y if self.bias is None else y + self.bias

    monkeypatch.setattr(quant.QuantLinear, "forward", jax_forward)
    np.testing.assert_array_equal(port(), got)
    monkeypatch.setattr(quant.QuantLinear, "forward", orig)
    with jq.quant_context("int8"):  # read while tracing
        want, _ = jax.jit(jez.dit.apply)(jez.dit_params, x, t, ctx, context_mask=cmask)
    want = np.asarray(want)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    np.testing.assert_allclose(got, want, atol=0.05)
    kw = dict(length=1.0, ddim_steps=2, eta=0.0, random_seed=0, initial_latents=x[:1])
    _, w8 = ez.generate_audio("a dog barking", quant="int8", **kw)
    _, w32 = ez.generate_audio("a dog barking", **kw)
    assert np.isfinite(w8).all() and np.abs(w8 - w32).max() > 1e-6


def test_jax_ezaudio_cannot_draw_a_concat_model():
    """ROADMAP F15: the JAX ``EzAudio`` draws its DiT by tracing
    ``init`` with a 1-token context, which concat fusion refuses, so it
    builds a concat config only from a checkpoint; the port draws its
    weights without a forward and builds it."""
    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio

    with pytest.raises(AssertionError, match="context_max_length"):
        JaxEzAudio(config=VARIANT, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    ez = EzAudio(config=VARIANT, t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                 vae_config=TINY_VAE_CONFIG, device="cpu")
    assert ez.dit.model.extras == VARIANT_MODEL["context_max_length"]


def test_tokenizer_length_must_equal_context_max_length():
    bad = dict(VARIANT, model=dict(VARIANT_MODEL, context_max_length=11))
    with pytest.raises(ValueError, match="max_length"):
        EzAudio(config=bad, t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                vae_config=TINY_VAE_CONFIG, device="cpu")


def test_controlnet_api_runs_a_concat_model():
    """``EzAudioControlNet`` on the variant (its 10 s window: 500 frames
    and abs PEs that long): the concat ControlNet's skips, each covering
    the 12 context tokens and the frames, reach the backbone; scale 0 is
    the base model, which scale 1 must differ from (ROADMAP F6)."""
    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from tests.test_torch_controlnet import COND_CFG, burst_clip

    cfg = dict(VARIANT, model=dict(VARIANT_MODEL, img_size=500), controlnet=CN_CFG,
               conditioner=COND_CFG)
    cn = EzAudioControlNet(config=cfg, t5_config=T5EncoderConfig(**dataclasses.asdict(TINY_T5)),
                           vae_config=TINY_VAE_CONFIG, device="cpu")
    kw = dict(ddim_steps=2, eta=0.0, random_seed=3, sampler="dpm")
    _, w1 = cn.generate_audio("a tone", burst_clip(), **kw)
    _, w0 = cn.generate_audio("a tone", burst_clip(), conditioning_scale=0.0, **kw)
    assert w1.shape == w0.shape == (1600,) and np.isfinite(w1).all()
    assert np.abs(w1 - w0).max() > 1e-6


def _jax_init(module, *args, seed=0, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(seed)))
        return module.init({"params": jax.random.PRNGKey(0), "cfg": jax.random.PRNGKey(1),
                            "mask": jax.random.PRNGKey(2)}, *args, **kw)


def test_controlnet_concat_matches_jax():
    """``DiTControlNet`` with concat context (ada_single, x_only RoPE, abs
    x-PE, sinu context PE) on carried non-zero weights: its 2 skips, each
    (B, Lc + L, D), at conditioning scale 0.7 within 1e-5."""
    from ezaudio_tpu.models.controlnet import controlnet_from_config as jax_controlnet

    model_cfg = dict(VARIANT_MODEL, context_max_length=6, img_size=20)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 20, 17)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    cmask = np.ones((2, 6), bool)
    cmask[0, 2:] = False
    cond = rng.uniform(0, 1, (2, 40, 1)).astype(np.float32)
    t = np.array([10, 500])
    jcn = jax_controlnet(model_cfg, CN_CFG)
    params = _jax_init(jcn, x, t, ctx, context_mask=cmask, condition=cond, seed=9)
    want = jax.jit(functools.partial(jcn.apply, conditioning_scale=0.7))(
        params, x, t, ctx, context_mask=cmask, condition=cond)
    cn = controlnet_from_config(model_cfg, CN_CFG)
    load_state_dict_strict(cn, controlnet_state_dict_from_jax(
        jax.device_get(params["params"]), model_cfg, CN_CFG), "jax")
    with torch.no_grad():
        got = cn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                 context_mask=torch.from_numpy(cmask), condition=torch.from_numpy(cond),
                 conditioning_scale=0.7)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 26, 64) and float(np.abs(np.asarray(w)).max()) > 0.1
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match="token"):
        controlnet_from_config(dict(model_cfg, time_fusion="token"), CN_CFG)


@contextlib.contextmanager
def jax_uniforms():
    """The uniforms the JAX wrappers draw (their drop decisions are
    ``uniform < cfg_prob``), recorded while ``apply`` runs, jitted or not."""
    seen, orig = [], jax.random.uniform

    def uniform(*args, **kw):
        u = orig(*args, **kw)
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), u)
        return u

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        yield seen


BACKBONE = dict(img_size=16, patch_size=1, in_chans=4, out_chans=4, embed_dim=32, depth=2,
                num_heads=4, context_dim=8, context_fusion="cross", time_fusion="ada_single",
                qk_norm="layernorm", act_layer="geglu", rope_mode="x_only",
                pe_method="abs", context_pe_method="none", use_conv=True)


def test_embedding_and_discrete_cfg_match_jax():
    from ezaudio_tpu.models.cfg_wrappers import DiscreteCFG, EmbeddingCFG

    rng = np.random.default_rng(0)
    cond = rng.standard_normal((6, 5, 8)).astype(np.float32)
    mask = rng.uniform(size=(6, 5)) < 0.7
    jm = EmbeddingCFG(in_channels=8)
    v = jm.init({"params": jax.random.PRNGKey(0), "cfg": jax.random.PRNGKey(1)}, cond, mask, 0.5)
    key = jax.random.PRNGKey(3)
    with jax_uniforms() as u:
        want, want_mask = jm.apply(v, cond, mask, 0.5, rngs={"cfg": key})
    drop = torch.from_numpy(u[0] < 0.5)
    assert drop.any() and not drop.all()
    tm = tcfg.EmbeddingCFG(8)
    load_state_dict_strict(tm, cfg_wrapper_state_dict_from_jax(jax.device_get(v["params"])),
                           "jax")
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(cond), torch.from_numpy(mask), 0.5, drop=drop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    same, _ = tm(torch.from_numpy(cond), torch.from_numpy(mask), 0.0, drop=drop)
    np.testing.assert_array_equal(same.numpy(), cond)  # cfg_prob 0: passthrough
    # the null embedding is drawn N(0, 1) / sqrt(C) from the generator given
    g = torch.Generator().manual_seed(5)
    null = tcfg.EmbeddingCFG(4096, torch.Generator().manual_seed(5)).cfg_embedding
    np.testing.assert_array_equal(null.detach().numpy(),
                                  (torch.randn(4096, generator=g) / 64.0).numpy())
    ids = rng.integers(3, 100, (6, 7)).astype(np.int32)
    idmask = np.ones((6, 7), bool)
    jd = DiscreteCFG(replace_id=2)
    with jax_uniforms() as u:
        want, want_mask = jd.apply({}, ids, idmask, 0.5, rngs={"cfg": key})
    drop = torch.from_numpy(u[0] < 0.5)
    got, got_mask = tcfg.DiscreteCFG(2)(torch.from_numpy(ids), torch.from_numpy(idmask), 0.5,
                                        drop=drop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    # drawn from a generator: the rate follows cfg_prob
    drops = tcfg.DiscreteCFG(2)(torch.ones(4000, 3, dtype=torch.long), None, 0.25,
                                generator=torch.Generator().manual_seed(1))[0][:, 1] == 0
    assert 0.2 < drops.float().mean().item() < 0.3


@pytest.mark.parametrize("kind", ["CFGModel", "ConcatModel"])
def test_cfg_models_match_jax(kind):
    """``CFGModel`` (a cross-attention UDiT) and ``ConcatModel`` (a
    context-free UDiT fed [condition, x] on the channels, one stride-2
    stage) on carried weights, the JAX drop decisions handed in: 1e-5."""
    from ezaudio_tpu.models import cfg_wrappers as jcfg
    from ezaudio_tpu.models.udit import UDiT as JaxUDiT

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 4)).astype(np.float32)
    t = np.array([3, 40, 500, 900])
    if kind == "CFGModel":
        kw = BACKBONE
        ctx = rng.standard_normal((4, 5, 8)).astype(np.float32)
        cmask = rng.uniform(size=(4, 5)) < 0.8
        cmask[:, 0] = True
        jm = jcfg.CFGModel(context_dim=8, backbone=JaxUDiT(**kw))
        args, jkw = (x, t, ctx), dict(x_mask=None, context_mask=cmask)
    else:
        kw = dict(BACKBONE, context_dim=None, in_chans=4 + 6)
        ctx = rng.standard_normal((4, 32, 3)).astype(np.float32)
        jm = jcfg.ConcatModel(backbone=JaxUDiT(**kw), in_dim=3, strides=(2,))
        args, jkw = (x, t, ctx), {}
    params = _jax_init(jm, *args, seed=4, **jkw, cfg_prob=0.5)
    with jax_uniforms() as u:
        want = jax.jit(functools.partial(jm.apply, cfg_prob=0.5))(
            params, *args, **jkw, rngs={"cfg": jax.random.PRNGKey(2)})
        jax.effects_barrier()
    drop = torch.from_numpy(u[0] < 0.5)
    assert drop.any() and not drop.all()
    p = jax.device_get(params["params"])
    backbone = UDiT(**kw)
    if kind == "CFGModel":
        tm = tcfg.CFGModel(8, backbone)
        tkw = dict(context_mask=torch.from_numpy(cmask))
    else:
        tm = tcfg.ConcatModel(backbone, 3, strides=(2,))
        tkw = {}
    load_state_dict_strict(tm, cfg_wrapper_state_dict_from_jax(
        p, udit_state_dict_from_jax(p["backbone"], kw)), "jax")
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args), **tkw, cfg_prob=0.5, drop=drop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_keeps_the_jax_dtype_rule():
    """``cast_params_`` to bf16: the learned and sinusoidal PE tables, the
    conv PE's weight norm and the snakes' alpha/beta stay f32 (the JAX
    package casts them at use), every linear goes bf16; the bf16 forward
    runs and stays near the f32 one."""
    from ezaudio_tpu_torch.utils import cast_params_

    kw = dict(BACKBONE, context_fusion="concat", context_max_length=5,
              context_pe_method="sinu", pe_method="conv", act_layer="gesnake",
              time_fusion="token", cls_dim=3)
    m = UDiT(**kw)
    torch.manual_seed(0)
    for prm in m.parameters():
        prm.data.normal_(0, 0.2)
    x, ctx = torch.randn(2, 16, 4), torch.randn(2, 5, 8)
    t, cls = torch.tensor([3, 700]), torch.randn(2, 3)
    with torch.no_grad():
        ref = m(x, t, ctx, cls_token=cls)
        cast_params_(m, torch.bfloat16)
        got = m(x.bfloat16(), t, ctx.bfloat16(), cls_token=cls.bfloat16())
    keep = ("time_pe.abs_pe", "x_pe.conv_pe.conv.weight_g", "x_pe.conv_pe.conv.weight_v",
            "x_pe.conv_pe.conv.bias", "context_pe.sinu_pe.pe", "mlp.net.0.alpha",
            "mlp.net.0.beta", "norm", "rotary")
    for name, tensor in list(m.named_parameters()) + list(m.named_buffers()):
        want = torch.float32 if any(k in name for k in keep) else torch.bfloat16
        assert tensor.dtype == want, name
    assert got.dtype == torch.bfloat16
    rel = (got.float() - ref).abs().max() / ref.abs().max()
    assert rel < 0.05, rel
