"""Every UDiT/MaskDiT architecture switch of the port against the JAX
package on the CPU, f32 (``jax_default_matmul_precision='highest'``):
the combinations of ``tests/test_dit.py::TestAlternativeUDiTModes`` and
``::TestUDiT2D``, ``ada``, ``cls_dim`` (AdaLN and token), the conv PE and
the other activations, forward within 1e-5; the gradients of two
combinations against ``jax.grad``; RoPE's prefix rule; the
reference-torch golden ``maskdit_tiny2.npz`` loaded strictly.  The JAX
side is built by a shape-only seeded ``Module.init``, so every leaf is
non-zero (ROADMAP F6)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict
from ezaudio_tpu_torch.convert.from_jax import (maskdit_state_dict_from_jax,
                                                udit_state_dict_from_jax)
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from ezaudio_tpu_torch.models.udit import UDiT
from tests.test_torch_controlnet import _seeded_init

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL = 1e-5
GOLDEN_ATOL = 2e-3

# tests/test_dit.py::TestAlternativeUDiTModes' base and its five cases
BASE = dict(img_size=16, patch_size=1, in_chans=4, out_chans=4, embed_dim=32, depth=2,
            num_heads=4, context_dim=8, context_fusion="concat", context_max_length=5,
            context_pe_method="sinu", pe_method="abs", time_fusion="token", qk_norm=None,
            act_layer="gelu", rope_mode="none", skip=True, use_conv=True,
            use_checkpoint=False)
SOLA = dict(ada_sola_rank=4, ada_sola_alpha=8.0)
CASES = {
    "token_concat_abs_sinu": {},
    "rope_x_only": dict(context_pe_method="none", pe_method="none", rope_mode="x_only",
                        act_layer="geglu", skip=False, use_conv=False),
    "rope_dual": dict(context_pe_method="none", pe_method="none", rope_mode="dual"),
    "ada_single": dict(time_fusion="ada_single", context_fusion="cross", qk_norm="rmsnorm",
                       norm_layer="rmsnorm"),
    "snake_ff": dict(act_layer="gesnake"),
    # TestUDiT2D
    "2d": dict(img_size=(8, 16), patch_size=4, in_chans=3, out_chans=3, input_type="2d",
               context_fusion="cross", context_pe_method="none", time_fusion="ada_single",
               act_layer="geglu"),
    "ada": dict(time_fusion="ada", rope_mode="x_only", qkv_bias=True),
    "ada_sola_bias_joint_cls": dict(time_fusion="ada_sola_bias", context_fusion="joint",
                                    cls_dim=6, rope_mode="shared", skip_norm=False, **SOLA),
    "token_cls_dual": dict(cls_dim=6, rope_mode="dual", qk_norm="layernorm"),
    "conv_pe": dict(pe_method="conv", context_pe_method="abs", time_fusion="ada_single"),
    "gelu_approximate": dict(act_layer="gelu-approximate", time_fusion="ada_sola", **SOLA),
    "geglu_approximate": dict(act_layer="geglu-approximate", context_fusion="cross",
                              time_fusion="ada_single", context_pe_method="sinu"),
    "snake": dict(act_layer="snake", time_fusion="ada_single", use_conv=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kw, seed=0):
    rng = np.random.default_rng(seed)
    B = 2
    if kw.get("input_type") == "2d":
        x = rng.standard_normal((B, *kw["img_size"], kw["in_chans"]))
    else:
        x = rng.standard_normal((B, kw["img_size"], kw["in_chans"]))
    ctx = rng.standard_normal((B, 5, kw["context_dim"]))
    cmask = np.ones((B, 5), bool)
    cmask[0, 3:] = False
    cls = rng.standard_normal((B, kw["cls_dim"])) if kw.get("cls_dim") else None
    f = lambda a: None if a is None else a.astype(np.float32)  # noqa: E731
    return f(x), np.array([3, 900]), f(ctx), cmask, f(cls)


def _pair(kw, seed=0):
    """The JAX UDiT with seeded params, and the port's on them."""
    from flax import linen as nn

    from ezaudio_tpu.models.udit import UDiT as JaxUDiT

    jm = JaxUDiT(**kw)
    x, t, ctx, cmask, cls = _inputs(kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(seed)))
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(ctx), context_mask=jnp.asarray(cmask),
                         cls_token=None if cls is None else jnp.asarray(cls))
    tm = UDiT(**kw)
    load_state_dict_strict(tm, udit_state_dict_from_jax(params["params"], kw), "jax")
    return jm, params, tm


def _torch(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    kw = dict(BASE, **CASES[case])
    jm, params, tm = _pair(kw)
    x, t, ctx, cmask, cls = _inputs(kw, seed=1)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, ctx, context_mask=cmask,
                                        cls_token=cls))
    with torch.no_grad():
        got = tm(_torch(x), _torch(t), _torch(ctx), context_mask=_torch(cmask),
                 cls_token=_torch(cls)).numpy()
    assert got.shape == want.shape == x.shape[:-1] + (kw["out_chans"],)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["concat_ada_single_x_only", "token_concat_dual"])
def test_gradients_match_jax(case):
    kw = dict(BASE, **{
        "concat_ada_single_x_only": dict(time_fusion="ada_single", rope_mode="x_only",
                                         qk_norm="rmsnorm", norm_layer="rmsnorm",
                                         qkv_bias=True),
        "token_concat_dual": dict(rope_mode="dual", act_layer="gesnake"),
    }[case])
    jm, params, tm = _pair(kw)
    x, t, ctx, cmask, cls = _inputs(kw, seed=2)
    w = np.random.default_rng(3).standard_normal(x.shape[:-1] + (kw["out_chans"],))
    w = w.astype(np.float32)

    def loss(p, x, ctx):
        return jnp.sum(jm.apply(p, x, t, ctx, context_mask=cmask) * w)

    gp, gx, gc = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, x, ctx)
    want = udit_state_dict_from_jax(jax.device_get(gp["params"]), kw)
    xt, ct = (_torch(a).requires_grad_() for a in (x, ctx))
    # torch's f32 sin/cos of t*f (up to 900 here) differ from XLA's by up to
    # 2.9e-5, which reaches time_embed.mlp.0's gradient at 2e-5 of its
    # scale: the port takes JAX's frequency embedding, held here apart
    from ezaudio_tpu.ops.embeddings import timestep_embedding as jax_emb

    from ezaudio_tpu_torch.ops import embeddings

    ours = embeddings.timestep_embedding(_torch(t), 256).numpy()
    theirs = np.asarray(jax_emb(jnp.asarray(t), 256))
    assert np.abs(ours - theirs).max() <= 3e-5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(embeddings, "timestep_embedding", lambda ts, dim: torch.from_numpy(
            np.array(jax_emb(jnp.asarray(ts.numpy()), dim))))
        (tm(xt, _torch(t), ct, context_mask=_torch(cmask)) * _torch(w)).sum().backward()
    got = dict(tm.named_parameters())
    assert set(got) <= set(want)
    pairs = [(n, got[n].grad, want[n]) for n in got]
    pairs += [("x", xt.grad, gx), ("ctx", ct.grad, gc)]
    for name, g, ref in pairs:
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert g is not None and float(np.abs(ref).max()) > 0, name
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= ATOL * scale, (name, err, scale)


def test_remat_keeps_the_gradients():
    """``use_checkpoint`` (each remat policy) on a token + concat + dual
    UDiT: the same output and gradients as without remat."""
    kw = dict(BASE, **CASES["token_cls_dual"])
    x, t, ctx, cmask, cls = (_torch(a) for a in _inputs(kw, seed=4))
    grads = []
    for remat in (False, "full", "dots"):
        torch.manual_seed(0)
        m = UDiT(**dict(kw, use_checkpoint=bool(remat), remat_policy=remat or "auto"))
        out = m(x, t, ctx, context_mask=cmask, cls_token=cls)
        out.square().sum().backward()
        grads.append((out.detach(), {n: p.grad for n, p in m.named_parameters()}))
    for out, g in grads[1:]:
        torch.testing.assert_close(out, grads[0][0], rtol=0, atol=1e-6)
        for n, v in g.items():
            torch.testing.assert_close(v, grads[0][1][n], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("extras", [0, 1, 3, 15, 16, 20])
def test_rope_skip_prefix_matches_jax(extras):
    from ezaudio_tpu.ops.rope import apply_rope_skip_prefix as jax_rope
    from ezaudio_tpu.ops.rope import rope_tables as jax_tables

    from ezaudio_tpu_torch.ops.rope import apply_rope_skip_prefix, rope_tables

    L, D = 16, 8
    x = np.random.default_rng(extras).standard_normal((2, 3, L, D)).astype(np.float32)
    cos, sin = rope_tables(L, D)
    got = apply_rope_skip_prefix(torch.from_numpy(x), cos, sin, extras).numpy()
    want = np.asarray(jax_rope(jnp.asarray(x), *jax_tables(L, D), extras))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., :extras, :], x[..., :extras, :])


def test_unknown_switches_raise():
    for kw in (dict(rope_mode="half"), dict(time_fusion="film"), dict(pe_method="learned"),
               dict(context_pe_method="rel"), dict(act_layer="relu"),
               dict(input_type="3d"), dict(context_fusion="add")):
        with pytest.raises(NotImplementedError):
            UDiT(**dict(BASE, **kw))
    with pytest.raises(NotImplementedError):
        maskdit_from_config(dict(BASE, input_type="2d", img_size=(8, 16)))
    m = UDiT(**BASE)
    x, t, ctx, cmask, _ = _inputs(BASE)
    with pytest.raises(ValueError, match="context_max_length"):
        m(_torch(x), _torch(t), _torch(ctx[:, :4]), context_mask=_torch(cmask[:, :4]))
    with pytest.raises(ValueError, match="cls_token"):
        UDiT(**dict(BASE, cls_dim=6))(_torch(x), _torch(t), _torch(ctx))


# tests/test_parity.py::TestMaskDiTVariantParity.VARIANT
VARIANT = dict(
    mae=True, mae_prob=0.25, mask_ratio=[0.25, 1.0], mask_span=4,
    img_size=32, patch_size=1, in_chans=17, out_chans=8, input_type="1d",
    embed_dim=64, depth=4, num_heads=4, mlp_ratio=2.0,
    qkv_bias=True, qk_scale=None, qk_norm="rmsnorm",
    norm_layer="rmsnorm", act_layer="gelu", context_norm=False,
    use_checkpoint=False, time_fusion="ada_single",
    ada_sola_rank=None, ada_sola_alpha=None, cls_dim=None,
    context_dim=24, context_fusion="concat", context_max_length=5,
    context_pe_method="sinu", pe_method="abs", rope_mode="x_only",
    use_conv=False, skip=True, skip_norm=False,
)


def test_golden_maskdit_tiny2():
    """The reference-torch state dict loads strictly; the output is held
    to the reference's within GOLDEN_ATOL (the JAX package's own bound)."""
    d = dict(np.load(os.path.join(FIXTURES, "maskdit_tiny2.npz")))
    sd = {k[len("sd."):]: torch.from_numpy(v) for k, v in d.items() if k.startswith("sd.")}
    model = maskdit_from_config(VARIANT)
    load_state_dict_strict(model, sd, "maskdit_tiny2.npz")
    with torch.no_grad():
        out, _ = model(torch.from_numpy(d["x"].transpose(0, 2, 1)), torch.from_numpy(d["t"]),
                       torch.from_numpy(d["ctx"]), context_mask=torch.from_numpy(d["cmask"]))
    want = d["out"].transpose(0, 2, 1)
    err = float(np.abs(out.numpy() - want).max())
    assert err <= GOLDEN_ATOL, err
    # the JAX package's MaskDiT on the same weights, through its converter
    from ezaudio_tpu.convert.torch_to_jax import convert_maskdit_state_dict
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit

    jp = {"params": convert_maskdit_state_dict(
        {k: v.numpy() for k, v in sd.items()}, VARIANT)}
    jout, _ = jax.jit(jax_maskdit(VARIANT).apply)(
        jp, jnp.asarray(d["x"].transpose(0, 2, 1)), jnp.asarray(d["t"]),
        jnp.asarray(d["ctx"]), context_mask=jnp.asarray(d["cmask"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)


def test_maskdit_passes_cls_token_and_jax_weights():
    """MaskDiT with ``cls_dim``: the class token reaches UDiT through
    ``forward`` and ``forward_backbone``; carried JAX weights match."""
    from flax import linen as nn

    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit

    cfg = dict(VARIANT, cls_dim=6, depth=2, embed_dim=32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 24)).astype(np.float32)
    cls = rng.standard_normal((2, 6)).astype(np.float32)
    t = np.array([4, 700])
    jm = jax_maskdit(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(6)))
        params = jm.init(jax.random.PRNGKey(0), x, t, ctx, cls_token=cls)
    want, _ = jax.jit(jm.apply)(params, x, t, ctx, cls_token=cls)
    tm = maskdit_from_config(cfg)
    load_state_dict_strict(tm, maskdit_state_dict_from_jax(params["params"], cfg), "jax")
    with torch.no_grad():
        got, _ = tm(_torch(x), _torch(t), _torch(ctx), cls_token=_torch(cls))
        concat, _ = tm(_torch(x), _torch(t), _torch(ctx), forward_model=False)
        backbone = tm.forward_backbone(concat, _torch(t), _torch(ctx), cls_token=_torch(cls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(backbone.numpy(), got.numpy())
