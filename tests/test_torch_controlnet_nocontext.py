"""The energy ControlNet over a base without text context (``context_dim``
None, the MAE pretraining stage) against the JAX package's
``DiTControlNet``: what it builds, its skips on weights carried by
``convert/from_jax.py``, ``init_from_base_`` against JAX's
``init_params_from_base``, ``zero_projections_`` and a fine-tune step on
such a base.  The tiny model: depth 4 (2 ControlNet blocks), dim 64."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch.convert.from_jax import (controlnet_state_dict_from_jax,
                                                maskdit_state_dict_from_jax)
from ezaudio_tpu_torch.models.controlnet import (controlnet_from_config, init_from_base_,
                                                  zero_projections_)
from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
from tests.test_torch_controlnet import CN_CFG, _seeded_init
from tests.tiny_config import TINY_CONFIG

MODEL = dict(TINY_CONFIG["model"], context_dim=None)
L, IN_CHANS = MODEL["img_size"], MODEL["in_chans"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's no-context MaskDiT and ControlNet, every leaf drawn by shape
    from a seed (``_seeded_init``: none zero), and the ControlNet's
    parameters after ``init_params_from_base`` from that MaskDiT's UDiT."""
    from ezaudio_tpu.models.controlnet import controlnet_from_config as jax_controlnet
    from ezaudio_tpu.models.controlnet import init_params_from_base
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit

    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(41)))
        cn = jax_controlnet(MODEL, CN_CFG)
        cn_params = cn.init({"params": key, "mask": key}, jnp.zeros((1, L, IN_CHANS)),
                            jnp.zeros((1,), jnp.int32),
                            condition=jnp.zeros((1, 2 * L, 1)))["params"]
        base = jax_maskdit(MODEL)
        base_params = base.init({"params": key, "mask": key},
                                jnp.zeros((1, L, MODEL["out_chans"])),
                                jnp.zeros((1,), jnp.int32))["params"]
    return dict(cn=cn, params=cn_params, base_params=base_params,
                from_base=init_params_from_base(cn_params, base_params["model"]))


def _port(params):
    model = controlnet_from_config(MODEL, CN_CFG).eval()
    model.load_state_dict(controlnet_state_dict_from_jax(jax.device_get(params), MODEL, CN_CFG))
    return model


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, IN_CHANS)).astype(np.float32)
    cond = rng.uniform(0, 1, (B, 2 * L, 1)).astype(np.float32)
    return x, np.array([10, 500]), cond


def _jax_skips(jax_side, params, x, t, cond, scale):
    f = jax.jit(functools.partial(jax_side["cn"].apply, conditioning_scale=scale))
    return [np.asarray(s) for s in f({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                      condition=jnp.asarray(cond))]


def _port_skips(model, x, t, cond, scale):
    with torch.no_grad():
        return [s.numpy() for s in model(torch.from_numpy(x), torch.from_numpy(t),
                                         condition=torch.from_numpy(cond),
                                         conditioning_scale=scale)]


def test_builds_what_jax_builds(jax_side):
    """No ``context_embed``, no ``context_pe``, blocks without
    cross-attention; the converted JAX parameters load strictly, name for
    name; the AdaLN-only rule holds as in JAX."""
    model = _port(jax_side["params"])
    assert model.context_embed is None and model.context_pe is None
    assert all(not blk.cross for blk in model.in_blocks)
    names = {n for n, _ in model.named_parameters()}
    assert not any("context" in n or "cross_attn" in n for n in names)
    assert len(names) == len(jax.tree.leaves(jax_side["params"]))
    with pytest.raises(NotImplementedError, match="AdaLN"):
        controlnet_from_config(dict(MODEL, time_fusion="token"), CN_CFG)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_skips_equal_jax(jax_side, scale):
    """The depth // 2 = 2 skips on the carried non-zero weights, f32:
    atol 1e-5 (the text ControlNet's limit, ``test_torch_controlnet.py``)."""
    x, t, cond = _inputs(1)
    want = _jax_skips(jax_side, jax_side["params"], x, t, cond, scale)
    got = _port_skips(_port(jax_side["params"]), x, t, cond, scale)
    assert len(got) == len(want) == MODEL["depth"] // 2
    for g, w in zip(got, want):
        assert g.shape == (2, L, MODEL["embed_dim"]) and np.abs(w).max() > 0.1
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_scale_one_differs_from_scale_zero(jax_side):
    """Every drawn weight is non-zero (ROADMAP F6): at scale 1 the skips
    add something, at scale 0 nothing."""
    x, t, cond = _inputs(2)
    model = _port(jax_side["params"])
    one, zero = _port_skips(model, x, t, cond, 1.0), _port_skips(model, x, t, cond, 0.0)
    assert all(np.abs(s).max() > 0.1 for s in one)
    assert all(not s.any() for s in zero)


def test_init_from_base_equals_jax(jax_side):
    """``init_from_base_`` from the port's no-context MaskDiT (carried from
    JAX's) against JAX's ``init_params_from_base``: the same state dict,
    the same skips within 1e-5; the base untouched."""
    base = maskdit_from_config(MODEL)
    base.load_state_dict(maskdit_state_dict_from_jax(jax.device_get(jax_side["base_params"]),
                                                     MODEL))
    before = {k: v.clone() for k, v in base.state_dict().items()}
    model = init_from_base_(_port(jax_side["params"]), base.model)
    want = _port(jax_side["from_base"])
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(model.in_blocks[0].attn.to_q.weight, base.model.in_blocks[0].attn.to_q.weight)
    x, t, cond = _inputs(3)
    for g, w in zip(_port_skips(model, x, t, cond, 1.0),
                    _jax_skips(jax_side, jax_side["from_base"], x, t, cond, 1.0)):
        np.testing.assert_allclose(g, w, atol=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in base.state_dict().items())


def test_zero_projections_add_nothing(jax_side):
    """After ``zero_projections_`` the ControlNet adds nothing at any scale,
    where JAX's init starts; the embedders and blocks keep their weights."""
    model = _port(jax_side["params"])
    q = model.in_blocks[1].attn.to_q.weight.clone()
    zero_projections_(model)
    x, t, cond = _inputs(4)
    for scale in (1.0, 2.5):
        assert all(not s.any() for s in _port_skips(model, x, t, cond, scale))
    assert torch.equal(model.in_blocks[1].attn.to_q.weight, q)
    assert not model.controlnet_pre.mask_embed.any()


def test_fine_tune_step_on_a_base_without_text(jax_side):
    """``make_controlnet_train_step`` over the no-context base (no ``text``
    in the batch): a finite loss and non-zero gradients; the step moves the
    trainable subset alone (``trainable_mask``) and leaves the base as it
    was."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.controlnet import trainable_mask
    from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step

    base = maskdit_from_config(MODEL)
    base.load_state_dict(maskdit_state_dict_from_jax(jax.device_get(jax_side["base_params"]),
                                                     MODEL))
    cn = init_from_base_(_port(jax_side["params"]), base.model)
    base_before = {k: v.clone() for k, v in base.state_dict().items()}
    cn_before = {k: v.detach().clone() for k, v in cn.named_parameters()}
    step = make_controlnet_train_step(base, cn, DDIMSchedule.from_config(TINY_CONFIG["diff"]),
                                      learning_rate=1e-3, warmup=0)
    rng = np.random.default_rng(5)
    batch = {"latents": torch.tensor(rng.standard_normal((2, L, MODEL["out_chans"])),
                                     dtype=torch.float32),
             "condition": torch.tensor(rng.uniform(0, 1, (2, 2 * L, 1)), dtype=torch.float32)}
    out = step(batch, 0, return_grads=True)
    assert np.isfinite(float(out["loss"]))
    assert max(float(g.abs().max()) for g in out["grads"].values()) > 0
    moved = {n for n, p in cn.named_parameters() if not torch.equal(p, cn_before[n])}
    assert moved and moved <= {n for n, t in trainable_mask(cn).items() if t}
    assert "time_embed.mlp.0.weight" not in moved
    assert all(torch.equal(v, base_before[k]) for k, v in base.state_dict().items())
