"""bf16 on the editing, long-generation, ControlNet and serving paths, on
the CPU: the port's ``editing_audio`` and ``generate_long`` in bf16 and
``EzAudioControlNet(dtype=torch.bfloat16)`` (built from checkpoint files:
an f32 base, its in-blocks copied, both cast) against the JAX package's
``dtype=jnp.bfloat16`` on the same parameters, under the statistical
limit of ``tests/test_torch_bf16.py``; and a ``GenerationServer`` over the
bf16 model, whose served waveforms equal the direct calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
from ezaudio_tpu_torch.convert.from_jax import controlnet_state_dict_from_jax
from ezaudio_tpu_torch.serving import GenerationServer
from tests.test_torch_bf16 import (MODULE_CORR, PIPE_CORR, _np, assert_bf16_close,
                                   checkpoint_files, ddim_keys, jax_draws)
from tests.test_torch_bf16 import models as ezaudio_models  # noqa: F401  (a fixture)
from tests.test_torch_checkpoints import save_checkpoints
from tests.test_torch_controlnet import CN_CFG, CONFIG, PORT_T5, _seeded_init, burst_clip
from tests.tiny_config import TINY_T5, TINY_VAE_CONFIG


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX ControlNet in bf16 and f32 on the same seeded parameters; the
    port's bf16 ControlNet from those parameters written to files."""
    from ezaudio_tpu.api.controlnet import EzAudioControlNet as JaxControlNet

    kw = dict(config=CONFIG, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(17)))
        j16 = JaxControlNet(dtype=jnp.bfloat16, **kw)
        j32 = JaxControlNet(**kw)
    j32.cn_params = j16.cn_params
    for name in ("dit_params", "t5_params"):
        setattr(j32.base, name, getattr(j16.base, name))
    j32.base.autoencoder.params = j16.base.autoencoder.params
    d = str(tmp_path_factory.mktemp("cn"))
    paths = checkpoint_files(d, j16.base)
    paths.update(save_checkpoints(d, cn_sd=controlnet_state_dict_from_jax(
        jax.device_get(j16.cn_params["params"]), CONFIG["model"], CN_CFG)))
    cn = EzAudioControlNet(config=CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
                           device="cpu", dtype=torch.bfloat16, **paths)
    return j16, j32, cn


def test_controlnet_is_bf16(models):
    _, _, cn = models
    assert cn.dtype == cn.base.dtype == torch.bfloat16
    assert cn.controlnet.in_blocks[0].attn.to_q.weight.dtype == torch.bfloat16
    assert cn.controlnet.in_blocks[0].norm1.weight.dtype == torch.float32
    assert cn.controlnet.controlnet_pre.conv_in.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        EzAudioControlNet(base=cn.base, dtype=torch.float32)


def test_skips(models):
    """One DiTControlNet call (bf16 concat, context and condition)."""
    j16, j32, cn = models
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 100, 17)), jnp.bfloat16)
    ctx = jnp.asarray(rng.standard_normal((2, 12, 32)), jnp.bfloat16)
    cmask = np.ones((2, 12), bool)
    cmask[0, 5:] = False
    cond = jnp.asarray(rng.uniform(0, 1, (2, 200, 1)), jnp.bfloat16)
    t = jnp.asarray([10, 500])

    def jax_skips(jcn, dtype):
        return jnp.stack(jax.jit(jcn.controlnet.apply)(
            jcn.cn_params, x.astype(dtype), t, ctx.astype(dtype),
            context_mask=jnp.asarray(cmask), condition=cond.astype(dtype)))

    with torch.no_grad():
        got = torch.stack(cn.controlnet(
            torch.from_numpy(_np(x)).bfloat16(), torch.tensor([10, 500]),
            torch.from_numpy(_np(ctx)).bfloat16(), context_mask=torch.from_numpy(cmask),
            condition=torch.from_numpy(_np(cond)).bfloat16()))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, jax_skips(j16, jnp.bfloat16), jax_skips(j32, jnp.float32),
                      MODULE_CORR)


def test_generate_audio(models):
    """DPM 3 steps on a burst clip, the JAX initial latents injected."""
    j16, j32, cn = models
    kw = dict(sampler="dpm", ddim_steps=3, random_seed=3)
    want = j16.generate_audio("a rising tone", burst_clip(), **kw)[1]
    ref = j32.generate_audio("a rising tone", burst_clip(), **kw)[1]
    with jax_draws(ddim_keys(3, 0)):
        got = cn.generate_audio("a rising tone", burst_clip(), **kw)[1]
    assert_bf16_close(got, want, ref, PIPE_CORR)


def test_served_bf16_equals_direct_calls(models):
    """A server over the bf16 model: two generate requests in one batch
    (fused), an edit and a ControlNet request, each equal to its direct
    call."""
    _, _, cn = models
    ez = cn.base
    clip = burst_clip()
    with GenerationServer(ez, controlnet=cn, max_batch_size=2, max_wait_ms=200,
                          sampler="dpm", ddim_steps=3, length=1.0, fused=True) as srv:
        futs = [srv.submit("rain", seed=1), srv.submit("wind", seed=2),
                srv.submit_edit("rain", gt_file=clip, boundary=0.25, mask_start=0.5,
                                mask_length=0.5),
                srv.submit_controlnet("a rising tone", clip, seed=11)]
        outs = [f.result(timeout=600)[1] for f in futs]
    assert srv.stats["batches"] == 3
    assert any(torch.bfloat16 in k for k in ez._fused)
    solo = ez.generate_audio(["rain", "wind"], length=1.0, sampler="dpm", ddim_steps=3,
                             random_seed=1, initial_latents=torch.stack(
                                 [srv._slot_noise(s, 1.0) for s in (1, 2)]))[1]
    np.testing.assert_array_equal(np.stack(outs[:2]), solo)
    direct = cn.generate_audio("a rising tone", clip, sampler="dpm", ddim_steps=3,
                               random_seed=11)[1]
    np.testing.assert_array_equal(outs[3], direct)
    assert all(np.isfinite(o).all() for o in outs)


def test_editing_and_long_match_jax_bf16(ezaudio_models):
    """``editing_audio`` (hard paste, eta 0; the encode and initial
    draws injected) and ``generate_long`` (one generate, two edits)."""
    j16, j32, ez, _ = ezaudio_models
    clip = (0.5 * np.sin(2 * np.pi * 110 * np.arange(1600) / 800)
            + 0.1 * np.random.default_rng(6).standard_normal(1600)).astype(np.float32)
    edit = dict(boundary=0.25, mask_start=0.5, mask_length=0.5, ddim_steps=3, eta=0.0,
                random_seed=5)
    want = j16.editing_audio("a dog barking", gt_file=clip, **edit)[1]
    ref = j32.editing_audio("a dog barking", gt_file=clip, **edit)[1]
    with jax_draws([jax.random.PRNGKey(5), ddim_keys(5, 0)[0]]):
        got = ez.editing_audio("a dog barking", gt_file=clip, **edit)[1]
    assert_bf16_close(got[200:1000], want[200:1000], ref[200:1000], PIPE_CORR)
    long = dict(length=2.5, window=1.0, overlap=0.25, ddim_steps=3, eta=0.0,
                random_seed=3)
    want = j16.generate_long("footsteps", **long)[1]
    ref = j32.generate_long("footsteps", **long)[1]
    keys = [ddim_keys(3, 0)[0], jax.random.PRNGKey(4), ddim_keys(4, 0)[0],
            jax.random.PRNGKey(5), ddim_keys(5, 0)[0]]
    with jax_draws(keys):
        got = ez.generate_long("footsteps", **long)[1]
    assert_bf16_close(got, want, ref, PIPE_CORR)
