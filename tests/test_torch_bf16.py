"""bf16 inference on the CPU: the port's ``dtype=torch.bfloat16`` against
the JAX package's ``dtype=jnp.bfloat16`` on the same carried weights and
inputs, module by module and end to end.

bf16 results are held by statistics, not bit for bit: the two sides round
the same function at different points (XLA may keep excess precision
inside a fusion; torch rounds every op), so each comparison takes the
JAX bf16 output ``want``, the JAX f32 output ``ref`` on the same inputs
and weights, and requires

  * ``max|got - want| <= 2 * max|want - ref|``: the port is no farther from
    JAX bf16 than twice bf16's own distance from f32;
  * ``corr(got, want) > MIN_CORR`` (0.999 for one module call, 0.99 end to
    end, where the rounding compounds over the sampler's steps);

and the port's output in bf16.  The plain twin of kernel 2 computes the
Pallas kernel's function, held against ``_resunit_pallas(interpret=True)``
by ``chip_smoke.bf16_agreement``'s rule (every element within two bf16
ulps of the output, at most 1e-3 of them beyond one).  The JAX draws are
injected where the port draws (ROADMAP F1).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.convert.from_jax import (maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax, vae_state_dict_from_jax)
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.test_torch_checkpoints import save_checkpoints
from tests.test_torch_controlnet import _seeded_init
from tests.tiny_config import TINY_CONFIG, TINY_T5, TINY_VAE_CONFIG

MODULE_CORR = 0.999
PIPE_CORR = 0.99
PORT_T5 = T5EncoderConfig(**dataclasses.asdict(TINY_T5))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    """f32 numpy copy of a JAX array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def assert_bf16_close(got, want, ref, min_corr):
    """The statistical limit of the module docstring."""
    got, want, ref = _np(got), _np(want), _np(ref)
    assert got.shape == want.shape == ref.shape
    d_port, d_ref = float(np.abs(got - want).max()), float(np.abs(want - ref).max())
    corr = float(np.corrcoef(got.ravel(), want.ravel())[0, 1])
    assert np.isfinite(got).all()
    assert d_ref > 0, "bf16 and f32 agree exactly: the comparison cannot tell them apart"
    assert d_port <= 2 * d_ref and corr > min_corr, (d_port, d_ref, corr)
    return d_port, d_ref, corr


def checkpoint_files(d, jez):
    """The JAX model's f32 parameters in the reference formats (the port
    loads them, then casts to bf16 once, as ``EzAudio`` does)."""
    t5 = t5_state_dict_from_jax(jax.device_get(jez.t5_params), TINY_T5.num_layers)
    hf = {"shared.weight": t5["embed_tokens.weight"]}
    hf.update({"encoder." + k: v for k, v in t5.items() if k != "embed_tokens.weight"})
    return save_checkpoints(
        d, maskdit_state_dict_from_jax(jax.device_get(jez.dit_params["params"]),
                                       TINY_CONFIG["model"]),
        vae_state_dict_from_jax(jax.device_get(jez.autoencoder.params)), hf)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX tiny EzAudio in bf16 and in f32 on the same seeded parameters
    (``_seeded_init``: every leaf non-zero), and the port in bf16 and f32
    built from those parameters written to files."""
    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio

    kw = dict(config=TINY_CONFIG, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(13)))
        j16 = JaxEzAudio(dtype=jnp.bfloat16, **kw)
        j32 = JaxEzAudio(**kw)
    j32.dit_params, j32.t5_params = j16.dit_params, j16.t5_params
    j32.autoencoder.params = j16.autoencoder.params
    paths = checkpoint_files(str(tmp_path_factory.mktemp("p")), j16)
    pkw = dict(config=TINY_CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
               device="cpu", **paths)
    return j16, j32, EzAudio(dtype=torch.bfloat16, **pkw), EzAudio(**pkw)


@contextlib.contextmanager
def jax_draws(keys, dtype=jnp.bfloat16):
    """The port's draws (``utils.randn``), in call order, replaced by
    ``jax.random.normal(key, shape, dtype)`` of ``keys``."""
    keys = list(keys)

    def randn(shape, generator, device, dtype_=torch.float32):
        draw = _np(jax.random.normal(keys.pop(0), tuple(shape), dtype))
        return torch.from_numpy(draw).to(device=device, dtype=dtype_)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(utils, "randn", randn)
        yield keys
    assert not keys, f"{len(keys)} JAX draws left over"


def ddim_keys(seed, steps, initial=True):
    """The keys JAX ``generate_audio(random_seed=seed)`` draws from: the
    initial latents, then one eta draw per DDIM step (``fold_in``)."""
    k_noise, k_steps = jax.random.split(jax.random.PRNGKey(seed))
    return ([k_noise] if initial else []) + [jax.random.fold_in(k_steps, i)
                                             for i in range(steps)]


# ---------------------------------------------------------------------------
class TestModules:
    def test_parameters_keep_f32_where_jax_computes_in_f32(self, models):
        _, _, ez, _ = models
        blk = ez.dit.model.in_blocks[0]
        assert blk.attn.to_q.weight.dtype == blk.mlp.net[2].weight.dtype == torch.bfloat16
        assert blk.adaln.scale_shift_table.dtype == torch.bfloat16
        assert blk.norm1.weight.dtype == blk.attn.norm_q.weight.dtype == torch.float32
        assert blk.attn.rotary.inv_freq.dtype == torch.float32
        att = ez.t5.block[0].layer[0].SelfAttention
        assert att.q.weight.dtype == torch.bfloat16
        assert att.relative_attention_bias.weight.dtype == torch.float32
        unit = ez.autoencoder.model.decoder.layers[1].layers[2]
        assert unit.layers[1].weight.dtype == torch.bfloat16
        assert unit.layers[0].alpha.dtype == torch.float32

    def test_t5(self, models):
        j16, j32, ez, _ = models
        texts = ["a dog barking", "", "rain on a tin roof"]
        want, _ = j16.embed_text(texts)
        ref, _ = j32.embed_text(texts)
        got, _ = ez.embed_text(texts)
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, want, ref, MODULE_CORR)

    def test_maskdit_call(self, models):
        """One MaskDiT call on bf16 latents and context, editing branch."""
        j16, j32, ez, _ = models
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((2, 50, 8)), jnp.bfloat16)
        ctx = jnp.asarray(rng.standard_normal((2, 12, 32)), jnp.bfloat16)
        cmask = np.ones((2, 12), bool)
        cmask[1, 4:] = False
        gt = jnp.asarray(rng.standard_normal((2, 50, 8)), jnp.bfloat16)
        gmask = np.zeros((2, 50, 1), bool)
        gmask[:, 10:30] = True
        t = jnp.asarray([900, 30])

        def jax_call(jez, dtype):
            out, _ = jax.jit(jez.dit.apply)(jez.dit_params, x.astype(dtype), t,
                                            ctx.astype(dtype), context_mask=jnp.asarray(cmask),
                                            gt=gt.astype(dtype),
                                            mae_mask_infer=jnp.asarray(gmask))
            return out

        with torch.no_grad():
            got, _ = ez.dit(torch.from_numpy(_np(x)).bfloat16(), torch.tensor([900, 30]),
                            torch.from_numpy(_np(ctx)).bfloat16(),
                            context_mask=torch.from_numpy(cmask),
                            gt=torch.from_numpy(_np(gt)).bfloat16(),
                            mae_mask_infer=torch.from_numpy(gmask))
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, jax_call(j16, jnp.bfloat16), jax_call(j32, jnp.float32),
                          MODULE_CORR)

    def test_vae_decode_and_encode(self, models):
        """Decode (kernel 2's twin in bf16 on the port's side) and the
        posterior mean of an encode."""
        j16, j32, ez, _ = models
        rng = np.random.default_rng(2)
        z = rng.standard_normal((1, 50, 8)).astype(np.float32)
        got = ez.autoencoder.decode(z)
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, j16.autoencoder.decode(jnp.asarray(z, jnp.bfloat16)),
                          j32.autoencoder.decode(jnp.asarray(z)), MODULE_CORR)
        audio = (0.5 * np.sin(np.arange(1600) / 7.0)
                 + 0.1 * rng.standard_normal(1600)).astype(np.float32)[None, :, None]
        got = ez.autoencoder.encode(audio, sample=False)
        assert_bf16_close(got, j16.autoencoder.encode(audio, sample=False),
                          j32.autoencoder.encode(audio, sample=False), MODULE_CORR)

    @pytest.mark.parametrize("d", [1, 3, 9])
    def test_resunit_twin_is_the_pallas_kernel_function(self, d):
        """``residual_unit_plain`` in bf16 against the Pallas kernel in
        interpret mode (C = 128, a ragged last tile) by
        ``chip_smoke.bf16_agreement`` with ``resunit_bf16_slack``; the JAX
        package's ``residual_unit_reference`` in bf16 (the old twin) fails
        that rule; in f32 the twin is the reference's function (atol 1e-5)."""
        import chip_smoke as cs
        from ezaudio_tpu.ops.pallas.resunit import _resunit_pallas, residual_unit_reference
        from ezaudio_tpu_torch.ops.kernels.resunit import residual_unit_plain

        args = cs.resunit_args("cpu", torch.Generator().manual_seed(d), 1, 4100, 128)
        b16 = [a.bfloat16() for a in args[:5]] + args[5:]
        jargs = ([jnp.asarray(_np(a), jnp.bfloat16) for a in b16[:5]]
                 + [jnp.asarray(_np(a)) for a in b16[5:]])
        want = torch.from_numpy(_np(_resunit_pallas(*jargs, d, interpret=True)))
        got = residual_unit_plain(*b16, d)
        assert got.dtype == torch.bfloat16
        slack = cs.resunit_bf16_slack(*b16, d)
        ok, err, share = cs.bf16_agreement(got, want, slack)
        assert ok, (err, share, slack)
        old = torch.from_numpy(_np(residual_unit_reference(*jargs, d)))
        assert not cs.bf16_agreement(old, want, slack)[0]
        got32 = residual_unit_plain(*args, d)
        want32 = residual_unit_reference(*(jnp.asarray(_np(a)) for a in args), d)
        np.testing.assert_allclose(got32.numpy(), _np(want32), atol=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bf16_attention_impls(self, dtype):
        """The bf16-logit einsum formulation against the JAX function run
        op by op (key mask on one row, 300 queries), by
        ``chip_smoke.attention_agreement``'s bf16 rule; the chunked form
        (a ragged last chunk) equals it bit for bit.  Under ``jit`` XLA
        keeps excess precision inside the fused softmax, another
        rounding: the end-to-end tests below hold that statistically."""
        import chip_smoke as cs
        from ezaudio_tpu.ops import attention as ja
        from ezaudio_tpu_torch.ops import attention as ta

        rng = np.random.default_rng(3)
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 4, 300, 72), (2, 4, 100, 72), (2, 4, 100, 72)))
        mask = np.ones((2, 1, 1, 100), bool)
        mask[0, ..., 23:] = False
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        with jax.disable_jit():
            want = ja.dot_product_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                            mask=jnp.asarray(mask), softmax_dtype=jnp.bfloat16)
        targs = [torch.from_numpy(a).to(td) for a in (q, k, v)]
        got = ta.dot_product_attention(*targs, mask=torch.from_numpy(mask),
                                       softmax_dtype=torch.bfloat16)
        chunked = ta.chunked_dot_product_attention(*targs, mask=torch.from_numpy(mask),
                                                   softmax_dtype=torch.bfloat16)
        assert got.dtype == td
        ok, err, share = cs.attention_agreement(got.bfloat16(), torch.from_numpy(_np(want)),
                                                torch.from_numpy(v))
        assert ok, (err, share)
        assert torch.equal(chunked, got)
        f32 = ta.dot_product_attention(*targs, mask=torch.from_numpy(mask))
        assert not torch.equal(f32, got)


# ---------------------------------------------------------------------------
PROMPTS = ["a dog barking", "rain on a tin roof"]
GEN = dict(length=1.0, guidance_scale=3.0, guidance_rescale=0.75, ddim_steps=3,
           random_seed=7)


class TestPipeline:
    @pytest.mark.parametrize("kw", [dict(),
                                    dict(sampler="dpm", layer_cache=(1, 2),
                                         guidance_interval=(100, 900), cfg_refresh=2),
                                    dict(sampler="distilled")])
    def test_generate_matches_jax_bf16(self, models, kw):
        """DDIM at eta 1 (the JAX initial and eta draws injected), DPM with
        the layer cache, band and cfg_refresh, distilled: two prompts.
        (Plain DPM runs in the int8 and attention tests below.)"""
        j16, j32, ez, _ = models
        want = j16.generate_audio(PROMPTS, **GEN, **kw)[1]
        ref = j32.generate_audio(PROMPTS, **GEN, **kw)[1]
        steps = GEN["ddim_steps"] if kw.get("sampler", "ddim") == "ddim" else 0
        with jax_draws(ddim_keys(GEN["random_seed"], steps)):
            got = ez.generate_audio(PROMPTS, **GEN, **kw)[1]
        assert_bf16_close(got, want, ref, PIPE_CORR)

    def test_fused_equals_staged(self, models):
        _, _, ez, _ = models
        staged = ez.generate_audio(PROMPTS, **GEN)[1]
        fused = ez.generate_audio(PROMPTS, fused=True, **GEN)[1]
        np.testing.assert_array_equal(fused, staged)
        keys = [k for k in ez._fused if torch.bfloat16 in k]
        assert keys, "the dtype is part of the fused program's signature"

    def test_int8_matches_jax_bf16(self, models, monkeypatch):
        """``quant='int8'`` with every linear quantized (the tiny widths sit
        below MIN_QUANT_ELEMENTS): the int8 weights come from the f32
        parameters on both sides."""
        from ezaudio_tpu.ops import quant as jq
        from ezaudio_tpu_torch.ops import quant as tq

        j16, j32, ez, _ = models
        monkeypatch.setattr(jq, "MIN_QUANT_ELEMENTS", 0)
        monkeypatch.setattr(tq, "MIN_QUANT_ELEMENTS", 0)
        kw = dict(GEN, sampler="dpm", quant="int8")
        want = j16.generate_audio(PROMPTS, **kw)[1]
        ref = j32.generate_audio(PROMPTS, **kw)[1]
        with jax_draws(ddim_keys(GEN["random_seed"], 0)):
            got = ez.generate_audio(PROMPTS, **kw)[1]
        assert_bf16_close(got, want, ref, PIPE_CORR)
        plain = ez.generate_audio(PROMPTS, **dict(kw, quant=None))[1]
        assert not np.array_equal(got, plain)

    @pytest.mark.parametrize("impl", ["bf16", "chunked_bf16"])
    def test_attn_impl_matches_jax_bf16(self, models, impl):
        j16, j32, ez, _ = models
        kw = dict(GEN, sampler="dpm", attn_impl=impl)
        want = j16.generate_audio(PROMPTS, **kw)[1]
        ref = j32.generate_audio(PROMPTS, **kw)[1]
        with jax_draws(ddim_keys(GEN["random_seed"], 0)):
            got = ez.generate_audio(PROMPTS, **kw)[1]
        assert_bf16_close(got, want, ref, PIPE_CORR)
