"""Port modules against their JAX twins on carried weights, and against
the committed reference-torch goldens.

Weights go JAX -> port through ``ezaudio_tpu_torch/convert/from_jax.py``;
inputs come from a seeded numpy RNG.  Tolerances are stated per test:
f32 on both sides, ``jax_default_matmul_precision='highest'``
(tests/conftest.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.convert.from_jax import (fold_weight_norm,
                                                maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax,
                                                vae_state_dict_from_jax)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test (xdist runs six workers); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree, rng=None):
    """device_get a param tree; with ``rng``, push all-zero leaves off zero
    so zero-initialized heads (AdaLN, cross-attn proj) are exercised."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        if rng is not None and not np.any(a):
            a = (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree.map(leaf, jax.device_get(tree))


def seeded_params(module, rng, *args):
    """``module``'s parameters drawn from ``rng`` by shape alone
    (``tests/test_torch_controlnet.py::_seeded_init``; flax's own init runs
    the model op by op), every leaf non-zero (ROADMAP F6)."""
    from tests.test_torch_controlnet import _seeded_init

    return _seeded_init(rng)(module, {"params": jax.random.PRNGKey(0),
                                      "mask": jax.random.PRNGKey(1)}, *args)


class TestPrimitives:
    def test_norms_rope_timestep(self, rng):
        from ezaudio_tpu.ops.embeddings import timestep_embedding as jax_te
        from ezaudio_tpu.ops.rope import apply_rope as jax_rope, rope_tables as jax_tables
        from ezaudio_tpu_torch.ops.embeddings import timestep_embedding
        from ezaudio_tpu_torch.ops.norms import LayerNorm
        from ezaudio_tpu_torch.ops.rope import apply_rope, rope_tables

        x = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
        cos, sin = rope_tables(10, 16)
        jc, js = jax_tables(10, 16)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(
            apply_rope(torch.from_numpy(x), cos, sin).numpy(),
            np.asarray(jax_rope(jnp.asarray(x), jc, js)), atol=1e-5)
        t = np.array([0, 10, 999], np.int64)
        np.testing.assert_allclose(
            timestep_embedding(torch.from_numpy(t), 256).numpy(),
            np.asarray(jax_te(jnp.asarray(t), 256)), atol=1e-4)
        ln = LayerNorm(16)
        mean, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
        np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                                   (x - mean) / np.sqrt(var + 1e-5), atol=1e-5)

    def test_rope_skip_prefix_and_vae_sample(self, rng):
        from ezaudio_tpu.codecs.oobleck import vae_sample as jax_vae_sample
        from ezaudio_tpu.ops.rope import apply_rope_skip_prefix as jax_skip
        from ezaudio_tpu.ops.rope import rope_tables as jax_tables
        from ezaudio_tpu_torch.codecs.oobleck import vae_sample
        from ezaudio_tpu_torch.ops.rope import apply_rope_skip_prefix, rope_tables

        x = rng.standard_normal((1, 2, 12, 8)).astype(np.float32)
        cos, sin = rope_tables(12, 8)
        jc, js = jax_tables(12, 8)
        np.testing.assert_allclose(
            apply_rope_skip_prefix(torch.from_numpy(x), cos, sin, 3).numpy(),
            np.asarray(jax_skip(jnp.asarray(x), jc, js, 3)), atol=1e-5)
        ms = rng.standard_normal((2, 5, 8)).astype(np.float32)
        np.testing.assert_array_equal(
            vae_sample(torch.from_numpy(ms), sample=False).numpy(),
            np.asarray(jax_vae_sample(None, jnp.asarray(ms), sample=False)))
        gen = torch.Generator().manual_seed(0)
        got = vae_sample(torch.from_numpy(ms), generator=gen).numpy()
        eps = torch.randn((2, 5, 4), generator=torch.Generator().manual_seed(0)).numpy()
        want = ms[..., :4] + (np.log1p(np.exp(ms[..., 4:])) + 1e-4) * eps
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestT5:
    def test_matches_jax_on_carried_weights(self, rng):
        """T5 encoder, 2 layers: atol 1e-5."""
        from ezaudio_tpu.text.t5 import T5Encoder as JaxT5
        from ezaudio_tpu_torch.text.t5 import T5Encoder, T5EncoderConfig
        from tests.tiny_config import TINY_T5

        jmodel = JaxT5(TINY_T5)
        ids = rng.integers(2, TINY_T5.vocab_size, (2, 12)).astype(np.int32)
        mask = np.ones((2, 12), bool)
        mask[0, 7:] = False
        params = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                               jnp.asarray(mask))["params"])
        want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))

        model = T5Encoder(T5EncoderConfig(**dataclasses.asdict(TINY_T5))).eval()
        model.load_state_dict(t5_state_dict_from_jax(params, TINY_T5.num_layers))
        with torch.no_grad():
            got = model(torch.from_numpy(ids), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


class TestMaskDiT:
    @pytest.fixture(scope="class")
    def pair(self):
        from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
        from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
        from tests.test_dit import TINY_MODEL

        jmodel = jax_maskdit(TINY_MODEL)
        params = seeded_params(jmodel, np.random.default_rng(7), jnp.zeros((1, 32, 8)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 24)))
        model = maskdit_from_config(TINY_MODEL).eval()
        model.load_state_dict(maskdit_state_dict_from_jax(params["params"], TINY_MODEL))
        return jmodel, params, model

    @pytest.mark.parametrize("editing", [False, True])
    def test_matches_jax_on_carried_weights(self, rng, pair, editing):
        """Generation and mae_mask_infer editing forwards: atol 1e-4."""
        jmodel, params, model = pair
        x = rng.standard_normal((2, 32, 8)).astype(np.float32)
        ctx = rng.standard_normal((2, 5, 24)).astype(np.float32)
        cmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
        t = np.array([10, 500])
        kw_j, kw_t = {}, {}
        if editing:
            gt = rng.standard_normal((2, 32, 8)).astype(np.float32)
            gmask = np.zeros((2, 32, 1), bool)
            gmask[:, 8:16] = True
            kw_j = dict(gt=jnp.asarray(gt), mae_mask_infer=jnp.asarray(gmask))
            kw_t = dict(gt=torch.from_numpy(gt), mae_mask_infer=torch.from_numpy(gmask))
        want, _ = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx), context_mask=jnp.asarray(cmask),
                                        **kw_j)
        with torch.no_grad():
            got, _ = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                           context_mask=torch.from_numpy(cmask), **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    @pytest.mark.parametrize("key", ["out_gen", "out_edit"])
    def test_matches_reference_golden(self, key):
        """The reference torch state dict loads by name; atol 2e-3 as
        tests/test_parity.py holds the JAX package to the same golden."""
        from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
        from tests.test_dit import TINY_MODEL

        d = dict(np.load(os.path.join(FIXTURES, "maskdit_tiny.npz")))
        model = maskdit_from_config(TINY_MODEL).eval()
        model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in d.items()
                               if k.startswith("sd.")})
        kw = {}
        if key == "out_edit":
            kw = dict(gt=torch.from_numpy(d["gt"]).transpose(1, 2),
                      mae_mask_infer=torch.from_numpy(d["gmask"]).transpose(1, 2))
        with torch.no_grad():
            out, _ = model(torch.from_numpy(d["x"]).transpose(1, 2), torch.from_numpy(d["t"]),
                           torch.from_numpy(d["ctx"]),
                           context_mask=torch.from_numpy(d["cmask"]), **kw)
        np.testing.assert_allclose(out.numpy(), d[key].transpose(0, 2, 1), atol=2e-3)


class TestVAEDecode:
    def test_decode_fused_matches_jax(self, rng):
        """Kernel-routed decode (plain resunit on CPU) vs JAX decode_fused
        on carried weights, non-symmetric random weights: atol 1e-4."""
        from ezaudio_tpu.codecs.oobleck import AudioVAE as JaxVAE
        from ezaudio_tpu.codecs.oobleck_fast import decode_fused_for
        from ezaudio_tpu_torch.codecs.oobleck import AudioVAE
        from ezaudio_tpu_torch.codecs.oobleck_fast import decode_fused

        jvae = JaxVAE(channels=8, latent_dim=4, c_mults=(1, 2), strides=(2, 3))
        params = jax.jit(jvae.init)({"params": jax.random.PRNGKey(0),
                                     "sample": jax.random.PRNGKey(1)},
                                    jnp.zeros((1, 24, 1)))["params"]
        params = _np_tree(params, np.random.default_rng(3))
        z = rng.standard_normal((2, 40, 4)).astype(np.float32)
        want = decode_fused_for(jvae, params, jnp.asarray(z))

        vae = AudioVAE(channels=8, latent_dim=4, c_mults=(1, 2), strides=(2, 3)).eval()
        vae.load_state_dict(vae_state_dict_from_jax(params))
        with torch.no_grad():
            got = decode_fused(vae.decoder, torch.from_numpy(z))
            module = vae.decode(torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(got.numpy(), module.numpy(), atol=1e-5)

    def test_matches_reference_golden(self):
        """Reference weight-normed state dict, folded: atol 2e-4 as
        tests/test_parity.py."""
        from ezaudio_tpu_torch.codecs.oobleck import OobleckDecoder
        from ezaudio_tpu_torch.codecs.oobleck_fast import decode_fused

        d = dict(np.load(os.path.join(FIXTURES, "vae_tiny.npz")))
        dec = OobleckDecoder(1, 8, 4, (1, 2), (2, 4)).eval()
        dec.load_state_dict(fold_weight_norm(
            {k[len("dec."):]: v for k, v in d.items() if k.startswith("dec.")}))
        z = torch.from_numpy(d["mean_scale"]).transpose(1, 2)[..., :4].contiguous()
        with torch.no_grad():
            wav = decode_fused(dec, z)
        np.testing.assert_allclose(wav.numpy(), d["wav"].transpose(0, 2, 1), atol=2e-4)


class TestDDIM:
    CFG = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
               beta_start=0.00085, beta_end=0.012, prediction_type="v_prediction",
               rescale_betas_zero_snr=True, timestep_spacing="trailing",
               clip_sample=False)

    def test_tables_match_jax(self):
        from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
        from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule

        for steps in (3, 25, 100):
            for a, b in zip(DDIMSchedule.from_config(self.CFG).step_tables(steps),
                            JaxSchedule.from_config(self.CFG).step_tables(steps)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("eta", [0.0, 1.0])
    def test_sampler_matches_jax_with_injected_noise(self, rng, eta):
        """CFG + rescale DDIM loop on a fixed linear 'model'; the JAX
        per-step fold_in noise is handed to the port (ROADMAP F1).
        atol 1e-4: at eta=1 the JAX f32 loop itself lies 6e-5 from a
        float64 run of the same loop (outputs up to 4)."""
        from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
        from ezaudio_tpu.diffusion.sampling import sample_latents as jax_sample
        from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
        from ezaudio_tpu_torch.diffusion.sampling import sample_latents

        steps, shape = 6, (2, 10, 4)
        noise = rng.standard_normal(shape).astype(np.float32)
        w = rng.standard_normal((2 * shape[0], 1, shape[2])).astype(np.float32)
        key = jax.random.PRNGKey(5)

        def jax_model(x, t):
            return 0.3 * x * jnp.asarray(w) + t / 1000.0

        def port_model(x, t):
            return 0.3 * x * torch.from_numpy(w) + t / 1000.0

        want = jax_sample(jax_model, JaxSchedule.from_config(self.CFG), jnp.asarray(noise),
                          key, steps, guidance_scale=4.0, guidance_rescale=0.75, eta=eta)
        draws = [np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                 for i in range(steps)]
        got = sample_latents(port_model, DDIMSchedule.from_config(self.CFG),
                             torch.from_numpy(noise), steps, guidance_scale=4.0,
                             guidance_rescale=0.75, eta=eta,
                             step_noise=lambda i: torch.tensor(draws[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
