"""The port's energy-ControlNet slice on the CPU: ``ControlNetEmbed``,
``DiTControlNet``, the conditioners and MaskDiT's two phases against the
JAX package on carried non-zero weights and against the reference-torch
goldens; ``EzAudioControlNet.generate_audio`` against JAX end to end with
the JAX draws injected (ROADMAP F1); ``base=``, the served ControlNet
request and the arguments that are not ported."""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
from ezaudio_tpu_torch.api.ezaudio import EzAudio
from ezaudio_tpu_torch.convert.from_jax import (controlnet_state_dict_from_jax,
                                                maskdit_state_dict_from_jax,
                                                t5_state_dict_from_jax,
                                                vae_state_dict_from_jax)
from ezaudio_tpu_torch.models import conditioners as tc
from ezaudio_tpu_torch.models.hubert import HubertConfig
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from tests.tiny_config import TINY_CONFIG, TINY_SR, TINY_T5, TINY_VAE_CONFIG

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# the ControlNet and conditioner blocks of tests/test_controlnet.py's tiny
# end-to-end model: 10 s at 800 Hz, hop 8 -> 1000 condition frames, halved
# by the one stride-2 stage to the 500 latent frames
CN_CFG = dict(cond_in=1, cond_blocks=[8, 16], cond_mask=True, cond_mask_prob=0.25,
              cond_mask_ratio=[0.25, 0.5], cond_mask_span=4)
COND_CFG = dict(condition_type="energy", hop_size=8, window_size=64, padding="reflect",
                min_db=-60, norm=True)
CONFIG = dict(TINY_CONFIG, controlnet=CN_CFG, conditioner=COND_CFG)
PORT_T5 = T5EncoderConfig(**dataclasses.asdict(TINY_T5))
TINY_HUBERT = HubertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 8),
                           conv_stride=(5, 4), num_conv_pos_embeddings=8,
                           num_conv_pos_embedding_groups=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_init(rng):
    """A flax ``Module.init`` that draws every parameter from ``rng`` by
    shape alone (no forward is run): norm weights 1 + N(0, 0.1), other
    vectors N(0, 0.05), kernels U(+-1 / sqrt(fan_in)).  No leaf is zero, so the
    zero-initialized heads (the ControlNet's zero blocks and ``conv_out``,
    AdaLN) add something on both sides."""
    eager_init = nn.Module.init

    def leaf(path, s):
        name = path[-1].key
        if len(s.shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))  # torch's default, by fan_in
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        base = 1.0 if name == "weight" else 0.0
        scale = 0.1 if name == "weight" else 0.05
        return (base + scale * rng.standard_normal(s.shape)).astype(np.float32)

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(functools.partial(eager_init, self, **kw), rngs, *args)
        return jax.tree_util.tree_map_with_path(leaf, shapes)

    return init


@pytest.fixture(scope="module")
def pair():
    """JAX ``EzAudioControlNet`` and the port's on the same carried weights,
    drawn from a seed by ``_seeded_init`` while the JAX model is built
    (flax's own init runs the model eagerly, op by op: 35 s for the tiny
    EzAudio)."""
    from ezaudio_tpu.api.controlnet import EzAudioControlNet as JaxControlNet

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(11)))
        jcn = JaxControlNet(config=CONFIG, t5_config=TINY_T5, vae_config=TINY_VAE_CONFIG)
    jez = jcn.base
    assert all(np.any(a) for a in jax.tree.leaves(jcn.cn_params))

    cn = EzAudioControlNet(config=CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
                           device="cpu")
    ez = cn.base
    ez.dit.load_state_dict(maskdit_state_dict_from_jax(jez.dit_params["params"],
                                                       CONFIG["model"]))
    ez.t5.load_state_dict(t5_state_dict_from_jax(jez.t5_params, TINY_T5.num_layers))
    ez.autoencoder.model.load_state_dict(vae_state_dict_from_jax(jez.autoencoder.params))
    cn.controlnet.load_state_dict(controlnet_state_dict_from_jax(
        jcn.cn_params["params"], CONFIG["model"], CN_CFG))
    return jcn, cn


def burst_clip(seconds=2.0, sr=TINY_SR):
    """A 55 Hz tone in 0.25 s on/off bursts: an energy condition that moves."""
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * 55 * t) * (np.floor(t / 0.25) % 2 == 0)
            ).astype(np.float32)


@contextlib.contextmanager
def jax_draws(seed):
    """The port's draws (``utils.randn``) replaced by the draw JAX
    ``generate_audio(random_seed=seed)`` makes of its initial latents."""
    key = jax.random.split(jax.random.PRNGKey(seed))[0]

    def randn(shape, generator, device, dtype=torch.float32):
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape)))).to(
            device=device, dtype=dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(utils, "randn", randn)
        yield


def _inputs(rng, B=2, L=100, in_chans=17, Lc=12, ctx_dim=32):
    x = rng.standard_normal((B, L, in_chans)).astype(np.float32)
    ctx = rng.standard_normal((B, Lc, ctx_dim)).astype(np.float32)
    cmask = np.ones((B, Lc), bool)
    cmask[0, 5:] = False
    cond = rng.uniform(0, 1, (B, 2 * L, 1)).astype(np.float32)
    return x, np.array([10, 500]), ctx, cmask, cond


# ---------------------------------------------------------------------------
class TestModulesAgainstJax:
    @pytest.mark.parametrize("masked", [False, True])
    def test_controlnet_embed(self, pair, rng, masked):
        """The condition stem, mask row and pyramid on carried non-zero
        weights, with no frame and with a span of frames masked: atol 1e-5."""
        from ezaudio_tpu.models.controlnet import ControlNetEmbed as JaxEmbed

        jcn, cn = pair
        cond = rng.uniform(0, 1, (2, 200, 1)).astype(np.float32)
        mask = None
        if masked:
            mask = np.zeros((2, 200, 1), bool)
            mask[:, 40:90] = True
        jembed = JaxEmbed(in_chans=1, out_chans=64, blocks=(8, 16), cond_mask=True)
        want = jax.jit(jembed.apply)({"params": jcn.cn_params["params"]["controlnet_pre"]},
                                     jnp.asarray(cond),
                                     None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            got = cn.controlnet.controlnet_pre(
                torch.from_numpy(cond), None if mask is None else torch.from_numpy(mask))
        assert got.shape == (2, 100, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_skips(self, pair, rng):
        """``DiTControlNet`` skips (depth // 2 = 2) at conditioning scale
        0.7 on carried non-zero weights: atol 1e-5."""
        jcn, cn = pair
        x, t, ctx, cmask, cond = _inputs(rng)
        want = jax.jit(functools.partial(jcn.controlnet.apply, conditioning_scale=0.7))(
            jcn.cn_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
            context_mask=jnp.asarray(cmask), condition=jnp.asarray(cond))
        with torch.no_grad():
            got = cn.controlnet(torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(ctx), context_mask=torch.from_numpy(cmask),
                                condition=torch.from_numpy(cond), conditioning_scale=0.7)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert float(np.abs(np.asarray(w)).max()) > 0.1
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)

    def test_maskdit_two_phases_with_skips(self, pair, rng):
        """``MaskDiT(forward_model=False)`` (the 17-channel concat) and
        ``forward_backbone`` with the ControlNet's skips: concat exact,
        output atol 1e-5."""
        from ezaudio_tpu.models.maskdit import MaskDiT as JaxMaskDiT

        jcn, cn = pair
        jez, dit = jcn.base, cn.base.dit
        lat = rng.standard_normal((2, 100, 8)).astype(np.float32)
        _, t, ctx, cmask, cond = _inputs(rng)
        jkw = dict(context_mask=jnp.asarray(cmask))
        jconcat, _ = jax.jit(functools.partial(jez.dit.apply, forward_model=False))(
            jez.dit_params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), **jkw)
        jskips = jax.jit(jcn.controlnet.apply)(jcn.cn_params, jconcat, jnp.asarray(t),
                                               jnp.asarray(ctx), condition=jnp.asarray(cond),
                                               **jkw)
        want = jax.jit(functools.partial(jez.dit.apply, method=JaxMaskDiT.forward_backbone))(
            jez.dit_params, jconcat, jnp.asarray(t), jnp.asarray(ctx),
            controlnet_skips=jskips, **jkw)
        kw = dict(context_mask=torch.from_numpy(cmask))
        tt, tctx = torch.from_numpy(t), torch.from_numpy(ctx)
        with torch.no_grad():
            concat, _ = dit(torch.from_numpy(lat), tt, tctx, forward_model=False, **kw)
            skips = cn.controlnet(concat, tt, tctx, condition=torch.from_numpy(cond), **kw)
            got = dit.forward_backbone(concat, tt, tctx, controlnet_skips=skips, **kw)
            plain, _ = dit(torch.from_numpy(lat), tt, tctx, **kw)
        assert concat.shape == (2, 100, 17)
        np.testing.assert_array_equal(concat.numpy(), np.asarray(jconcat))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert float((got - plain).abs().max()) > 1e-2  # the skips reach the output

    def test_skips_and_layer_cache_do_not_combine(self, pair):
        _, cn = pair
        dit = cn.base.dit.model
        x, ctx = torch.zeros(1, 100, 17), torch.zeros(1, 12, 32)
        skips = [torch.zeros(1, 100, 64)] * 2
        with pytest.raises(ValueError, match="ControlNet"):
            dit(x, 5, ctx, controlnet_skips=skips, deep_cache=(1, torch.zeros(1, 100, 64)))


class TestAgainstReferenceGolden:
    def test_skips(self):
        """The reference torch ControlNet's state dict loads by name
        (strict); its skips at scale 0.7: atol 1e-5 (the JAX package is
        held to 2e-3; the port reads 3e-7)."""
        from ezaudio_tpu_torch.models.controlnet import controlnet_from_config
        from tests.test_controlnet import TINY_CN
        from tests.test_dit import TINY_MODEL

        d = dict(np.load(os.path.join(FIXTURES, "controlnet_tiny.npz")))
        model = controlnet_from_config(TINY_MODEL, TINY_CN).eval()
        model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in d.items()
                               if k.startswith("sd.")})
        with torch.no_grad():
            skips = model(torch.from_numpy(d["x"]).transpose(1, 2), torch.from_numpy(d["t"]),
                          torch.from_numpy(d["ctx"]), context_mask=torch.from_numpy(d["cmask"]),
                          condition=torch.from_numpy(d["cond"]).transpose(1, 2),
                          conditioning_scale=0.7)
        assert len(skips) == int(d["n_skips"])
        for i, s in enumerate(skips):
            np.testing.assert_allclose(s.numpy(), d[f"skip{i}"], atol=1e-5)

    def test_energy(self):
        d = dict(np.load(os.path.join(FIXTURES, "energy_tiny.npz")))
        got = tc.energy_condition(torch.from_numpy(d["audio"]), hop_size=240,
                                  window_size=1920, padding="reflect", min_db=-60, norm=True)
        np.testing.assert_allclose(got.numpy(), d["energy"], atol=1e-4)


class TestConditionersAgainstJax:
    @pytest.mark.parametrize("hop,window,padding", [
        (240, 1920, "reflect"),   # the energy config: chunk sums (1920 / 240 = 8)
        (8, 64, "reflect"),       # the tiny config, chunk sums
        (100, 257, "reflect"),    # cumsum difference, odd right pad
        (50, 130, "constant"),    # cumsum difference, even pad, zero padding
    ])
    def test_energy(self, rng, hop, window, padding):
        """``energy_condition`` on both ``frame_energy`` branches: atol 1e-5,
        and the 4-D latent tiling of the facade."""
        from ezaudio_tpu.models import conditioners as jc

        audio = (rng.standard_normal((2, 4801)) * np.linspace(0.01, 1, 4801)
                 ).astype(np.float32)
        kw = dict(hop_size=hop, window_size=window, padding=padding, min_db=-60, norm=True)
        want = np.asarray(jc.energy_condition(jnp.asarray(audio), **kw))
        got = tc.energy_condition(torch.from_numpy(audio), **kw).numpy()
        assert got.shape == want.shape == (2, 4801 // hop, 1)
        np.testing.assert_allclose(got, want, atol=1e-5)
        shape = (2, (4801 // hop) // 2, 3, 4)  # 2-D latents: 6 copies per latent frame
        tiled = tc.Conditioner("energy", **kw)(torch.from_numpy(audio), shape)
        want_t = np.asarray(jc.Conditioner("energy", **kw)(audio, shape))
        np.testing.assert_allclose(tiled.numpy(), want_t, atol=1e-5)

    def test_multiband_energy(self, rng):
        from ezaudio_tpu.models import conditioners as jc

        audio = rng.standard_normal((2, 6000)).astype(np.float32)
        kw = dict(hop_size=120, window_size=480, n_bands=4, control_bands=3,
                  sample_rate=16000)
        want = np.asarray(jc.multiband_energy_condition(jnp.asarray(audio), **kw))
        got = tc.multiband_energy_condition(torch.from_numpy(audio), **kw).numpy()
        assert got.shape == want.shape == (2, 50, 3)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_chroma(self, rng):
        """Inf-normalized chroma atol 1e-5; the one-hot equal wherever the
        argmax margin exceeds 1e-5."""
        from ezaudio_tpu.models import conditioners as jc

        t = np.arange(16000) / 16000
        audio = (np.sin(2 * np.pi * 440 * t)[None] + 0.5 * rng.standard_normal((2, 16000))
                 ).astype(np.float32)
        kw = dict(sample_rate=16000, n_chroma=12, winlen=2048, nfft=2048, winhop=512)
        want = np.asarray(jc.chroma_condition(jnp.asarray(audio), argmax=False, **kw))
        got = tc.chroma_condition(torch.from_numpy(audio), argmax=False, **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        hot = tc.chroma_condition(torch.from_numpy(audio), **kw).numpy()
        want_hot = np.asarray(jc.chroma_condition(jnp.asarray(audio), **kw))
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-5
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(hot[clear], want_hot[clear])
        np.testing.assert_array_equal(hot.sum(-1), 1.0)


# ---------------------------------------------------------------------------
class TestGenerateAgainstJax:
    @pytest.mark.parametrize("kw", [dict(ddim_steps=3, eta=0.0),
                                    dict(sampler="dpm", ddim_steps=3)])
    def test_generate_audio(self, pair, kw):
        """A 2 s burst clip (padded to the 10 s window), CFG 3.5, 3 steps,
        the JAX initial latents injected: waveform atol 1e-4 and corr >
        0.9999, cropped to the clip."""
        jcn, cn = pair
        clip = burst_clip()
        _, want = jcn.generate_audio("a rising tone", clip, random_seed=3, **kw)
        with jax_draws(3):
            _, got = cn.generate_audio("a rising tone", clip, random_seed=3, **kw)
        assert got.shape == want.shape == clip.shape
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.corrcoef(got, want)[0, 1] > 0.9999

    def test_conditioning_scale_moves_the_waveform(self, pair):
        """Scale 1 against scale 0 (the base model alone): apart by more
        than 100 times the 1e-4 the JAX comparison allows."""
        _, cn = pair
        kw = dict(sampler="dpm", ddim_steps=3, random_seed=3)
        _, on = cn.generate_audio("a rising tone", burst_clip(), **kw)
        _, off = cn.generate_audio("a rising tone", burst_clip(), conditioning_scale=0.0, **kw)
        assert float(np.abs(on - off).max()) > 100 * 1e-4


class TestFacade:
    def test_shared_base_equals_own_base(self, rng):
        """``base=`` shares the EzAudio (same object, same waveform as a
        ControlNet that built its own base from the same seed); the
        ControlNet's copies of the base's in-blocks are its own tensors."""
        kw = dict(config=CONFIG, t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG, device="cpu")
        own = EzAudioControlNet(**kw)
        base = EzAudio(**kw)
        shared = EzAudioControlNet(base=base)
        assert shared.base is base and shared.device == base.device
        a = shared.controlnet.in_blocks[0].attn.to_q.weight
        b = base.dit.model.in_blocks[0].attn.to_q.weight
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        run = dict(ddim_steps=2, random_seed=0)
        clip = rng.uniform(-1, 1, 1200).astype(np.float32)
        _, w_own = own.generate_audio("a tone", clip, **run)
        _, w_shared = shared.generate_audio("a tone", clip, **run)
        np.testing.assert_array_equal(w_own, w_shared)

    def test_served_request_equals_direct_call(self, pair):
        """``submit_controlnet`` through a server (DPM recipe, its steps
        overridden by the request) equals the direct call; a server without
        ``controlnet=`` refuses the submit."""
        from ezaudio_tpu_torch.serving import GenerationServer

        _, cn = pair
        clip = burst_clip()
        with GenerationServer(cn.base, controlnet=cn, max_batch_size=4, max_wait_ms=10,
                              sampler="dpm", ddim_steps=6, length=1.0) as srv:
            fc = srv.submit_controlnet("a tone", clip, seed=11, ddim_steps=3)
            fg = srv.submit("rain", seed=1)
            sr, served = fc.result(timeout=600)
            assert fg.result(timeout=600)[1].shape == (TINY_SR,)
        assert srv.stats["controlnet_requests"] == 1 and srv.stats["requests"] == 2
        _, direct = cn.generate_audio("a tone", clip, sampler="dpm", ddim_steps=3,
                                      random_seed=11)
        assert sr == TINY_SR and served.shape == clip.shape
        np.testing.assert_array_equal(served, direct)
        with GenerationServer(cn.base, max_batch_size=1) as srv:
            with pytest.raises(ValueError, match="controlnet="):
                srv.submit_controlnet("x", clip)
        assert srv.stats["controlnet_requests"] == 0

    def test_unported_arguments_raise(self, pair, tmp_path):
        """``controlnet_path`` loads (the pair's ControlNet written as the
        reference's ``{"model": state_dict}``: equal weights and waveform,
        a missing key raises naming it); ``Conditioner('vc')`` builds (with
        a warning, without weights) and runs, and a ControlNet with a ``vc``
        conditioner builds it on its own device; training masking and an
        unknown sampler raise."""
        _, cn = pair
        sd = cn.controlnet.state_dict()
        path = str(tmp_path / "cn.pt")
        torch.save({"model": sd}, path)
        loaded = EzAudioControlNet(base=cn.base, controlnet_path=path, seed=9)
        for k, v in loaded.controlnet.state_dict().items():
            assert torch.equal(v, sd[k]), k
        kw = dict(sampler="dpm", ddim_steps=2, random_seed=3)
        np.testing.assert_array_equal(loaded.generate_audio("x", burst_clip(), **kw)[1],
                                      cn.generate_audio("x", burst_clip(), **kw)[1])
        torch.save({"model": {k: v for k, v in sd.items() if k != "controlnet_pre.conv_out.bias"}},
                   path)
        with pytest.raises(RuntimeError, match="controlnet_pre.conv_out.bias"):
            EzAudioControlNet(base=cn.base, controlnet_path=path)
        with pytest.warns(UserWarning, match="WITHOUT weights"):  # builds, seeded
            vc = tc.Conditioner("vc", sr=TINY_SR, hubert_config=TINY_HUBERT, device="cpu")
        feats = vc(burst_clip(0.5)[None])  # 400 samples -> 8 080 at 16 kHz, padded
        assert feats.shape == (1, 402, TINY_HUBERT.hidden_size) and torch.isfinite(feats).all()
        vc_cfg = dict(CONFIG, conditioner=dict(condition_type="vc", sr=TINY_SR,
                                               hubert_config=TINY_HUBERT))
        with pytest.warns(UserWarning, match="WITHOUT weights"):
            vc_cn = EzAudioControlNet(config=vc_cfg, t5_config=PORT_T5,
                                      vae_config=TINY_VAE_CONFIG, device="cpu")
        assert vc_cn.conditioner.fn.device == vc_cn.device == torch.device("cpu")
        with pytest.raises(ValueError, match="mask_draws"):  # training masks from draws
            cn.controlnet.controlnet_pre(torch.zeros(1, 8, 1), train=True)
        with pytest.raises(ValueError, match="sampler"):
            cn.generate_audio("x", burst_clip(0.1), sampler="distilled")

    def test_energy_config_shapes(self):
        """The packaged energy config: s3_l's model block, 12 ControlNet
        in-blocks at width 1024, the linears on int8 under ``quant``, the
        pyramid convs in float (on the meta device: no memory)."""
        from ezaudio_tpu_torch.config import MODEL_REGISTRY, get_model_config
        from ezaudio_tpu_torch.models.controlnet import controlnet_from_config
        from ezaudio_tpu_torch.ops.quant import QuantLinear

        cfg = get_model_config("energy")
        assert cfg.model == get_model_config("s3_l").model
        assert MODEL_REGISTRY["energy"]["config"].endswith("energy-l.json")
        with torch.device("meta"):
            model = controlnet_from_config(cfg.model.to_dict(), cfg.controlnet.to_dict())
        assert len(model.in_blocks) == len(model.controlnet_zero_blocks) == 12
        assert model.controlnet_pre.blocks[0][0].weight.shape == (65, 65, 3)
        assert model.controlnet_pre.conv_out.weight.shape == (1024, 128, 1)
        assert all(isinstance(m, QuantLinear) for m in model.controlnet_zero_blocks)
        assert isinstance(model.time_ada, QuantLinear)
        assert not any(isinstance(m, QuantLinear) for m in model.controlnet_pre.modules())
