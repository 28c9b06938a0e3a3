"""The port's HuBERT tower and ``Conditioner('vc')``
(``ezaudio_tpu_torch/models/{hubert,conditioners}.py``) on the CPU: against
the JAX package on carried weights and against
``transformers.HubertModel`` on its own state dict, loaded strictly with
either weight-norm key form.  Every leaf is drawn from a seed (ROADMAP
F6), the norms included."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.models import conditioners as jcond
from ezaudio_tpu.models import hubert as jhubert
from ezaudio_tpu_torch.convert.from_jax import hubert_params_to_torch
from ezaudio_tpu_torch.models import hubert as thubert
from ezaudio_tpu_torch.models.conditioners import Conditioner
from tests.test_torch_bf16 import MODULE_CORR, assert_bf16_close

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
            conv_bias=False, feat_extract_norm="group", num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, do_stable_layer_norm=False, classifier_proj_size=8)
LARGE = dict(TINY, feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)
ATOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(kw):
    return jhubert.HubertConfig(**kw), thubert.HubertConfig(**kw)


def seeded_params(jcfg, rng):
    """JAX HubertEncoder params, every leaf drawn from ``rng`` by shape:
    kernels U(+-1/sqrt(fan_in)), norm scales 1 + N(0, 0.1), every other
    vector N(0, 0.05)."""
    shapes = jax.eval_shape(functools.partial(jhubert.HubertEncoder(jcfg).init),
                            jax.random.PRNGKey(0), jnp.zeros((1, 800)))["params"]

    def leaf(path, s):
        if len(s.shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        scale = 0.1 if path[-1].key == "scale" else 0.05
        return (base + scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=["base", "large"])
def pair(request):
    """(JAX config, JAX params, port config, port encoder on those params)
    for the post-LN group-norm variant and the stable-LN layer-norm one."""
    jcfg, cfg = configs(TINY if request.param == "base" else LARGE)
    params = seeded_params(jcfg, np.random.default_rng(0))
    model = thubert.HubertEncoder(cfg).eval()
    model.load_state_dict(hubert_params_to_torch(params, cfg), strict=True)
    return jcfg, params, cfg, model


def _apply(jcfg, params, audio, mask=None):
    fn = jax.jit(jhubert.HubertEncoder(jcfg).apply)
    args = (jnp.asarray(audio),) + (() if mask is None else (jnp.asarray(mask, bool),))
    return np.asarray(fn({"params": params}, *args))


class TestEncoderAgainstJax:
    def test_last_hidden_state(self, pair):
        jcfg, params, cfg, model = pair
        audio = np.random.default_rng(1).standard_normal((2, 800)).astype(np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(audio)).numpy()
        want = _apply(jcfg, params, audio)
        assert got.shape == want.shape == (2, 39, 32)
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_attention_mask(self, pair):
        """A padded second clip: its masked frames zeroed before the
        positional conv and masked as keys."""
        jcfg, params, cfg, model = pair
        audio = np.random.default_rng(2).standard_normal((2, 800)).astype(np.float32)
        mask = np.ones((2, 800), np.int64)
        mask[1, 500:] = 0
        with torch.no_grad():
            got = model(torch.from_numpy(audio), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, _apply(jcfg, params, audio, mask), atol=ATOL)
        with torch.no_grad():
            unmasked = model(torch.from_numpy(audio)).numpy()
        assert np.abs(got[1] - unmasked[1]).max() > 1e-3


# ---------------------------------------------------------------------------
def _hf_model(kw, seed):
    """A tiny ``transformers.HubertModel`` with every parameter moved off its
    initial value by N(0, 0.1) (F6)."""
    from transformers import HubertConfig, HubertModel

    hf = HubertConfig(**{**kw, "conv_dim": list(kw["conv_dim"]),
                         "conv_kernel": list(kw["conv_kernel"]),
                         "conv_stride": list(kw["conv_stride"])},
                      hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
                      activation_dropout=0.0, layerdrop=0.0, final_dropout=0.0)
    torch.manual_seed(seed)
    ref = HubertModel(hf).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return ref, thubert.HubertConfig.from_hf_config(hf)


def legacy_weight_norm(sd):
    """The parametrize-era weight-norm keys renamed to the legacy
    ``weight_g``/``weight_v`` form."""
    pre = "encoder.pos_conv_embed.conv."
    out = {k: v for k, v in sd.items() if "parametrizations" not in k}
    out[pre + "weight_g"] = sd[pre + "parametrizations.weight.original0"]
    out[pre + "weight_v"] = sd[pre + "parametrizations.weight.original1"]
    return out


class TestAgainstTransformers:
    @pytest.mark.parametrize("variant", ["base", "large"])
    @pytest.mark.parametrize("form", ["parametrizations", "weight_g"])
    def test_strict_load_matches_hubert_model(self, variant, form):
        """``last_hidden_state`` within 2e-4, with and without a mask, from a
        state dict in either weight-norm form (the ``final_proj`` of a
        ContentVec checkpoint and a ``hubert.`` prefix dropped)."""
        ref, cfg = _hf_model(TINY if variant == "base" else LARGE, seed=3)
        assert cfg == configs(TINY if variant == "base" else LARGE)[1]
        sd = ref.state_dict()
        assert "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd
        if form == "weight_g":
            sd = legacy_weight_norm(sd)
        sd = {"hubert." + k: v for k, v in sd.items()}
        sd["final_proj.weight"], sd["final_proj.bias"] = torch.ones(8, 32), torch.ones(8)
        model = thubert.HubertEncoder(cfg).eval()
        model.load_state_dict(thubert.hubert_state_dict_from_hf(sd), strict=True)
        rng = np.random.default_rng(4)
        audio = torch.from_numpy(rng.standard_normal((2, 800)).astype(np.float32))
        mask = torch.ones(2, 800, dtype=torch.long)
        mask[1, 500:] = 0
        with torch.no_grad():
            np.testing.assert_allclose(model(audio).numpy(),
                                       ref(audio).last_hidden_state.numpy(), atol=ATOL)
            got = model(audio, mask).numpy()
            want = ref(audio, attention_mask=mask).last_hidden_state.numpy()
        n = int(thubert.feature_vector_mask(cfg, mask, got.shape[1])[1].sum())
        np.testing.assert_allclose(got[0], want[0], atol=ATOL)
        np.testing.assert_allclose(got[1, :n], want[1, :n], atol=ATOL)

    def test_missing_key_raises_naming_it(self):
        ref, cfg = _hf_model(TINY, seed=5)
        sd = {k: v for k, v in ref.state_dict().items()
              if k != "encoder.layers.1.final_layer_norm.bias"}
        with pytest.raises(RuntimeError, match=r"encoder\.layers\.1\.final_layer_norm\.bias"):
            thubert.VoiceConversionExtractor(16000, cfg, weights=sd, device="cpu")


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def base_sd():
    """The base variant's carried weights as a transformers-format state
    dict (the port's names, the positional conv folded): what both
    packages' ``weights=`` read."""
    jcfg, cfg = configs(TINY)
    model = thubert.HubertEncoder(cfg)
    model.load_state_dict(hubert_params_to_torch(seeded_params(jcfg, np.random.default_rng(6)),
                                                 cfg))
    return model.state_dict()


class TestConditioner:
    @pytest.mark.parametrize("sr", [16000, 24000])
    def test_vc_matches_jax(self, base_sd, sr):
        """``Conditioner('vc')`` on (B, T) and on (B, C, T) (downmixed):
        resampled to 16 kHz, padded by 40 samples, the encoder."""
        jcfg, cfg = configs(TINY)
        jc = jcond.Conditioner("vc", sr=sr, hubert_config=jcfg, weights=base_sd)
        tc = Conditioner("vc", sr=sr, hubert_config=cfg, weights=base_sd, device="cpu")
        rng = np.random.default_rng(7)
        for shape in ((2, sr // 20), (2, 2, sr // 20)):
            wav = rng.standard_normal(shape).astype(np.float32)
            got, want = tc(wav).numpy(), np.asarray(jc(wav))
            # 50 ms at sr -> 800 samples at 16 kHz, + 80 of padding
            assert got.shape == want.shape == (2, 43, 32)
            np.testing.assert_allclose(got, want, atol=ATOL)

    def test_builds_warns_and_runs_without_weights(self):
        _, cfg = configs(TINY)
        with pytest.warns(UserWarning, match="WITHOUT weights"):
            cond = Conditioner("vc", sr=16000, hubert_config=cfg, device="cpu")
        out = cond(np.random.default_rng(8).standard_normal((1, 800)).astype(np.float32))
        assert out.shape == (1, 43, 32) and torch.isfinite(out).all()
        with pytest.warns(UserWarning, match="WITHOUT weights"):
            again = Conditioner("vc", sr=16000, hubert_config=cfg, device="cpu", weights=None)
        for k, v in again.fn.model.state_dict().items():  # seeded: the same weights
            assert torch.equal(v, cond.fn.model.state_dict()[k]), k

    def test_injected_extractor(self):
        cond = Conditioner("vc", extractor=lambda w: w[..., None] * 2)
        out = cond(np.ones((1, 8), np.float32), latent_shape=(1, 8, 3, 4))
        assert out.shape == (1, 8, 3, 1) and float(out.max()) == 2.0

    def test_no_silent_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the default device is usable")
        _, cfg = configs(TINY)
        with pytest.raises(RuntimeError, match="CUDA"):
            thubert.VoiceConversionExtractor(16000, cfg)
        with pytest.raises(RuntimeError, match="CUDA"), pytest.warns(UserWarning):
            Conditioner("vc", hubert_config=cfg)

    def test_bf16_matches_jax_bf16(self, base_sd):
        """bf16 extractor against the JAX bf16 one by the rule of
        ``tests/test_torch_bf16.py``; its norms stay f32."""
        jcfg, cfg = configs(TINY)
        ext = thubert.VoiceConversionExtractor(24000, cfg, weights=base_sd,
                                               dtype=torch.bfloat16, device="cpu")
        layer = ext.model.feature_extractor.conv_layers[0]
        assert layer.conv.weight.dtype == torch.bfloat16
        assert layer.layer_norm.weight.dtype == torch.float32
        j16 = jhubert.VoiceConversionExtractor(24000, jcfg, weights=base_sd, dtype=jnp.bfloat16)
        j32 = jhubert.VoiceConversionExtractor(24000, jcfg, weights=base_sd)
        wav = np.random.default_rng(9).standard_normal((2, 2400)).astype(np.float32)
        got = ext(wav)
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, j16(jnp.asarray(wav)), j32(jnp.asarray(wav)), MODULE_CORR)
