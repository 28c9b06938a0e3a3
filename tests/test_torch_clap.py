"""The port's CLAP (``ezaudio_tpu_torch/models/clap.py``,
``ezaudio_tpu_torch/audio/{stft,clap}.py``) on the CPU: the front end, both
towers, the logits and ``CLAPScorer`` against the JAX package on carried
weights, and against ``transformers.ClapModel`` on its own state dict,
loaded strictly.

Every leaf of the carried weights is drawn from a seed (ROADMAP F6): the
JAX CLAP initializes the relative-position tables to zero and the
BatchNorm to the identity, on which a wrong gather or BatchNorm axis would
still agree.  The tower is tiny (16-wide patches of 16 x 16, two Swin
stages) but takes the scorer's real input: 64 mel bins, up to 1 024 frames.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.models import clap as jmodel
from ezaudio_tpu_torch.audio import clap as tclap
from ezaudio_tpu_torch.audio import stft as tstft
from ezaudio_tpu_torch.convert.from_jax import clap_params_to_torch
from ezaudio_tpu_torch.models import clap as tmodel
from tests.test_torch_bf16 import MODULE_CORR, assert_bf16_close

# the JAX package's ``audio/__init__.py`` exports functions of these names
jclap = importlib.import_module("ezaudio_tpu.audio.clap")
jstft = importlib.import_module("ezaudio_tpu.audio.stft")

TEXT = dict(vocab_size=120, hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=48, max_position_embeddings=64, projection_dim=20)
AUDIO = dict(spec_size=256, num_mel_bins=64, patch_size=16, patch_stride=(16, 16),
             patch_embeds_hidden_size=16, window_size=4, depths=(2, 2),
             num_attention_heads=(2, 4), mlp_ratio=2.0, hidden_size=32, projection_dim=20)
JCFG = jmodel.ClapConfig(text=jmodel.ClapTextConfig(**TEXT),
                         audio=jmodel.ClapAudioConfig(**AUDIO), projection_dim=20)
CFG = tmodel.ClapConfig(text=tmodel.ClapTextConfig(**TEXT),
                        audio=tmodel.ClapAudioConfig(**AUDIO), projection_dim=20)
ATOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_clap_params(rng, cfg=JCFG):
    """JAX CLAP params with every leaf drawn from ``rng`` by shape (F6):
    kernels and tables U(+-1/sqrt(fan_in)), relative-position tables
    N(0, 0.5), norm scales 1 + N(0, 0.1), BatchNorm mean N(0, 1) and
    variance U(0.5, 1.5), logit scales log(100/7) + N(0, 0.1), every other
    vector N(0, 0.05)."""
    a = cfg.audio
    shapes = jax.eval_shape(functools.partial(
        jmodel.CLAP(cfg).init, input_features=jnp.zeros((1, 1, 32, a.num_mel_bins)),
        input_ids=jnp.ones((1, 4), jnp.int32)), jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "relative_position_bias_table":
            x = 0.5 * rng.standard_normal(s.shape)
        elif len(s.shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            x = rng.uniform(-bound, bound, s.shape)
        elif name == "bn_var":
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bn_mean":
            x = rng.standard_normal(s.shape)
        elif name in ("scale", "bn_scale"):
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name.startswith("logit_scale"):
            x = math.log(100 / 7) + 0.1 * rng.standard_normal(s.shape)
        else:
            x = 0.05 * rng.standard_normal(s.shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    """The JAX CLAP params and the port's CLAP on them (carried)."""
    params = seeded_clap_params(np.random.default_rng(0))
    model = tmodel.CLAP(CFG).eval()
    model.load_state_dict(clap_params_to_torch(params, CFG), strict=True)
    return params, model


@pytest.fixture(scope="module")
def scorers(pair):
    """JAX ``CLAPScorer`` and the port's (``device="cpu"``) on the same weights."""
    _, model = pair
    sd = model.state_dict()  # transformers names: both scorers read them
    return (jclap.CLAPScorer(cfg=JCFG, weights=sd),
            tclap.CLAPScorer(cfg=CFG, weights=sd, device="cpu"))


def clip(rng, seconds, sr):
    return (0.1 * rng.standard_normal((2, int(seconds * sr)))).astype(np.float32)


def padded_ids(rng, lengths=(10, 6, 3), pad=1):
    """(B, max) ids starting with BOS 0, each row padded with the pad id
    after its length."""
    ids = np.full((len(lengths), max(lengths)), pad, np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(3, TEXT["vocab_size"], n)
        ids[b, 0] = 0
    return ids


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
class TestFrontEnd:
    def test_window_stft_and_filterbanks_match_jax(self):
        """The hann window and both filterbanks equal; the STFT, with and
        without a window shorter than n_fft, within 1e-4 of JAX's."""
        np.testing.assert_array_equal(tstft.hann_window(400), jstft.hann_window(400))
        np.testing.assert_allclose(tstft.mel_filterbank(48000, 1024, 64, 0.0, 14000.0),
                                   jstft.mel_filterbank(48000, 1024, 64, 0.0, 14000.0),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tstft.mel_filterbank_htk(48000, 1024, 64, 50.0, 14000.0),
                                   jclap._mel_filterbank_htk(48000, 1024, 64, 50.0, 14000.0),
                                   rtol=1e-6, atol=1e-9)
        x = np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32)
        for win in (None, 300):
            got = tstft.stft(torch.from_numpy(x), 512, 128, win_length=win).numpy()
            want = np.asarray(jstft.stft(jnp.asarray(x), 512, 128, win_length=win))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-4)

    @pytest.mark.parametrize("scale", ["slaney", "htk"])
    def test_log_mel_matches_jax(self, scale):
        wav = clip(np.random.default_rng(1), 0.5, 48000)
        got = tclap.clap_log_mel(torch.from_numpy(wav), 48000, scale=scale).numpy()
        want = jclap.clap_log_mel(wav, 48000, scale=scale)
        assert got.shape == want.shape == (2, 51, 64)
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)

    @pytest.mark.parametrize("seconds,sr,padding", [
        (3.0, 48000, "repeatpad"), (3.0, 48000, "repeat"), (12.5, 16000, "repeatpad"),
        (1.0, 24000, "repeatpad")])
    def test_prepare_matches_jax(self, seconds, sr, padding):
        """Repeat-padding, a centre crop and the resampling to 48 kHz."""
        wav = clip(np.random.default_rng(2), seconds, sr)
        got = tclap.prepare_clap_audio(wav, sr, padding=padding, device="cpu").numpy()
        want = jclap.prepare_clap_audio(wav, sr, padding=padding)
        assert got.shape == want.shape == (2, 1, 1001, 64)
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)


class TestTowersAgainstJax:
    @pytest.mark.parametrize("frames", [1024, 1001])
    def test_audio_tower(self, pair, frames):
        """Framewise and pooled outputs; 1 001 frames take the bicubic time
        stretch, 1 024 do not."""
        params, model = pair
        x = np.random.default_rng(3).standard_normal((2, 1, frames, 64)).astype(np.float32)
        want = jax.jit(jmodel.ClapAudioTower(JCFG.audio).apply)(
            {"params": params["audio_tower"]}, jnp.asarray(x))
        with torch.no_grad():
            got = model.audio_model.audio_encoder(torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL)

    def test_text_tower_with_padding(self, pair):
        params, model = pair
        ids = padded_ids(np.random.default_rng(4))
        mask = (ids != 1).astype(np.int64)
        want = jax.jit(jmodel.ClapTextTower(JCFG.text).apply)(
            {"params": params["text_tower"]}, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            got = model.text_model(torch.from_numpy(ids), torch.from_numpy(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL)

    def test_embeddings_and_logits(self, pair):
        params, model = pair
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 1, 1001, 64)).astype(np.float32)
        ids = padded_ids(rng, (8, 5))
        mask = (ids != 1).astype(np.int64)
        want = jax.jit(jmodel.CLAP(JCFG).apply)(
            {"params": params}, input_features=jnp.asarray(x), input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(mask))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(mask))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=ATOL, err_msg=k)


class TestScorer:
    def test_embeddings_and_score_match_jax(self, scorers):
        """``embed_audio`` of 24 kHz clips (resampled, repeat-padded),
        ``embed_text`` with the mask from the pad id, ``score``."""
        jsc, sc = scorers
        rng = np.random.default_rng(6)
        wav, ids = clip(rng, 2.0, 24000), padded_ids(rng, (9, 4))
        np.testing.assert_allclose(_np(sc.embed_audio(wav, 24000)),
                                   np.asarray(jsc.embed_audio(wav, 24000)), atol=ATOL)
        np.testing.assert_allclose(_np(sc.embed_text(ids)), np.asarray(jsc.embed_text(ids)),
                                   atol=ATOL)
        np.testing.assert_allclose(sc.score(wav, 24000, ids), jsc.score(wav, 24000, ids),
                                   atol=ATOL)

    def test_text_needs_a_tokenizer_or_ids(self, scorers):
        jsc, sc = scorers
        with pytest.raises(RuntimeError, match="tokenizer"):
            sc.embed_text(["rain"])
        ids = padded_ids(np.random.default_rng(7), (5,))

        def tokenizer(texts):
            return ids, (ids != 1).astype(np.int64)

        tok = tclap.CLAPScorer(cfg=CFG, weights=sc.model.state_dict(), tokenizer=tokenizer,
                               device="cpu")
        np.testing.assert_array_equal(_np(tok.embed_text(["rain"])), _np(sc.embed_text(ids)))

    def test_random_init_is_seeded_and_f6_safe(self):
        """``weights=None``: the same weights at every build, with the
        BatchNorm statistics and the relative-position tables drawn."""
        a = tclap.CLAPScorer(cfg=CFG, device="cpu").model.state_dict()
        b = tclap.CLAPScorer(cfg=CFG, device="cpu").model.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        bn = "audio_model.audio_encoder.batch_norm."
        assert a[bn + "running_mean"].abs().min() > 0 and a[bn + "running_var"].min() > 0
        tables = [v for k, v in a.items() if k.endswith("relative_position_bias_table")]
        assert tables and all(t.abs().min() > 0 for t in tables)

    def test_constants_follow_the_build_device(self):
        """The gather index and the shift masks are built on the model's
        device, as its parameters are."""
        with torch.device("meta"):
            model = tmodel.CLAP(CFG)
        buffers = dict(model.named_buffers())
        assert any(k.endswith("shift_mask") for k in buffers)
        assert all(b.device.type == "meta" for b in buffers.values())

    def test_no_silent_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA"):
            tclap.CLAPScorer(cfg=CFG)

    def test_bf16_matches_jax_bf16(self, pair):
        """bf16 against JAX bf16 by the rule of ``tests/test_torch_bf16.py``;
        the norms, the BatchNorm and the logit scales stay f32.  The JAX side
        is jitted: XLA keeps the bf16 scores in f32 through the softmax, as
        the port computes them."""
        _, model = pair
        sd = model.state_dict()
        sc = tclap.CLAPScorer(cfg=CFG, weights=sd, dtype=torch.bfloat16, device="cpu")
        m = sc.model
        assert m.text_model.encoder.layer[0].attention.self.query.weight.dtype == torch.bfloat16
        assert m.audio_model.audio_encoder.batch_norm.running_var.dtype == torch.float32
        assert m.audio_model.audio_encoder.norm.weight.dtype == torch.float32
        assert m.logit_scale_a.dtype == torch.float32
        rng = np.random.default_rng(8)
        wav, ids = clip(rng, 2.0, 24000), padded_ids(rng, (9, 4))
        j16 = jclap.CLAPScorer(cfg=JCFG, weights=sd, dtype=jnp.bfloat16)
        j32 = jclap.CLAPScorer(cfg=JCFG, weights=sd)
        want_a, want_t = j16.embed_audio(wav, 24000), j16.embed_text(ids)
        ref_a, ref_t = j32.embed_audio(wav, 24000), j32.embed_text(ids)
        got_a, got_t = sc.embed_audio(wav, 24000), sc.embed_text(ids)
        assert got_a.dtype == got_t.dtype == torch.bfloat16
        assert_bf16_close(got_a, want_a, ref_a, MODULE_CORR)
        assert_bf16_close(got_t, want_t, ref_t, MODULE_CORR)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hf_clap():
    """A tiny ``transformers.ClapModel`` at the geometry above, every
    parameter and BatchNorm statistic drawn from a seed (F6)."""
    from transformers import ClapAudioConfig, ClapConfig, ClapModel, ClapTextConfig

    audio = ClapAudioConfig(**{**AUDIO, "patch_stride": list(AUDIO["patch_stride"]),
                               "depths": list(AUDIO["depths"]),
                               "num_attention_heads": list(AUDIO["num_attention_heads"])},
                            enable_fusion=False, drop_path_rate=0.0, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    text = ClapTextConfig(**TEXT, type_vocab_size=1, pad_token_id=1, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    hf = ClapConfig(text_config=text.to_dict(), audio_config=audio.to_dict(), projection_dim=20)
    torch.manual_seed(0)
    ref = ClapModel(hf).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
        bn = ref.audio_model.audio_encoder.batch_norm
        bn.running_mean.normal_(0.0, 1.0, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    return ref, tmodel.ClapConfig.from_hf_config(hf)


class TestAgainstTransformers:
    def test_strict_load_matches_clap_model(self, hf_clap):
        """A ``ClapModel`` state dict loaded strictly by ``CLAPScorer``: its
        audio and text features and logits within 2e-4."""
        ref, cfg = hf_clap
        assert (cfg.text, cfg.audio) == (CFG.text, CFG.audio)
        sc = tclap.CLAPScorer(cfg=cfg, weights=ref.state_dict(), device="cpu")
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.standard_normal((2, 1, 1001, 64)).astype(np.float32))
        ids = torch.from_numpy(padded_ids(rng, (8, 5)))
        mask = (ids != 1).long()
        with torch.no_grad():
            want = ref(input_ids=ids, attention_mask=mask, input_features=x)
            got = sc.model(x, ids, mask)
        for k in ("audio_embeds", "text_embeds", "logits_per_audio", "logits_per_text"):
            np.testing.assert_allclose(_np(got[k]), _np(getattr(want, k)), atol=ATOL,
                                       err_msg=k)

    def test_missing_or_extra_key_raises_naming_it(self, hf_clap):
        """Only ``IGNORED_HF_KEYS`` are dropped; any other missing or extra
        key raises and names it."""
        ref, cfg = hf_clap
        sd = ref.state_dict()
        ignored = [k for k in sd if tmodel._IGNORED.fullmatch(k)]
        # position and token-type ids, the BatchNorm's batch count, and one
        # relative-position index per Swin block
        assert len(ignored) == 3 + sum(cfg.audio.depths), ignored
        key = "audio_model.audio_encoder.layers.1.blocks.1.attention.self.relative_position_bias_table"
        with pytest.raises(RuntimeError, match=key.replace(".", r"\.")):
            tclap.CLAPScorer(cfg=cfg, weights={k: v for k, v in sd.items() if k != key},
                             device="cpu")
        with pytest.raises(RuntimeError, match="text_model.pooler.extra"):
            tclap.CLAPScorer(cfg=cfg, weights={**sd, "text_model.pooler.extra": sd[key]},
                             device="cpu")
