"""The port's Whisper against the JAX package's and against transformers'.

At the tiny config of ``tests/test_whisper_native.py`` (d 32, ffn 64: not
square).  Every leaf is drawn from a seed before it is carried across,
biases and LayerNorms included (ROADMAP F6: flax and transformers both
zero-initialise the biases, and a transposed bias would pass otherwise).

Tolerances: the log-mel within 2e-4 of JAX's and of transformers'
``WhisperFeatureExtractor`` (f32 FFTs and filterbank sums in other orders,
after a log10); the encoder output within 1e-4 and the logits within 5e-4
(absolute; LayerNorm-scaled outputs of order 1); greedy ids equal.
"""

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.audio.signal import AudioSignal
from ezaudio_tpu_torch.convert.from_jax import whisper_state_dict_from_jax
from ezaudio_tpu_torch.models.whisper import (WhisperConfig, WhisperForConditionalGeneration,
                                              WhisperTranscriber, greedy_decode,
                                              whisper_log_mel, whisper_state_dict)

transformers = pytest.importorskip("transformers")

SR = 16000
ENC_TOL, LOGIT_TOL, MEL_TOL = 1e-4, 5e-4, 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_config():
    from transformers import WhisperConfig as HF

    return HF(vocab_size=64, num_mel_bins=80, d_model=32, encoder_layers=2, decoder_layers=2,
              encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
              decoder_ffn_dim=64, max_source_positions=1500, max_target_positions=64,
              pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
              dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


CFG = WhisperConfig.from_hf_config(_hf_config())


def _audio(seconds=2.0, seed=0, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX ``WhisperModel`` with every leaf drawn from a seed, and the
    port's model on the same weights through ``whisper_state_dict_from_jax``."""
    import jax

    from ezaudio_tpu.models.whisper import WhisperModel

    jmodel = WhisperModel(CFG)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 80, 3000), np.float32), np.zeros((1, 4), np.int32))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        # small token embeddings, so the next token is not the last one again
        scale = {"embed_tokens": 0.02, "embed_positions": 0.5}.get(name, 0.05)
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)["params"]
    model = WhisperForConditionalGeneration(CFG).eval()
    model.load_state_dict(whisper_state_dict_from_jax(params, CFG), strict=True)
    # jnp leaves: the JAX greedy loop gathers embeddings with a traced buffer
    return jmodel, jax.tree.map(jax.numpy.asarray, params), model


@pytest.fixture(scope="module")
def feats():
    return whisper_log_mel(torch.from_numpy(_audio()[None]))


def test_log_mel_matches_jax_and_the_hf_extractor():
    import jax.numpy as jnp
    from transformers import WhisperFeatureExtractor

    from ezaudio_tpu.models.whisper import whisper_log_mel as jlog_mel

    wav = _audio()
    ours = whisper_log_mel(torch.from_numpy(wav[None])).numpy()[0]
    jax_ = np.asarray(jlog_mel(jnp.asarray(wav[None])))[0]
    hf = WhisperFeatureExtractor()([wav], sampling_rate=SR, return_tensors="np").input_features[0]
    assert ours.shape == jax_.shape == hf.shape == (80, 3000)
    assert np.abs(ours - jax_).max() <= MEL_TOL
    assert np.abs(ours - hf).max() <= MEL_TOL
    long = np.tile(wav, 20)[: 35 * SR]  # 35 s: trimmed to the 30 s chunk
    assert whisper_log_mel(torch.from_numpy(long)).shape == (1, 80, 3000)


def test_encoder_and_logits_match_jax(jax_pair, feats):
    import jax.numpy as jnp

    from ezaudio_tpu.models.whisper import WhisperModel

    jmodel, params, model = jax_pair
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (1, 7))
    want_enc = np.asarray(jmodel.apply({"params": params}, jnp.asarray(feats.numpy()),
                                       method=WhisperModel.encode))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(feats.numpy()),
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        enc = model.encode(feats).numpy()
        got = model(feats, torch.from_numpy(ids)).numpy()
    assert enc.shape == want_enc.shape == (1, 1500, 32)
    assert np.abs(enc - want_enc).max() <= ENC_TOL
    assert got.shape == want.shape == (1, 7, 64)
    assert np.abs(got - want).max() <= LOGIT_TOL


@pytest.mark.parametrize("eos", [CFG.eos_token_id, 39])
def test_greedy_ids_equal_jax(jax_pair, eos):
    """The cached greedy loop gives the JAX one-scan loop's ids on a tone
    and on silence (which decode differently), every token after the first
    EOS pinned to EOS: id 39, chosen mid-sequence at these weights, stands
    in for EOS in the second case."""
    import dataclasses

    import jax.numpy as jnp

    from ezaudio_tpu.models.whisper import WhisperModel
    from ezaudio_tpu.models.whisper import greedy_decode as jgreedy

    _, params, model = jax_pair
    cfg = dataclasses.replace(CFG, eos_token_id=eos)
    model.cfg = cfg
    try:
        f = whisper_log_mel(torch.from_numpy(np.stack([_audio(), np.zeros(2 * SR, np.float32)])))
        prompt = (CFG.decoder_start_token_id,)
        want = jgreedy(WhisperModel(cfg), params, jnp.asarray(f.numpy()), prompt,
                       max_new_tokens=20)
        got, logits = greedy_decode(model, f, prompt, max_new_tokens=20, return_logits=True)
    finally:
        model.cfg = CFG
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and logits.shape == (2, 20, CFG.vocab_size)
    assert not np.array_equal(got[0], got[1])
    hits = [np.flatnonzero(row[1:] == eos) for row in got]
    assert all(h.size for h in hits) == (eos == 39)
    for row, h in zip(got, hits):
        if h.size:
            assert (row[1 + h[0]:] == eos).all() and len(set(row[1:1 + h[0]])) > 1


def test_strict_load_of_a_transformers_model(feats):
    """A transformers model with every parameter drawn from a seed loads
    strictly; encoder and logits agree with transformers' own forward."""
    from transformers import WhisperForConditionalGeneration as HFWhisper

    torch.manual_seed(0)
    hf = HFWhisper(_hf_config()).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            base = 1.0 if name.endswith("layer_norm.weight") else 0.0
            p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    sd = hf.state_dict()
    model = WhisperForConditionalGeneration(CFG).eval()
    model.load_state_dict(whisper_state_dict(sd), strict=True)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, CFG.vocab_size, (1, 9)))
    with torch.no_grad():
        want_enc = hf.model.encoder(feats).last_hidden_state
        want = hf(input_features=feats, decoder_input_ids=ids).logits
        enc, got = model.encode(feats), model(feats, ids)
    assert (enc - want_enc).abs().max() <= ENC_TOL
    assert (got - want).abs().max() <= LOGIT_TOL
    sd_no_proj = {k: v for k, v in sd.items() if k != "proj_out.weight"}
    model.load_state_dict(whisper_state_dict(sd_no_proj), strict=True)
    with pytest.raises(ValueError, match="ties"):
        whisper_state_dict(dict(sd, **{"proj_out.weight": sd["proj_out.weight"] + 1}))


def test_transcriber_and_audio_signal(jax_pair):
    """``WhisperTranscriber`` on the CPU resamples to 16 kHz and serves as
    the ``AudioSignal.get_whisper_*`` wrapper; without a device and a GPU
    it raises."""
    _, _, model = jax_pair
    tr = WhisperTranscriber(48000, cfg=CFG, weights=model.state_dict(), device="cpu")
    wav48 = _audio(sr=48000)
    feats = tr.features(wav48)
    assert feats.shape == (1, 80, 3000)
    ref = whisper_log_mel(torch.from_numpy(_audio()[None]))
    assert (feats - ref).abs().mean() < 0.25  # 48 kHz resampled, not truncated
    sig = AudioSignal(wav48[None, None], 48000)
    emb = sig.get_whisper_embeddings(tr)
    assert emb.shape == (1, 1500, 32)
    np.testing.assert_array_equal(sig.get_whisper_transcript(tr),
                                  tr.transcribe(wav48, 48000))
    assert sig.get_whisper_features(tr).shape == (1, 80, 3000)
    assert sig.get_whisper_features().shape == (1, 80, 3000)  # transformers' extractor
    ids = tr.transcribe(wav48, max_new_tokens=4)
    assert ids.shape == (1, 5) and ids.dtype == np.int32

    class Tok:
        def decode(self, row):
            return " ".join(map(str, row))

    tr.tokenizer = Tok()
    assert sig.get_whisper_transcript(tr).startswith(str(CFG.decoder_start_token_id))
    small = WhisperConfig(vocab_size=32, d_model=16, encoder_layers=1, decoder_layers=1,
                          encoder_attention_heads=2, decoder_attention_heads=2,
                          encoder_ffn_dim=32, decoder_ffn_dim=32, max_source_positions=100,
                          max_target_positions=16, decoder_start_token_id=1, eos_token_id=2)
    rnd = WhisperTranscriber(SR, cfg=small, device="cpu")
    assert rnd.features(_audio(0.5)).shape == (1, 80, 200)
    assert rnd.transcribe(_audio(0.5), max_new_tokens=3).shape == (1, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            WhisperTranscriber(SR, cfg=small)


class _StubProcessor:
    """Duck-typed WhisperProcessor: the real feature extractor, a toy decode."""

    def __init__(self):
        from transformers import WhisperFeatureExtractor

        self.feature_extractor = WhisperFeatureExtractor()

    def __call__(self, raw, sampling_rate, return_tensors):
        return self.feature_extractor(raw, sampling_rate=sampling_rate,
                                      return_tensors=return_tensors)

    def batch_decode(self, ids):
        return [" ".join(f"tok{int(i)}" for i in row) for row in ids]


class _StubModel:
    """Duck-typed generation model: fixed ids, no encoder."""

    def eval(self):
        return self

    def generate(self, inputs, **kw):
        return torch.arange(3)[None, :] + (inputs.mean(dim=(1, 2), keepdim=True)[:, 0] * 0).long() + 1

    def get_encoder(self):
        raise AssertionError("transcript path must not touch the encoder")


def test_whisper_wrapper_with_stubs():
    from ezaudio_tpu_torch.audio.whisper import WhisperWrapper, whisper_features

    tone = _audio(1.0)
    wrap = WhisperWrapper(processor=_StubProcessor(), whisper_model=_StubModel(), device="cpu")
    assert wrap.sampling_rate == SR
    assert tuple(wrap.features(tone, SR).shape) == (1, 80, 3000)
    assert wrap.transcript(tone, SR) == "tok1 tok2 tok3"
    assert AudioSignal(tone, SR).get_whisper_transcript(wrap).startswith("tok")
    f44 = whisper_features(_audio(1.0, sr=48000), 48000)
    assert np.abs(f44.numpy() - whisper_features(tone, SR).numpy()).mean() < 0.25
    with pytest.raises(ValueError, match="local"):
        WhisperWrapper(device="cpu")
