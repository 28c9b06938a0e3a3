"""The port's EnCodec (``ezaudio_tpu_torch/codecs/encodec.py``) on the CPU
against the JAX package's on carried weights (every leaf drawn from a seed,
``tests/test_torch_controlnet.py::_seeded_init``), and the two layout
hazards of its weight map (ROADMAP F3):

  * flax's ``OptimizedLSTMCell`` gates into ``torch.nn.LSTM``'s order i, f,
    g, o: a map that swaps two gates fails on a non-symmetric state;
  * live weight norm on a transposed conv normalizes per INPUT channel
    (torch's ``dim=0`` on (in, out, k)): a norm per output channel fails,
    even where in == out makes the shapes agree.

Limits: codes equal; z and audio within 1e-5 of the JAX output's largest
magnitude (f32 sums in another order); gradients within 1e-4 of each
tensor's largest entry.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu.codecs.encodec import Encodec as JaxEncodec
from ezaudio_tpu_torch.codecs.encodec import Encodec
from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
from ezaudio_tpu_torch.convert.from_jax import _conv_t, encodec_state_dict_from_jax
from tests.test_torch_controlnet import _seeded_init

KW = dict(dimension=8, n_filters=4, ratios=(4, 2), n_q=3, codebook_size=16)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(3)))
        jm = JaxEncodec(**KW)
        params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1)))["params"])
    model = Encodec(**KW)
    model.load_state_dict(encodec_state_dict_from_jax(params), strict=True)
    return jm, params, model.eval()


@pytest.fixture(scope="module")
def clip():
    return (0.5 * np.random.default_rng(0).standard_normal((2, 200, 1))).astype(np.float32)


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-6), err_msg=msg)


def test_forward_encode_decode_match_jax(pair, clip):
    jm, params, model = pair
    want = jax.device_get(jm.apply({"params": params}, jnp.asarray(clip)))
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    assert got["audio"].shape == (2, 200, 1) and got["codes"].shape == (2, 3, 25)
    np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
    for key in ("audio", "z", "vq/commitment_loss", "vq/codebook_loss"):
        _close(got[key], want[key], key)
    for n_q in (1, 2):
        jc = jm.apply({"params": params}, jnp.asarray(clip), n_q,
                      method=lambda m, a, n: m.encode(a, n))
        with torch.no_grad():
            codes = model.encode(torch.from_numpy(clip), n_q)
            audio = model.decode(codes)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        _close(audio, jm.apply({"params": params}, jc, method=lambda m, c: m.decode(c)))
    with pytest.raises(ValueError, match="n_q"):
        model.encode(torch.from_numpy(clip), 4)


def test_gradients_match_jax(pair, clip):
    jm, params, model = pair

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(clip))
        return (jnp.mean(jnp.square(out["audio"])) + out["vq/commitment_loss"]
                + out["vq/codebook_loss"])

    want = encodec_state_dict_from_jax(jax.device_get(jax.jit(jax.grad(jloss))(params)))
    model.zero_grad()
    out = model(torch.from_numpy(clip))
    (out["audio"].square().mean() + out["vq/commitment_loss"]
     + out["vq/codebook_loss"]).backward()
    for n, p in model.named_parameters():
        if n.endswith("bias_ih_l0") or n.endswith("bias_ih_l1"):
            continue  # 0 in the flax cell, which has no input bias
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-4 * max(want[n].abs().max().item(), 1e-8),
                                   err_msg=n)
    assert model.quantizer.layers[0].codebook.grad.abs().max() > 0


def _swap_gates(sd, a, b):
    """Gates ``a`` and ``b`` (of i, f, g, o) exchanged in every LSTM tensor."""
    out = dict(sd)
    for k, v in sd.items():
        if ".lstm." in k:
            parts = list(v.chunk(4, dim=0))
            parts[a], parts[b] = parts[b], parts[a]
            out[k] = torch.cat(parts)
    return out


@pytest.mark.parametrize("gates", [(1, 2), (0, 3), (2, 3)], ids=["f-g", "i-o", "g-o"])
def test_a_swapped_gate_fails(pair, gates):
    """The encoder's LSTM stack alone, its skip taken off: the seeded state
    makes every gate's weights differ, so the hidden states move far beyond
    the limit when two gates trade places."""
    from ezaudio_tpu.codecs.encodec import LSTMStack as JaxLSTMStack

    jm, params, model = pair
    x = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    want = np.asarray(JaxLSTMStack(16).apply({"params": params["encoder"]["lstm"]},
                                             jnp.asarray(x))) - x
    idx = next(i for i, m in enumerate(model.encoder.model) if hasattr(m, "lstm"))
    prefix = f"encoder.model.{idx}.lstm."
    with torch.no_grad():
        _close(model.encoder.model[idx].lstm(torch.from_numpy(x))[0], want)
        wrong = torch.nn.LSTM(16, 16, 2, batch_first=True)
        wrong.load_state_dict({k[len(prefix):]: v for k, v in _swap_gates(
            encodec_state_dict_from_jax(params), *gates).items() if k.startswith(prefix)})
        h = wrong(torch.from_numpy(x))[0].numpy()
    assert np.abs(h - want).max() > 100 * TOL * np.abs(want).max()


def test_conv_transpose_weight_norm_is_per_input_channel(rng):
    """in == out == 6: a per-output-channel norm has the same shapes (the
    symmetric trap), and only the per-input one computes the JAX layer."""
    from ezaudio_tpu.ops.convs import ConvTranspose1d as JaxConvT
    from ezaudio_tpu_torch.ops.convs import ConvTranspose1d, weight_norm_weight

    jl = JaxConvT(6, 6, 4, stride=2, padding=1, weight_norm=True)
    p = {"v": rng.standard_normal((4, 6, 6)).astype(np.float32),
         "g": rng.uniform(0.5, 2.0, 6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    want = np.asarray(jl.apply({"params": p}, jnp.asarray(x)))
    sd = {}
    _conv_t(sd, "c", p)
    layer = ConvTranspose1d(6, 6, 4, stride=2, padding=1, weight_norm=True)
    layer.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        # the same g and v, normed per output channel (dim 1 of (in, out, k))
        g, v = layer.weight_g, layer.weight_v
        wrong_w = weight_norm_weight(g.reshape(1, 6, 1).transpose(0, 1),
                                     v.transpose(0, 1)).transpose(0, 1)
        wrong = torch.nn.functional.conv_transpose1d(
            torch.from_numpy(x).transpose(1, 2), wrong_w, layer.bias, 2, 1).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(wrong.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("q_first", [True, False])
def test_facade_matches_jax(pair, clip, q_first):
    from ezaudio_tpu.codecs.facade import AutoencoderFacade as JaxFacade

    jm, params, model = pair
    jf = JaxFacade(jm, params, quantization_first=q_first, model_type="encodec")
    tf = AutoencoderFacade(model, quantization_first=q_first, model_type="encodec")
    assert (tf.latent_channels, tf.downsampling_ratio) == (8, 8)
    z, jz = tf.encode(clip), np.asarray(jf.encode(clip))
    _close(z, jz)
    _close(tf.decode(z), jf.decode(jz))
