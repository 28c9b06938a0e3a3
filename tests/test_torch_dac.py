"""The port's DAC (``ezaudio_tpu_torch/codecs/dac.py``) on the CPU against
the reference golden ``tests/fixtures/dac_tiny.npz`` (descript's state dict
with ``weight_g``/``weight_v``, its input and outputs) and against the JAX
package's ``DAC`` at ``tests/test_dac.py``'s TINY config.

Limits, each with its reason:
  * the fixture: codes bit-equal (the L2-normalized argmax in f32 lands on
    the same codebook entries); z, latents and audio within 1e-4 and the VQ
    losses within rtol 1e-4, the golden's own limits in ``tests/test_dac.py``;
  * against JAX on the same weights: codes equal; continuous outputs within
    1e-5 (f32 convolutions summed in another order);
  * straight-through gradients against ``jax.grad``: each within 1e-4 of
    its tensor's largest entry (the backward sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.codecs.dac import DAC as JaxDAC
from ezaudio_tpu.convert.torch_to_jax import convert_dac_state_dict
from ezaudio_tpu_torch.codecs.dac import DAC
from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
from ezaudio_tpu_torch.convert.checkpoints import load_dac
from ezaudio_tpu_torch.convert.from_jax import dac_state_dict_from_jax, fold_weight_norm

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(encoder_dim=4, encoder_rates=(2, 4), latent_dim=8, decoder_dim=16,
            decoder_rates=(4, 2), n_codebooks=3, codebook_size=16, codebook_dim=4,
            sample_rate=8000)
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    d = dict(np.load(os.path.join(FIXTURES, "dac_tiny.npz")))
    sd = {k[len("sd."):]: torch.from_numpy(v) for k, v in d.items() if k.startswith("sd.")}
    return d, sd


@pytest.fixture(scope="module")
def pair(golden):
    """The JAX DAC on the golden's weights (folded) and the port's on the
    same weights carried through the weight map."""
    d, sd = golden
    params = convert_dac_state_dict({k: v.numpy() for k, v in sd.items()}, n_enc_blocks=2,
                                    n_dec_blocks=2, n_codebooks=3)
    model = DAC(**TINY)
    model.load_state_dict(dac_state_dict_from_jax(params), strict=True)
    return JaxDAC(**TINY), params, model.eval()


def _x(d):
    return d["x"].transpose(0, 2, 1)  # (B, T, 1)


@pytest.mark.parametrize("weight_norm", [True, False], ids=["live", "folded"])
def test_fixture_forward(golden, weight_norm):
    d, sd = golden
    model = DAC(**TINY, use_weight_norm=weight_norm)
    model.load_state_dict(sd if weight_norm else fold_weight_norm(sd), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(_x(d)))
    np.testing.assert_array_equal(out["codes"].numpy(), d["codes"])
    for key in ("z", "latents", "audio"):
        np.testing.assert_allclose(out[key].numpy(), d[key].transpose(0, 2, 1), atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(out["vq/commitment_loss"].item(), d["commitment"], rtol=1e-4)
    np.testing.assert_allclose(out["vq/codebook_loss"].item(), d["codebook"], rtol=1e-4)


@pytest.mark.parametrize("wrap", [True, False], ids=["state_dict", "bare"])
def test_reference_pth_loads_strictly(golden, tmp_path, wrap):
    d, sd = golden
    path = str(tmp_path / "dac.pth")
    torch.save({"state_dict": sd, "metadata": {"kwargs": {}}} if wrap else sd, path)
    x = torch.from_numpy(_x(d))
    with torch.no_grad():
        live = load_dac(DAC(**TINY, use_weight_norm=True), path)(x)
        folded = load_dac(DAC(**TINY), path)(x)
    assert sorted(live) == sorted(folded)
    np.testing.assert_array_equal(live["codes"].numpy(), d["codes"])
    np.testing.assert_array_equal(folded["codes"].numpy(), d["codes"])
    np.testing.assert_allclose(folded["audio"].numpy(), live["audio"].numpy(), atol=1e-6)
    with pytest.raises(RuntimeError, match="dac.pth"):
        load_dac(DAC(**dict(TINY, n_codebooks=2)), path)


def _jax(model, params, *args, method=None, **kw):
    return jax.device_get(model.apply({"params": params}, *[jnp.asarray(a) for a in args],
                                      method=method, **kw))


def test_forward_and_n_quantizers_match_jax(pair, golden):
    jm, params, model = pair
    x = _x(golden[0])
    for nq in (None, 1, 2):
        want = _jax(jm, params, x, n_quantizers=nq)
        with torch.no_grad():
            got = model(torch.from_numpy(x), n_quantizers=nq)
        assert got["codes"].shape[1] == (nq or 3)
        np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
        for key in ("z", "latents", "audio", "vq/commitment_loss", "vq/codebook_loss"):
            np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-5, err_msg=key)


def test_from_codes_and_partial_from_latents_match_jax(pair, golden):
    jm, params, model = pair
    x = _x(golden[0])
    want = _jax(jm, params, x)
    codes = want["codes"]
    jz = _jax(jm, params, codes, method=lambda m, c: m.quantizer.from_codes(c))
    with torch.no_grad():
        z = model.quantizer.from_codes(torch.tensor(codes))
    for g, w in zip(z, jz):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    for width in (4, 6, 8, 12):  # 1, 1 (a partial slab), 2 and 3 codebooks
        lat = want["latents"][..., :width]
        jl = _jax(jm, params, lat, method=lambda m, v: m.quantizer.from_latents(v))
        with torch.no_grad():
            got = model.quantizer.from_latents(torch.from_numpy(lat))
        assert got[2].shape[1] == width // 4
        np.testing.assert_array_equal(got[2].numpy(), jl[2])
        for g, w in zip(got[:2], jl[:2]):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_quantizer_dropout_with_injected_draws_matches_jax(pair, golden):
    """Training: every codebook runs whatever ``n_quantizers`` says, and the
    first ``int(B * 0.5)`` samples keep only their drawn count."""
    _, params, model = pair
    jm = JaxDAC(**dict(TINY, quantizer_dropout=0.5))
    model.quantizer.quantizer_dropout = 0.5
    x = np.concatenate([_x(golden[0])] * 2)  # B = 4: two samples dropped
    drop = np.array([1, 2, 3, 1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", lambda key, shape, lo, hi, dtype=None: jnp.asarray(drop))
        want = _jax(jm, params, x, n_quantizers=1, train=True,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(x), n_quantizers=1, train=True,
                        draws=torch.from_numpy(drop))
            plain = model(torch.from_numpy(x), train=True, draws=torch.tensor([3, 3, 3, 3]))
    finally:
        model.quantizer.quantizer_dropout = 0.0
    assert got["codes"].shape[1] == 3
    for key in ("z", "audio", "vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-5, err_msg=key)
    assert not np.allclose(got["z"].numpy(), plain["z"].numpy())


def test_straight_through_gradients_match_jax(pair, golden):
    jm, params, model = pair
    x = _x(golden[0])

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.square(out["audio"])) + out["vq/commitment_loss"]

    want = dac_state_dict_from_jax(jax.device_get(jax.jit(jax.grad(jloss))(params)))
    model.zero_grad()
    out = model(torch.from_numpy(x))
    (out["audio"].square().mean() + out["vq/commitment_loss"]).backward()
    # no gradient reaches the codebooks here (their loss is not in it): 0, as JAX's
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(w).max(), 1e-8), err_msg=n)
    # the encoder learns through the straight-through estimator
    assert got["encoder.block.0.weight"].abs().max() > 0


@pytest.mark.parametrize("q_first", [True, False])
def test_facade_matches_jax(pair, q_first):
    from ezaudio_tpu.codecs.facade import AutoencoderFacade as JaxFacade

    jm, params, model = pair
    jf, tf = JaxFacade(jm, params, quantization_first=q_first, model_type="dac"), \
        AutoencoderFacade(model, quantization_first=q_first, model_type="dac")
    assert (tf.latent_channels, tf.downsampling_ratio) == (8, 8)
    wav = (0.3 * np.random.default_rng(0).standard_normal((1, 64 * 8, 1))).astype(np.float32)
    z, jz = tf.encode(wav), np.asarray(jf.encode(wav))
    np.testing.assert_allclose(z.numpy(), jz, atol=1e-5)
    np.testing.assert_allclose(tf.decode(z).numpy(), np.asarray(jf.decode(jz)), atol=1e-5)
    # chunked: 64 frames in chunks of 24 with overlap 8
    zc = tf.encode_audio(wav, chunked=True, overlap=8, chunk_size=24)
    jzc = np.asarray(jf.encode_audio(wav, chunked=True, overlap=8, chunk_size=24))
    assert zc.shape == (1, 64, 8)
    np.testing.assert_allclose(zc.numpy(), jzc, atol=1e-5)
    rec = tf.decode_audio(zc, chunked=True, overlap=8, chunk_size=24)
    np.testing.assert_allclose(
        rec.numpy(), np.asarray(jf.decode_audio(jzc, chunked=True, overlap=8, chunk_size=24)),
        atol=1e-5)
