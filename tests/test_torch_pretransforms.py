"""The port's pretransforms and wavelets
(``ezaudio_tpu_torch/codecs/{pretransforms,wavelets}.py``) on the CPU
against the JAX package's: the PQMF filters equal within 1e-6 (both are
float64 numpy on the host), analysis and synthesis within 1e-5 (f32
convolutions summed in another order), the round trip's error equal to
JAX's; the wavelets of every name, which invert exactly; the gated
variants raise as JAX's do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.codecs import pretransforms as jp
from ezaudio_tpu.codecs import wavelets as jw
from ezaudio_tpu_torch.codecs import pretransforms as tp
from ezaudio_tpu_torch.codecs import wavelets as tw


@pytest.mark.parametrize("bands,taps", [(16, 124), (4, 62)])
def test_pqmf_filters_and_round_trip_match_jax(rng, bands, taps):
    np.testing.assert_allclose(tp.pqmf_filters(bands, taps, 9.0),
                               jp.pqmf_filters(bands, taps, 9.0), rtol=0, atol=1e-6)
    j, t = jp.PQMFPretransform(num_bands=bands, taps=taps), \
        tp.PQMFPretransform(num_bands=bands, taps=taps)
    np.testing.assert_allclose(t.filters.numpy(), np.asarray(j.filters), atol=1e-6)
    x = rng.standard_normal((2, 64 * bands, 1)).astype(np.float32)
    z = t.encode(torch.from_numpy(x))
    assert z.shape == (2, 64, bands) and t.downsampling_ratio == bands
    np.testing.assert_allclose(z.numpy(), np.asarray(j.encode(jnp.asarray(x))), atol=1e-5)
    y = t.decode(z)
    assert y.shape == x.shape  # the length contract: exactly L * M
    np.testing.assert_allclose(y.numpy(), np.asarray(j.decode(jnp.asarray(z.numpy()))),
                               atol=1e-5)
    # the round trip equals the JAX bank's away from the edges
    inner = slice(4 * taps, -4 * taps)
    jy = np.asarray(j.decode(j.encode(jnp.asarray(x))))
    np.testing.assert_allclose(y.numpy()[:, inner], jy[:, inner], atol=1e-5)


@pytest.mark.parametrize("name", sorted(jw._NAMED))
def test_wavelets_match_jax_and_invert(rng, name):
    lo, hi = tw.wavelet_filters(name)
    jlo, jhi = jw.wavelet_filters(name)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    x = rng.standard_normal((2, 64, 2)).astype(np.float32)
    levels = 1 if len(lo) > 8 else 2
    z = tw.WaveletEncode1d(2, levels, name)(torch.from_numpy(x))
    jz = np.asarray(jw.WaveletEncode1d(2, levels, name)(jnp.asarray(x)))
    np.testing.assert_allclose(z.numpy(), jz, atol=1e-5)
    y = tw.WaveletDecode1d(2, levels, name)(z)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jw.WaveletDecode1d(2, levels, name)(
        jnp.asarray(jz))), atol=1e-5)


def test_wavelet_pretransform_and_refusals():
    pre = tp.create_pretransform_from_config(
        {"type": "wavelet", "config": {"channels": 1, "levels": 3, "wavelet": "db2"}}, 24000)
    assert isinstance(pre, tp.WaveletPretransform)
    assert (pre.downsampling_ratio, pre.encoded_channels) == (8, 8)
    x = torch.randn(1, 64, 1, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(pre.decode(pre.encode(x)), x, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unsupported wavelet"):
        tw.wavelet_filters("sym4")
    with pytest.raises(ValueError, match="shorter than"):
        tw.WaveletEncode1d(1, 3, "db4")(torch.zeros(1, 16, 1))
    with pytest.raises(ValueError, match="too short"):
        tw.WaveletDecode1d(1, 1, "db4")(torch.zeros(1, 2, 2))
    assert tp.create_pretransform_from_config(None, 24000) is None
    assert isinstance(tp.create_pretransform_from_config(
        {"type": "pqmf", "config": {"num_bands": 4, "taps": 62}}, 24000), tp.PQMFPretransform)
    for kind in ("autoencoder", "dac_pretrained", "audiocraft_compression"):
        with pytest.raises(NotImplementedError, match="explicit model wiring"):
            tp.create_pretransform_from_config({"type": kind}, 24000)


def test_autoencoder_and_dac_pretransforms():
    from ezaudio_tpu_torch.codecs.dac import DAC

    class Facade:
        downsampling_ratio = 4

        def encode(self, x):
            return x[:, ::4] * 2.0

        def decode(self, z):
            return z.repeat_interleave(4, dim=1)

    pre = tp.AutoencoderPretransform(Facade(), scale=2.0)
    x = torch.arange(16.0).reshape(1, 16, 1)
    torch.testing.assert_close(pre.encode(x), x[:, ::4])
    torch.testing.assert_close(pre.decode(pre.encode(x)).shape, (1, 16, 1))
    torch.manual_seed(0)
    dac = DAC(encoder_dim=4, encoder_rates=(2, 4), latent_dim=8, decoder_dim=16,
              decoder_rates=(4, 2), n_codebooks=2, codebook_size=16, codebook_dim=4).eval()
    for on_decode in (True, False):
        pre = tp.PretrainedDACPretransform(dac, quantize_on_decode=on_decode)
        assert pre.downsampling_ratio == 8
        assert pre.facade.quantization_first is not on_decode
        z = pre.encode(torch.randn(1, 64, 1))
        with torch.no_grad():
            q = dac.quantizer(z)[0] if on_decode else z
            torch.testing.assert_close(pre.decode(z), dac.decode(q))


@pytest.mark.parametrize("bands", [4, 8, 16])
def test_pqmf_reconstruction_equals_jax_at_each_band_count(bands):
    """The round trip's error after the bank's group delay is the JAX
    package's at every band count: near-perfect (the limit of
    ``tests/test_pretransforms.py``) at 8 bands, not at 4 or 16, on both
    (ROADMAP F12)."""
    from chip_smoke import codec_clip, delayed_rel_rms

    sr = 2000 * bands
    x = codec_clip(sr, 1.0, seed=6)
    j, t = jp.PQMFPretransform(num_bands=bands), tp.PQMFPretransform(num_bands=bands)
    got = delayed_rel_rms(t.decode(t.encode(torch.from_numpy(x))).numpy().ravel(), x.ravel())
    want = delayed_rel_rms(np.asarray(j.decode(j.encode(jnp.asarray(x)))).ravel(), x.ravel())
    assert got == pytest.approx(want, rel=1e-3, abs=1e-5)
    assert (got < 0.05) == (bands == 8)
