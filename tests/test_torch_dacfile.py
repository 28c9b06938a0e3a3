"""``.dac`` files and ``DACCodec`` (``ezaudio_tpu_torch/codecs/dacfile.py``)
on the CPU: the file format is the JAX package's (a file written by either
loads in the other, codes and metadata equal); compress and decompress on
the golden's weights (``tests/fixtures/dac_tiny.npz``) equal the JAX
codec's (codes equal, waveforms within 1e-5, the loudness within 1e-6 dB,
both numpy/scipy); the loudness restore; the CLI end to end on the CPU."""

import os

import numpy as np
import pytest
import torch

from ezaudio_tpu.audio.loudness import integrated_loudness as jax_loudness
from ezaudio_tpu.codecs import dacfile as jdf
from ezaudio_tpu.codecs.dac import DAC as JaxDAC
from ezaudio_tpu.convert.torch_to_jax import convert_dac_state_dict
from ezaudio_tpu_torch.audio.loudness import integrated_loudness
from ezaudio_tpu_torch.codecs import dacfile as tdf
from ezaudio_tpu_torch.codecs.dac import DAC
from tests.test_torch_dac import FIXTURES, TINY


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codecs():
    d = dict(np.load(os.path.join(FIXTURES, "dac_tiny.npz")))
    sd = {k[len("sd."):]: v for k, v in d.items() if k.startswith("sd.")}
    params = convert_dac_state_dict(sd, n_enc_blocks=2, n_dec_blocks=2, n_codebooks=3)
    model = DAC(**TINY, use_weight_norm=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jdf.DACCodec(JaxDAC(**TINY), params), tdf.DACCodec(model)


def _clip(sr, seconds, amp=0.25):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
            ).astype(np.float32)


def test_files_cross_load(tmp_path):
    codes = np.random.default_rng(0).integers(0, 1024, (1, 9, 37))
    kw = dict(chunk_length=12, original_length=18000, input_db=-21.25, channels=1,
              sample_rate=44100, padding=True)
    port = tdf.DACFile(codes=codes, **kw).save(str(tmp_path / "port.wav"))
    jax_file = jdf.DACFile(codes=codes, **kw).save(str(tmp_path / "jax"))
    assert port.endswith("port.dac") and jax_file.endswith("jax.dac")
    with open(port, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()  # the same bytes
    for loaded in (jdf.DACFile.load(port), tdf.DACFile.load(jax_file)):
        np.testing.assert_array_equal(loaded.codes, codes)
        assert loaded.codes.dtype == np.int64
        assert {k: getattr(loaded, k) for k in kw} == kw
    with open(tmp_path / "bad.dac", "wb") as f:
        np.save(f, {"codes": codes.astype(np.uint16), "metadata": dict(kw, dac_version="0.1")})
    with pytest.raises(RuntimeError, match="unsupported dac_version"):
        tdf.DACFile.load(str(tmp_path / "bad.dac"))


@pytest.mark.parametrize("normalize_db", [-16.0, None])
def test_compress_decompress_match_jax(codecs, tmp_path, normalize_db):
    jc, tc = codecs
    wav = _clip(8000, 3.0)
    assert abs(integrated_loudness(wav, 8000) - jax_loudness(wav, 8000)) <= 1e-6
    want = jc.compress(wav, 8000, win_duration=1.0, normalize_db=normalize_db)
    got = tc.compress(wav, 8000, win_duration=1.0, normalize_db=normalize_db)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.codes.shape == (1, 3, 3000) and got.chunk_length == 1000
    assert abs(got.input_db - want.input_db) <= 1e-6
    # the port's file decompressed by JAX and JAX's by the port
    f = tdf.DACFile.load(got.save(str(tmp_path / "clip")))
    rec, jrec = tc.decompress(f), jc.decompress(jdf.DACFile.load(str(tmp_path / "clip.dac")))
    assert rec.shape == wav.shape
    np.testing.assert_allclose(rec, jrec, atol=1e-5)
    if normalize_db is None:
        # the restore measures the reconstruction, not the assumed -16 dB
        assert abs(integrated_loudness(rec, 8000) - integrated_loudness(wav, 8000)) < 1.0
    with pytest.raises(ValueError, match="8000 Hz"):
        tc.compress(wav, 16000)
    with pytest.raises(ValueError, match="encoded at 16000"):
        tc.decompress(tdf.DACFile(codes=f.codes, chunk_length=1000, original_length=10,
                                  input_db=-20.0, channels=1, sample_rate=16000, padding=True))


def test_cli_encode_decode_on_the_cpu(tmp_path):
    """The 44.1 kHz model's widths on seeded weights, a 0.1 s clip in
    windows of nine frames."""
    from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav

    src = str(tmp_path / "clip.wav")
    save_wav(src, _clip(44100, 0.1), 44100)
    out = tdf.main(["encode", src, "--win-duration", "0.1", "--device", "cpu"])
    assert out == str(tmp_path / "clip.dac")
    f = tdf.DACFile.load(out)
    assert f.codes.shape == (1, 9, 9) and f.sample_rate == 44100
    wav_path = tdf.main(["decode", out, "--output", str(tmp_path / "rec.wav"),
                         "--device", "cpu"])
    rec = load_wav(wav_path)
    assert rec.shape == (4410,) and np.isfinite(rec).all()
    # the same seed, the same codes
    again = tdf.main(["encode", src, "--win-duration", "0.1", "--device", "cpu",
                      "--output", str(tmp_path / "again")])
    np.testing.assert_array_equal(tdf.DACFile.load(again).codes, f.codes)
