"""The port's quality metrics, reports, playback, display, manifest,
``AudioDataset`` and ``external`` seams against the JAX package's.

Tolerances: the metrics, reports, playback HTML, the manifest's bytes and
the dataset's items without spectral transforms are the same numpy code and
must be exact; the display's mel spectrogram (on the device) within 1e-5 of
its largest magnitude, and the dataset's items with a spectral transform
likewise.
"""

import base64

import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.audio import display, effects, external, playback, quality, report
from ezaudio_tpu_torch.data.audio_io import save_audio, save_wav

SR = 16000


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def speech():
    return quality.synthetic_speech(2.0, fs=SR, seed=3)


def test_synthetic_speech_equals_jax():
    from ezaudio_tpu.audio import quality as jq

    np.testing.assert_array_equal(quality.synthetic_speech(1.0, seed=2),
                                  jq.synthetic_speech(1.0, seed=2))


@pytest.mark.parametrize("metric", ["stoi", "estoi", "pesq_nb", "pesq_wb", "nsim"])
@pytest.mark.parametrize("degrade", ["mnru", "band_limit"])
def test_metrics_equal_jax(speech, metric, degrade):
    from ezaudio_tpu.audio import quality as jq

    deg = (effects.mnru(speech, 15.0, seed=1) if degrade == "mnru"
           else effects.band_limit(speech, SR, 2500.0))
    calls = {
        "stoi": lambda q: q.stoi(deg, speech, SR),
        "estoi": lambda q: q.stoi(deg, speech, SR, extended=True),
        "pesq_nb": lambda q: q.pesq(deg, speech, SR, mode="nb", _components=True),
        "pesq_wb": lambda q: q.pesq(deg, speech, SR, mode="wb"),
        "nsim": lambda q: q.visqol_nsim(deg, speech, SR),
    }
    got, want = calls[metric](quality), calls[metric](jq)
    assert got == want
    assert np.all(np.isfinite(np.asarray(list(got.values()) if isinstance(got, dict) else got)))


def test_visqol_needs_the_external_scorer():
    with pytest.raises(ImportError, match="visqol"):
        quality.visqol(np.zeros(10), np.zeros(10), SR)


def _samples():
    rng = np.random.default_rng(0)
    return {f"clip{i}": {c: (0.1 * rng.standard_normal(800)).astype(np.float32)
                         for c in ("reference", "ours", "theirs")} for i in range(2)}


def test_reports_equal_jax(tmp_path):
    from ezaudio_tpu.audio import report as jr

    audio = _samples()
    got = report.write_report(str(tmp_path / "a.html"), audio, 8000, title="t")
    want = jr.write_report(str(tmp_path / "b.html"), audio, 8000, title="t")
    assert open(got).read() == open(want).read()

    pt, jpt = (m.PreferenceTest(["ours", "theirs", "x"], list(audio), seed=4,
                                results_csv=str(tmp_path / f"{n}.csv"))
               for m, n in ((report, "p"), (jr, "j")))
    assert pt.trials == jpt.trials
    for t in (pt, jpt):
        t.record("u1", 0, "A"), t.record("u1", 1, "tie"), t.record("u2", 1, "B")
    assert pt.tally() == jpt.tally()
    audio3 = {s: dict(v, x=v["ours"]) for s, v in audio.items()}
    assert pt.render_html(audio3, 8000) == jpt.render_html(audio3, 8000)

    mu, jmu = (m.MUSHRATest(["ours", "theirs"], list(audio), seed=2) for m in (report, jr))
    assert mu.trials == jmu.trials
    assert mu.render_html(audio, 8000) == jmu.render_html(audio, 8000)
    rows = [dict(user=u, trial=str(i), sample="clip0", system=s, score=str(v))
            for u, bias in (("a", 0), ("b", 30)) for i in range(2)
            for s, v in ((report.MUSHRATest.HIDDEN_REF, 95 - bias), ("ours", 70 + i),
                         ("theirs", 40))]
    assert mu.stats([dict(r, score=float(r["score"])) for r in rows]) == \
        jmu.stats([dict(r, score=float(r["score"])) for r in rows])


def test_playback_and_display_match_jax():
    """``embed_html`` is byte-equal; the widget and ``spec_data_uri`` carry a
    PNG of the log-mel, whose mel (on the device, before the dB) is within
    1e-5 of JAX's largest value (the dB of a pure tone's empty bands
    magnifies rounding near the 1e-8 floor)."""
    from ezaudio_tpu.audio import display as jd
    from ezaudio_tpu.audio import playback as jp

    wav = (0.3 * np.sin(2 * np.pi * 440 * np.arange(SR // 2) / SR)).astype(np.float32)
    stereo = np.stack([wav, -wav])
    assert playback.embed_html(stereo, SR, display=False) == jp.embed_html(stereo, SR,
                                                                         display=False)
    got, want = (10.0 ** (db / 20.0) for db in (display._mel_db(wav, SR, device="cpu"),
                                                jd._mel_db(wav, SR)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    uri = display.spec_data_uri(wav, SR, device="cpu")
    assert base64.b64decode(uri.split(",", 1)[1])[:8] == b"\x89PNG\r\n\x1a\n"
    html = playback.widget_html(wav, SR, title="tone", display=False, device="cpu")
    jhtml = jp.widget_html(wav, SR, title="tone", display=False)
    assert html.split("data:image/png")[0] == jhtml.split("data:image/png")[0]
    assert playback.widget_html(wav, SR, plot_fn="waveplot", display=False).count("<audio") == 1
    with pytest.raises(RuntimeError, match="ffplay"):
        if playback.shutil.which("ffplay") is None:
            playback.play(wav, SR)
        raise RuntimeError("ffplay present")


def _wav_dir(root, n=5, seconds=1.0, sr=8000):
    root.mkdir()
    rng = np.random.default_rng(9)
    for i in range(n):
        t = np.arange(int(sr * seconds * (1 + 0.25 * i))) / sr
        x = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.05 * rng.standard_normal(t.size)
        save_wav(str(root / f"clip_{i}_sound.wav"), x.astype(np.float32), sr)
    (root / "notes.txt").write_text("not audio")
    return root


@pytest.mark.parametrize("loudness", [False, True])
def test_create_csv_is_byte_equal_to_jax(tmp_path, loudness):
    from ezaudio_tpu.data.manifest import create_csv as jcsv

    from ezaudio_tpu_torch.data.manifest import create_csv

    d = _wav_dir(tmp_path / "audio")
    captions = {"clip_1_sound.wav": 'a "quoted", comma caption'}
    rows = create_csv(str(d), str(tmp_path / "port.csv"), captions=captions, loudness=loudness)
    df = jcsv(str(d), str(tmp_path / "jax.csv"), captions=captions, loudness=loudness)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len(rows) == len(df) == 5
    empty = tmp_path / "empty"
    empty.mkdir()
    create_csv(str(empty), str(tmp_path / "e1.csv"))
    jcsv(str(empty), str(tmp_path / "e2.csv"))
    assert (tmp_path / "e1.csv").read_bytes() == (tmp_path / "e2.csv").read_bytes()


@pytest.mark.parametrize("case", ["folder", "csv_transform", "aligned", "spectral"])
def test_audio_dataset_items_equal_jax(tmp_path, case):
    from ezaudio_tpu.data import audio_dataset as jds
    from ezaudio_tpu.data import transforms as JT
    from ezaudio_tpu.data.manifest import create_csv as jcsv

    from ezaudio_tpu_torch.data import audio_dataset as ds
    from ezaudio_tpu_torch.data import transforms as T

    d = _wav_dir(tmp_path / "audio")
    src = str(d)
    if case != "folder":
        src = str(tmp_path / "audio" / "m.csv")
        jcsv(str(d), src)

    def build(m, tm, device=None):
        tf = {"csv_transform": lambda: tm.Compose([tm.VolumeChange(), tm.LowPass(
                  cutoff=(500.0, 2000.0))]),
              "spectral": lambda: tm.Compose([tm.TimeMask(), tm.VolumeNorm()])}.get(
                  case, lambda: None)()
        loaders = [m.AudioLoader([src], transform=tf)]
        if case == "aligned":
            loaders.append(m.AudioLoader([src, src], weights=[1, 3]))
        kw = dict(device=device) if device else {}
        return m.AudioDataset(loaders, duration=0.5, sample_rate=8000, n_examples=5,
                              aligned=case == "aligned", seed=3, **kw)

    got, want = build(ds, T, "cpu"), build(jds, JT)
    for idx in range(5):
        g, w = got[idx], want[idx]
        assert sorted(g) == sorted(w)
        for k in g:
            if k == "idx":
                continue
            assert g[k].metadata == w[k].metadata
            if case == "spectral":
                err = np.abs(g[k].audio_data - w[k].audio_data).max()
                assert err <= 1e-5 * np.abs(w[k].audio_data).max()
            else:
                np.testing.assert_array_equal(g[k].audio_data, w[k].audio_data)
    gb, wb = next(got.batches(3)), next(want.batches(3))
    assert gb["idx"] == wb["idx"] and gb["signal" if case != "aligned" else "signal_0"
                                          ].audio_data.shape[0] == 3


def test_external_seams(tmp_path):
    wav = (0.1 * np.ones(800)).astype(np.float32)
    p = str(tmp_path / "x.wav")
    save_wav(p, wav, 8000)
    if not external.ffmpeg_available():
        from ezaudio_tpu_torch.data import codec_loader

        got, sr = external.ffmpeg_load(p, sr=16000)
        assert sr == 16000 and got.shape == (1600,)
        if codec_loader.available():  # a non-wav file goes to the bridge
            save_audio(str(tmp_path / "x.flac"), wav, 8000)
            got, sr = external.ffmpeg_load(str(tmp_path / "x.flac"), sr=16000)
            assert sr == 16000 and got.shape == (1600,)
        saved = codec_loader.available
        codec_loader.available = lambda: False
        try:
            with pytest.raises(ImportError, match="ffmpeg"):
                external.ffmpeg_load(str(tmp_path / "x.mp3"))
        finally:
            codec_loader.available = saved
    with pytest.raises(ValueError, match="local"):
        external.transcribe(wav, 8000, model="openai/whisper-base", device="cpu")
