"""The port's training data and CLI on the CPU: ``EACaps`` and
``ResumableIterator`` batches bit-equal to the JAX package's on one
manifest (mono, stereo picks, offline embeddings with ``cfg_prob``,
filtering, resume), ``load_wav(mono=False)`` and ``save_wav`` against the
JAX package's, and ``train_cli.main(["--device", "cpu", ...])`` on the
tiny config: three steps, a restart from the step-2 checkpoint equal to
the uninterrupted run, the MAE stage, ``--remat``, ``--dtype bfloat16``
(mixed precision, and its restart), and the options that are not ported."""

import csv
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from ezaudio_tpu.data.audio_io import load_wav as jax_load_wav
from ezaudio_tpu.data.audio_io import save_wav as jax_save_wav
from ezaudio_tpu.data.dataset import EACaps as JaxEACaps
from ezaudio_tpu.data.dataset import ResumableIterator as JaxResumable
from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav
from ezaudio_tpu_torch.data.dataset import EACaps, ResumableIterator
from ezaudio_tpu_torch.text.t5 import T5EncoderConfig
from ezaudio_tpu_torch.training import train_cli
from tests.tiny_config import TINY_CONFIG, TINY_SR, TINY_T5, TINY_VAE_CONFIG

PORT_T5 = T5EncoderConfig(**dataclasses.asdict(TINY_T5))
N_CLIPS = 9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Clips of several lengths, rates and channel counts, a manifest with
    a val row, a zero-length row and a non-fine-tune row, offline
    embeddings and a training config."""
    root = tmp_path_factory.mktemp("ws")
    audio = root / "audio"
    emb = root / "emb"
    audio.mkdir()
    emb.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(N_CLIPS):
        n = int((1.5 + 0.25 * i) * TINY_SR)
        if i % 3 == 0:      # stereo PCM16
            data = (rng.uniform(-0.5, 0.5, (n, 2)) * 32767).astype(np.int16)
            wavfile.write(str(audio / f"{i}.wav"), TINY_SR, data)
        elif i % 3 == 1:    # mono f32 at twice the rate: resampled
            jax_save_wav(str(audio / f"{i}.wav"),
                         (0.3 * rng.standard_normal(2 * n)).astype(np.float32), 2 * TINY_SR)
        else:
            save_wav(str(audio / f"{i}.wav"), (0.3 * rng.standard_normal(n)).astype(np.float32),
                     TINY_SR)
        rows.append(dict(audio_path=f"{i}.wav", caption=f"sound number {i}", split="train",
                         audio_length=n / TINY_SR, absolute_index=i, fine_tune_data=True))
        np.savez(emb / f"{i}.npz", embedding=rng.standard_normal((12, 32)).astype(np.float32),
                 mask=np.arange(12) < 4 + i)
    np.savez(root / "uncond.npz", embedding=np.zeros((12, 32), np.float32),
             mask=np.arange(12) < 1)
    rows += [dict(rows[0], split="val"), dict(rows[1], audio_length=0),
             dict(rows[2], fine_tune_data=False)]
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)

    cfg = json.loads(json.dumps(TINY_CONFIG))
    cfg["model"]["depth"] = 2
    cfg["opt"] = dict(learning_rate=1e-3, warmup=1, grad_clip=1.0, snr_gamma=5.0,
                      batch_size=2, accumulation_steps=1)
    cfg["data"] = dict(train=dict(data_dir=str(audio) + "/", meta_dir=str(root / "meta.csv"),
                                  subset="train", seg_length=2, sr=TINY_SR, mono=True),
                       train_frames=80)
    with open(root / "tiny.json", "w") as f:
        json.dump(cfg, f)
    mae = json.loads(json.dumps(cfg))
    mae["model"].update(context_dim=None)
    mae["model_name"] = "EzAudio-Tiny-MAE"
    with open(root / "tiny_mae.json", "w") as f:
        json.dump(mae, f)
    return root


def _data_kw(root, **kw):
    return dict(dict(data_dir=str(root / "audio") + "/", meta_dir=str(root / "meta.csv"),
                     seg_length=2, sr=TINY_SR), **kw)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [dict(), dict(mono=False), dict(norm=False, seg_length=1.5),
                                dict(text_path="emb", uncond_path="uncond.npz", cfg_prob=0.5),
                                dict(prepare_mode=True)],
                         ids=["mono", "stereo_pick", "no_norm", "offline", "prepare"])
def test_batches_bit_equal_to_jax(workspace, kw):
    kw = {k: str(workspace / v) if k in ("text_path", "uncond_path") else v
          for k, v in kw.items()}
    port = EACaps(**_data_kw(workspace, **kw), seed=4)
    ref = JaxEACaps(**_data_kw(workspace, **kw), seed=4)
    assert len(port) == len(ref) == N_CLIPS + bool(kw.get("prepare_mode"))
    pit, rit = ResumableIterator(port, 2, seed=4), JaxResumable(ref, 2, seed=4)
    got, want = iter(pit), iter(rit)
    for _ in range(6):  # past an epoch boundary (4 or 5 batches an epoch)
        _same(next(got), next(want))
    # resumed mid-epoch: the same batches as the uninterrupted iterators
    state = pit.state_dict()
    assert state == rit.state_dict()
    again = ResumableIterator(EACaps(**_data_kw(workspace, **kw), seed=4), 2, seed=4)
    again.load_state_dict(state)
    resumed = iter(again)
    for _ in range(3):
        _same(next(resumed), next(want))


def test_unported_data_options_raise(workspace):
    """Both data options are ported now: ``use_native`` takes the native
    batch loader where its policy applies (against the JAX package in
    test_torch_native_audio.py) and falls back with an augmenter;
    ``aug_config`` (against the JAX package in test_torch_train_tools.py)."""
    from ezaudio_tpu_torch.data import native_loader

    assert EACaps(**_data_kw(workspace, use_native=True)).use_native == native_loader.available()
    aug = EACaps(**_data_kw(workspace, use_native=True, aug_config={"phase180": {"p": 1.0}}))
    assert aug.augmenter and not aug.use_native


def test_wav_io_matches_jax(workspace, tmp_path):
    for i in range(3):
        path = str(workspace / "audio" / f"{i}.wav")
        for mono in (True, False):
            want, _ = jax_load_wav(path, sr=TINY_SR, mono=mono)
            np.testing.assert_array_equal(load_wav(path, sr=TINY_SR, mono=mono), want)
        want, _ = jax_load_wav(path)
        np.testing.assert_array_equal(load_wav(path), want)
    stereo = np.random.default_rng(1).uniform(-1, 1, (2, 300)).astype(np.float32)
    for subtype in ("float", "pcm16"):
        save_wav(str(tmp_path / "a.wav"), stereo, TINY_SR, subtype)
        jax_save_wav(str(tmp_path / "b.wav"), stereo, TINY_SR, subtype)
        assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def _main(root, cfg="tiny.json", save="ckpts", steps=3, extra=(), losses=None):
    def on_step(step, metrics):
        losses[step] = metrics["loss"].item()

    return train_cli.main(
        ["--config-name", str(root / cfg), "--max-steps", str(steps), "--log-step", "1",
         "--save-every-step", "2", "--log-dir", str(root / "logs"),
         "--save-dir", str(root / save), "--random-seed", "5", "--device", "cpu", *extra],
        t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
        on_step=None if losses is None else on_step)


def test_three_steps_then_resume(workspace):
    losses = {}
    trainer = _main(workspace, losses=losses)
    assert trainer.step == 3 and sorted(losses) == [1, 2, 3]
    assert all(np.isfinite(v) for v in losses.values())
    assert trainer.model.training and all(p.requires_grad for p in trainer.model.parameters())
    ckpts = workspace / "ckpts" / "EzAudio-Tiny"
    assert sorted(os.listdir(ckpts)) == ["2", "3"]
    log = (workspace / "logs" / "EzAudio-Tiny" / "log.txt").read_text()
    assert log.count("loss") == 3
    # a restart from the step-2 checkpoint takes step 3 as the first run did
    shutil.rmtree(ckpts / "3")
    again = {}
    resumed = _main(workspace, losses=again)
    assert resumed.step == 3 and again == {3: losses[3]}
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    # at the last step already: nothing runs, nothing is written
    assert _main(workspace, losses={}).step == 3


def test_mae_stage_and_remat(workspace):
    losses = {}
    trainer = _main(workspace, cfg="tiny_mae.json", save="ckpts_mae", steps=2,
                    extra=["--remat", "dots"], losses=losses)
    assert trainer.model.model.context_embed is None
    assert trainer.model.model.use_checkpoint and trainer.model.model.remat_policy == "dots"
    plain = {}
    _main(workspace, cfg="tiny_mae.json", save="ckpts_mae_off", steps=2,
          extra=["--remat", "off"], losses=plain)
    assert losses.keys() == plain.keys() == {1, 2}
    np.testing.assert_allclose(list(losses.values()), list(plain.values()), rtol=1e-6)


@pytest.mark.parametrize("extra,match", [(["--mesh-fsdp", "2"], "fsdp=2")])
def test_unported_flags_raise(workspace, extra, match):
    """``--mesh-fsdp 2`` in a world of one process cannot build its mesh
    (``make_mesh``'s assertion, as JAX's); under torchrun with two or more
    ranks it trains (tests/test_torch_parallel.py)."""
    with pytest.raises(AssertionError, match=match):
        _main(workspace, save="unused", extra=extra)


def test_bf16_runs_mixed_precision_and_resumes(workspace):
    """``--dtype bfloat16``: T5 and the VAE in bf16, the DiT's parameters
    and AdamW's moments f32 (mixed precision); a restart from the step-2
    checkpoint takes step 3 as the first run did."""
    losses = {}
    trainer = _main(workspace, save="ckpts_bf16", extra=["--dtype", "bfloat16"], losses=losses)
    assert trainer.step == 3 and all(np.isfinite(v) for v in losses.values())
    assert trainer.step_fn.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(v["exp_avg"].dtype == torch.float32
               for v in trainer.optimizer.rule.adamw.state.values())
    shutil.rmtree(workspace / "ckpts_bf16" / "EzAudio-Tiny" / "3")
    again = {}
    _main(workspace, save="ckpts_bf16", extra=["--dtype", "bfloat16"], losses=again)
    assert again == {3: losses[3]}


def test_steps_run_with_deterministic_cudnn(workspace):
    """Every step runs with cuDNN held to its deterministic algorithms (so
    a restart retakes the steps exactly on the card too); the setting is
    put back when training returns."""
    seen = []
    before = torch.backends.cudnn.deterministic
    train_cli.main(
        ["--config-name", str(workspace / "tiny.json"), "--max-steps", "1",
         "--log-dir", str(workspace / "logs"), "--save-dir", str(workspace / "ckpts_det"),
         "--device", "cpu"], t5_config=PORT_T5, vae_config=TINY_VAE_CONFIG,
        on_step=lambda step, m: seen.append(torch.backends.cudnn.deterministic))
    assert seen == [True] and torch.backends.cudnn.deterministic == before


def test_config_needs_opt_and_data():
    with pytest.raises(ValueError, match="opt"):
        train_cli.load_training_config("s3_l")


def test_default_directories_stay_under_the_working_directory(tmp_path, monkeypatch):
    """Run with its defaults, the CLI writes its logs and checkpoints, and
    looks for a checkpoint to resume from, under the current directory."""
    monkeypatch.chdir(tmp_path)
    args = train_cli.parse_args(["--config-name", "unused.json"])
    for d in (args.log_dir, args.save_dir):
        assert not os.path.isabs(d)
        assert os.path.commonpath([os.path.abspath(d), str(tmp_path)]) == str(tmp_path), d
    assert os.path.abspath(args.log_dir) != os.path.abspath(args.save_dir)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("setting", [False, True])
def test_every_train_step_runs_with_deterministic_cudnn(setting, monkeypatch):
    """A step object driven directly (not through ``main``) holds cuDNN to
    its deterministic algorithms while it computes, and puts the caller's
    setting back after, also when the step raises: ``StepLoop`` (the DiT,
    ControlNet and distillation steps share its ``__call__``) and
    ``CodecTrainStep``.  The CPU has no cuDNN, so probes read the flag."""
    from ezaudio_tpu_torch.diffusion.distill import DistillStep
    from ezaudio_tpu_torch.training.codec_trainer import CodecTrainStep
    from ezaudio_tpu_torch.training.controlnet_trainer import ControlNetTrainStep
    from ezaudio_tpu_torch.training.trainer import StepLoop, TrainStep

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", setting)
    for cls in (TrainStep, ControlNetTrainStep, DistillStep):
        assert cls.__call__ is StepLoop.__call__, cls
    seen = []

    class Probe(StepLoop):
        step = 0
        params = {"p": torch.ones(1, requires_grad=True)}
        optimizer = type("Opt", (), {"update": lambda self, grads, gnorm: None})()

        def draw(self, generator, batch):
            return {}

        def loss(self, batch, draws):
            seen.append(torch.backends.cudnn.deterministic)
            return (self.params["p"] ** 2).sum()

    Probe()({"latents": torch.zeros(1)}, seed=0)
    assert seen == [True] and torch.backends.cudnn.deterministic is setting

    def reconstruct(self, audio, generator, draws):
        seen.append(torch.backends.cudnn.deterministic)
        raise _Stop

    codec_step = CodecTrainStep.__new__(CodecTrainStep)
    codec_step.step, codec_step.lambdas = 0, {}
    monkeypatch.setattr(CodecTrainStep, "reconstruct", reconstruct)
    with pytest.raises(_Stop):
        codec_step(torch.zeros(1, 8, 1), seed=0)
    assert seen == [True, True] and torch.backends.cudnn.deterministic is setting


@pytest.mark.parametrize("n_fft", [32, 512, 2048])
def test_deterministic_stft_and_reflect_pad_equal_torch(n_fft):
    """The codec step's STFT and reflection pads, written so that their
    gradients sum the same way in every run (``audio/stft.py``), are
    ``torch.stft`` (centre reflect padding) and ``F.pad(mode="reflect")``
    bit for bit, and their gradients too (float64)."""
    import torch.nn.functional as F

    from ezaudio_tpu_torch.audio.stft import hann_window, reflect_pad, stft

    x = torch.randn(2, 4800, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    win = torch.from_numpy(hann_window(n_fft)).double()
    a, b = (x.clone().requires_grad_() for _ in range(2))
    got = stft(a, n_fft, n_fft // 4)
    want = torch.stft(b, n_fft, n_fft // 4, n_fft, win, center=True, pad_mode="reflect",
                      return_complex=True)
    assert torch.equal(got, want)
    got.abs().sum().backward()
    want.abs().sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-12, atol=1e-12)
    y = x[:, None, :37]
    for left, right in ((0, 5), (4, 3), (0, 0)):
        assert torch.equal(reflect_pad(y, left, right), F.pad(y, (left, right), mode="reflect"))
