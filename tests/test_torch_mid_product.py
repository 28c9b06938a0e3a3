"""The mid-scale product harness plumbing of the port (``validation/mid_common.py``
and ``validation/distill_serve_mid.py``) against the JAX scripts
(``scripts/mid_common.py``, ``scripts/distill_serve_mid.py``) on the CPU.

  (i)   ``build_mid_ezaudio`` hands EzAudio the JAX script's dictionaries,
        with and without the ControlNet blocks;
  (ii)  with the tiny T5 and a tiny x480 VAE carried across from JAX,
        ``embed_text``, ``prepare_data`` (latents, mean, std, readout; a
        second call served from the cache) and ``roundtrip_latents`` fall
        within ENCODE_ATOL of JAX's;
  (iii) ``train_teacher`` feeds its step JAX's batches, and its cache
        refuses a bundle whose model kwargs or latent norm differ;
  (iv)  the guided distillation builder equals JAX's composition on a
        carried MaskDiT; the teacher is untouched by a stage and the stages
        are cached; the student's bundle round-trips bit for bit with its
        metadata; a server whose EzAudio had its weights swapped in place
        serves the student's ``generate_audio(sampler='distilled')``.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.validation import distill_serve_mid as ds
from ezaudio_tpu_torch.validation import mid_common as mc
from tests.test_torch_quality_harness import TINY_MID_VAE

ENCODE_ATOL = 1e-5   # VAE latents and T5 embeddings, port against JAX (max |z| ~ 1)
GUIDED_TOL = 1e-5    # the guided teacher's output, share of its largest magnitude
SERVE_TOL = 1e-5     # a served waveform against the direct call, share of its range
FRAMES = 100         # 2 s clips: the readout's short-clip gate (0.8) applies


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripts(*names):
    """The JAX scripts, imported as oracles; their imports point JAX's
    compile cache at the repo root, which is put back."""
    import importlib

    keep = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                "jax_persistent_cache_min_compile_time_secs")}
    try:
        return [importlib.import_module(f"scripts.{n}") for n in names]
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)


# ---------------------------------------------------------------------------
# (i) the EzAudio the harnesses build
@pytest.mark.parametrize("with_controlnet", [False, True])
def test_build_mid_ezaudio_dicts_match_jax(monkeypatch, with_controlnet):
    import ezaudio_tpu.api.ezaudio as jez
    import ezaudio_tpu_torch.api.ezaudio as tez

    (jmc,) = _scripts("mid_common")

    class Recorder:
        def __init__(self, **kw):
            self.kw = kw

    monkeypatch.setattr(jez, "EzAudio", Recorder)
    monkeypatch.setattr(tez, "EzAudio", Recorder)
    want = jmc.build_mid_ezaudio(12, 512, 8, 500, with_controlnet=with_controlnet)
    got = mc.build_mid_ezaudio(12, 512, 8, 500, with_controlnet=with_controlnet, device="cpu")
    for w, g in zip(want[1:], got[1:]):  # cfg, model_cfg, vae_cfg
        assert g == w
    assert ("controlnet" in got[1]) == ("conditioner" in got[1]) == with_controlnet
    jkw, tkw = want[0].kw, got[0].kw
    assert tkw["config"] == jkw["config"] and tkw["vae_config"] == jkw["vae_config"]
    assert dataclasses.asdict(tkw["t5_config"]) == dataclasses.asdict(jkw["t5_config"])
    assert tkw["dtype"] == torch.float32 and tkw["device"] == "cpu"


# ---------------------------------------------------------------------------
# (ii) the data on a carried tiny T5 and VAE
@pytest.fixture(scope="module")
def carried():
    """The JAX EzAudio of the port's config (the tiny x480 VAE, the mid T5,
    a depth-1 DiT) on weights drawn by shape, and the port's EzAudio with
    its T5 and VAE carried across."""
    from flax import linen as nn

    from ezaudio_tpu.api.ezaudio import EzAudio as JaxEzAudio
    from ezaudio_tpu.text.t5 import T5EncoderConfig as JaxT5
    from ezaudio_tpu_torch.convert.from_jax import t5_state_dict_from_jax, vae_state_dict_from_jax
    from tests.test_torch_controlnet import _seeded_init

    ez, cfg, _, _ = mc.build_mid_ezaudio(1, 32, 2, FRAMES, device="cpu", vae_config=TINY_MID_VAE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(15)))
        jez = JaxEzAudio(config=cfg, t5_config=JaxT5(**mc.MID_T5), vae_config=TINY_MID_VAE)
    ez.t5.load_state_dict(t5_state_dict_from_jax(jez.t5_params, mc.MID_T5["num_layers"]))
    ez.autoencoder.model.load_state_dict(vae_state_dict_from_jax(jez.autoencoder.params))
    return jez, ez


def test_prepare_data_and_roundtrip_match_jax(carried, tmp_path, capsys):
    (jmc,) = _scripts("mid_common")
    jez, ez = carried
    want = jmc.prepare_data(jez, FRAMES, 8, 8, cache_dir=str(tmp_path / "jax"))
    got = mc.prepare_data(ez, FRAMES, 8, 8, cache_root=str(tmp_path / "port"))
    for k in ("cls_train", "cls_eval", "cond_mask", "unc_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("cond_emb", "unc_emb"):
        np.testing.assert_allclose(got[k], want[k], atol=ENCODE_ATOL)
    np.testing.assert_allclose([got["mu"], got["sd"]], [want["mu"], want["sd"]], rtol=1e-5)
    for k in ("m_train", "m_eval"):  # the encoded latents, z = m sd + mu
        np.testing.assert_allclose(got[k] * got["sd"], want[k] * want["sd"], atol=ENCODE_ATOL)
    assert (ez.scale, ez.shift) == (1.0 / got["sd"], -got["mu"])
    out = capsys.readouterr().out
    acc = [line for line in out.splitlines() if line.startswith("readout accuracy")]
    assert len(acc) == 2 and acc[0] == acc[1]
    again = mc.prepare_data(ez, FRAMES, 8, 8, cache_root=str(tmp_path / "port"))
    assert "[data] reusing cached latents" in capsys.readouterr().out
    for k in ("m_train", "m_eval", "cls_eval"):
        np.testing.assert_array_equal(again[k], got[k])
    assert (again["mu"], again["sd"]) == (got["mu"], got["sd"])

    mu, sd = got["mu"], got["sd"]
    rt = mc.roundtrip_latents(ez, got["m_eval"], mu, sd)
    jrt = jmc.roundtrip_latents(jez, got["m_eval"], mu, sd)
    assert rt.shape == jrt.shape == got["m_eval"].shape
    np.testing.assert_allclose(rt * sd, jrt * sd, atol=ENCODE_ATOL)


# ---------------------------------------------------------------------------
# (iii) the teacher's batches and its cache
def _fake_data(rng, n=12, C=8):
    return dict(m_train=rng.standard_normal((n, FRAMES, C)).astype(np.float32),
                cls_train=rng.integers(0, 4, n),
                cond_emb=rng.standard_normal((4, 8, 64)).astype(np.float32),
                cond_mask=rng.uniform(size=(4, 8)) < 0.7,
                unc_emb=rng.standard_normal((1, 8, 64)).astype(np.float32),
                unc_mask=np.arange(8)[None] < 1, mu=0.25, sd=0.5)


def test_train_teacher_batches_and_cache(monkeypatch, tmp_path, capsys):
    import ezaudio_tpu.training.trainer as jtrainer
    import ezaudio_tpu_torch.training.trainer as ttrainer

    (jmc,) = _scripts("mid_common")
    data = _fake_data(np.random.default_rng(3))
    jax_batches, port_batches = [], []

    def jax_step(*a, **k):
        def step(state, batch, key):
            jax_batches.append({n: np.asarray(v) for n, v in batch.items()})
            return state, {"loss": jnp.float32(0.0)}
        return step

    def port_step(*a, **k):
        def step(batch, seed):
            port_batches.append({n: v.numpy() for n, v in batch.items()})
            return {"loss": torch.tensor(0.0)}
        return step

    monkeypatch.setattr(jtrainer, "make_train_step", jax_step)
    monkeypatch.setattr(ttrainer, "make_train_step", port_step)
    ez, _, model_cfg, _ = mc.build_mid_ezaudio(1, 32, 2, FRAMES, device="cpu",
                                               vae_config=TINY_MID_VAE)
    jfake = types.SimpleNamespace(dit=None, dit_params={"params": {"w": np.zeros(3, np.float32)}})
    jmc.train_teacher(jfake, model_cfg, data, 3, 4, cache_dir=str(tmp_path / "jax"))
    root = str(tmp_path / "port")
    dit = mc.train_teacher(ez, model_cfg, data, 3, 4, cache_root=root)
    assert dit is ez.dit and not dit.training and not any(p.requires_grad
                                                          for p in dit.parameters())
    assert len(port_batches) == len(jax_batches) == 3
    for g, w in zip(port_batches, jax_batches):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])

    # the teacher starts from the mid harness's initialiser, not init_random_
    from ezaudio_tpu_torch.validation.quality_validate import seeded_maskdit

    init = seeded_maskdit(model_cfg, 0, "cpu").state_dict()
    assert all(torch.equal(v, init[k]) for k, v in ez.dit.state_dict().items())

    # the cache: served when kwargs and latent norm match, refused otherwise
    capsys.readouterr()
    with torch.no_grad():
        next(ez.dit.parameters()).add_(1.0)
    mc.train_teacher(ez, model_cfg, data, 3, 4, cache_root=root)
    assert "reusing cached teacher" in capsys.readouterr().out and len(port_batches) == 3
    assert all(torch.equal(v, init[k]) for k, v in ez.dit.state_dict().items())
    mc.train_teacher(ez, model_cfg, dict(data, sd=data["sd"] + 1e-3), 3, 4, cache_root=root)
    assert "does not match" in capsys.readouterr().out and len(port_batches) == 6
    folder = os.path.join(root, "mid_teacher", "d1_w32_L100_s3_b4")
    with open(os.path.join(folder, "metadata.json")) as f:
        meta = json.load(f)
    meta["kwargs"]["model"]["num_heads"] = 4  # the key leaves the heads out
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump(meta, f)
    mc.train_teacher(ez, model_cfg, data, 3, 4, cache_root=root)
    assert "does not match" in capsys.readouterr().out and len(port_batches) == 9


# ---------------------------------------------------------------------------
# (iv) distillation, the student's bundle, serving after a swap
@pytest.fixture(scope="module")
def carried_dit():
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
    from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.validation.quality_validate_mid import model_config
    from tests.test_torch_modules import seeded_params

    cfg = model_config(2, 32, 2, 40, 8, False)
    jmodel = jax_maskdit(cfg)
    params = jax.device_get(seeded_params(jmodel, np.random.default_rng(16),
                                          jnp.zeros((1, 40, 8)), jnp.zeros((1,), jnp.int32),
                                          jnp.zeros((1, 8, 64)))["params"])
    model = maskdit_from_config(cfg).eval().requires_grad_(False)
    model.load_state_dict(maskdit_state_dict_from_jax(params, cfg))
    return jmodel, params, model, cfg


def test_guided_builder_matches_jax(carried_dit):
    """The guided teacher of stage 1 (scripts/distill_serve_mid.py:96-115:
    one call on the pair [prompt; empty prompt] with the key masks)."""
    jmodel, params, model, _ = carried_dit
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3, 40, 8)).astype(np.float32)
    text = rng.standard_normal((3, 8, 64)).astype(np.float32)
    text_mask = np.arange(8)[None] < np.array([[5], [8], [2]])
    unc_emb = rng.standard_normal((1, 8, 64)).astype(np.float32)
    unc_mask = np.arange(8)[None] < 1
    G, t = mc.GUIDANCE, 437

    def jax_fn(x, t):
        tt = jnp.broadcast_to(t, (x.shape[0],))
        B = x.shape[0]
        ctx = jnp.concatenate([text, jnp.broadcast_to(unc_emb, (B,) + unc_emb.shape[1:])], 0)
        cm = jnp.concatenate([text_mask, jnp.broadcast_to(unc_mask, (B,) + unc_mask.shape[1:])],
                             0)
        out, _ = jmodel.apply({"params": params}, jnp.concatenate([x, x], 0),
                              jnp.concatenate([tt, tt], 0), ctx, context_mask=cm)
        cond, unc = jnp.split(out, 2, axis=0)
        return unc + G * (cond - unc)

    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x), jnp.int32(t)))
    batch = {"text": torch.from_numpy(text), "text_mask": torch.from_numpy(text_mask)}
    fn = ds.guided_builder(torch.from_numpy(unc_emb), torch.from_numpy(unc_mask), G)(batch, model)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.tensor(t)).numpy()
        single = ds.student_apply(model)(torch.from_numpy(x), torch.tensor(t), batch).numpy()
    assert np.abs(got - want).max() <= GUIDED_TOL * np.abs(want).max()
    jsingle, _ = jmodel.apply({"params": params}, jnp.asarray(x), jnp.full((3,), t), text,
                              context_mask=text_mask)
    np.testing.assert_allclose(single, np.asarray(jsingle), atol=GUIDED_TOL * np.abs(want).max())


def test_distill_stages_keep_the_teacher_and_cache(carried_dit, tmp_path, capsys):
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule

    _, _, model, cfg = carried_dit
    teacher = ds.student_from_teacher(model).eval().requires_grad_(False)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    data = dict(_fake_data(np.random.default_rng(4)), m_train=np.random.default_rng(5)
                .standard_normal((12, 40, 8)).astype(np.float32))
    a = ds.parse_args(["--depth", "2", "--dim", "32", "--frames", "40", "--distill-steps", "2",
                       "--batch", "2", "--cache-root", str(tmp_path)])
    sched = DDIMSchedule.from_config(mc.MID_DIFF)
    student = ds.distill(teacher, data, sched, a, log_every=1)
    assert all(torch.equal(v, before[k]) for k, v in teacher.state_dict().items())
    assert not student.training and not any(p.requires_grad for p in student.parameters())
    moved = [k for k, v in student.state_dict().items() if not torch.equal(v, before[k])]
    assert moved
    assert "stage cached" in capsys.readouterr().out
    again = ds.distill(teacher, data, sched, a)
    assert capsys.readouterr().out.count("reusing cached stage") == len(ds.STAGES)
    assert all(torch.equal(v, student.state_dict()[k]) for k, v in again.state_dict().items())

    loaded, meta = ds.save_student(str(tmp_path / "ckpt"), student, cfg, 0.25, 0.5)
    assert meta == {"distilled_steps": 4, "guidance": mc.GUIDANCE, "latent_mu": 0.25,
                    "latent_sd": 0.5}
    sd, back = student.state_dict(), loaded.state_dict()
    assert set(sd) == set(back) and all(torch.equal(back[k], v) for k, v in sd.items())


def test_served_student_after_swap(tmp_path):
    """The teacher served, the student loaded into ``ez.dit`` in place, then
    served: each request the direct ``generate_audio`` for its seed."""
    ez, _, _, _ = mc.build_mid_ezaudio(1, 32, 2, FRAMES, device="cpu", vae_config=TINY_MID_VAE)
    dit = ez.dit
    student = ds.student_from_teacher(ez.dit)
    with torch.no_grad():
        for p in student.parameters():
            p.mul_(1.1)
    prompts = mc.PROMPTS[:2]
    length = FRAMES / ez.latent_sr
    teacher_wavs, _, stats = ds.serve(ez, prompts, length, 2, sampler="distilled", ddim_steps=4)
    assert stats["batches"] == 1
    ez.dit.load_state_dict(student.state_dict())
    assert ez.dit is dit
    wavs, _, _ = ds.serve(ez, prompts, length, 2, sampler="distilled", ddim_steps=4)
    for i, p in enumerate(prompts):
        _, direct = ez.generate_audio(p, length=length, sampler="distilled", ddim_steps=4,
                                      random_seed=i)
        assert np.abs(wavs[i] - direct).max() <= SERVE_TOL * np.abs(direct).max()
        assert np.abs(teacher_wavs[i] - direct).max() > 10 * SERVE_TOL * np.abs(direct).max()
