"""A dry run of every parallel path on N ranks (the torch analog of the JAX
package's ``__graft_entry__.py::dryrun_multichip``).

    python -m ezaudio_tpu_torch.parallel.dryrun --procs 8
    python -m ezaudio_tpu_torch.parallel.dryrun --procs 4 --device cpu

spawns ``--procs`` ranks (NCCL with one GPU each, the default; gloo on the
CPU with ``--device cpu``, a rehearsal on a machine without cards) and
runs, on tiny shapes, the JAX dry run's phases with its mesh choices:

  1. one full train step over a dp x fsdp x tp mesh (fsdp 2 from 4
     ranks, tp 2 from 8), the loss finite;
  2. dp-sharded CFG sampling;
  3. dp x sp ring sampling (sp 2), the model's self-attention on the ring;
  4. ``EzAudio(mesh=make_mesh(dp=N))`` against a single-device EzAudio at
     one seed, and every served path (two length buckets, an edit, the
     ControlNet, best-of-K with a toy scorer) drained through
     ``GenerationServer`` against a single-device server, within 1e-5 at
     f32.

Rank 0 prints JAX's one-line summary, ``dryrun(N): ok, loss=..., phases=[...]``.
Every rank is joined under ``--timeout`` seconds: a hung collective fails
the run (exit 1) instead of waiting forever.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import tempfile
import time
import traceback
import zlib

import numpy as np
import torch

MODEL = dict(
    mae=True, mae_prob=0.25, mask_ratio=[0.25, 1.0], mask_span=4, img_size=32, patch_size=1,
    in_chans=17, out_chans=8, input_type="1d", embed_dim=64, depth=4, num_heads=4,
    mlp_ratio=2.0, qkv_bias=False, qk_scale=None, qk_norm="layernorm", norm_layer="layernorm",
    act_layer="geglu", context_norm=True, use_checkpoint=True, time_fusion="ada_sola_bias",
    ada_sola_rank=8, ada_sola_alpha=8, cls_dim=None, context_dim=24, context_fusion="cross",
    context_max_length=None, context_pe_method="none", pe_method="none", rope_mode="shared",
    use_conv=True, skip=True, skip_norm=True)
DIFF = dict(num_train_timesteps=1000, beta_schedule="scaled_linear", beta_start=0.00085,
            beta_end=0.012, prediction_type="v_prediction", rescale_betas_zero_snr=True,
            timestep_spacing="trailing", clip_sample=False)
SR = 800
API_CONFIG = dict(
    model_name="EzAudio-Dryrun",
    model=dict(MODEL, img_size=100, context_dim=32, use_checkpoint=False),
    autoencoder=dict(name="stable_vae", dim=8, sr=SR, latent_sr=50, q_first=True, scale=1.0,
                     shift=0.0),
    text_encoder=dict(model="tiny-t5", max_length=12, cfg=0.1),
    diff=DIFF,
    controlnet=dict(cond_in=1, cond_blocks=[8, 16], cond_mask=True, cond_mask_prob=0.25,
                    cond_mask_ratio=[0.25, 0.5], cond_mask_span=4),
    conditioner=dict(condition_type="energy", hop_size=8, window_size=64, padding="reflect",
                     min_db=-60, norm=True),
)
VAE_CONFIG = dict(
    model_type="autoencoder", sample_rate=SR, audio_channels=1,
    model=dict(
        encoder=dict(type="oobleck", config=dict(in_channels=1, channels=8, c_mults=[1, 2],
                                                 strides=[4, 4], latent_dim=16,
                                                 use_snake=True)),
        decoder=dict(type="oobleck", config=dict(out_channels=1, channels=8, c_mults=[1, 2],
                                                 strides=[4, 4], latent_dim=8, use_snake=True,
                                                 final_tanh=False)),
        bottleneck=dict(type="vae"), latent_dim=8, downsampling_ratio=16, io_channels=1))
TOL = 1e-5


def _t5():
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig

    return T5EncoderConfig(vocab_size=128, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                           num_heads=4, relative_attention_num_buckets=8,
                           relative_attention_max_distance=20)


class ToyScorer:
    """A deterministic stand-in for ``CLAPScorer``: cosines in a 3-d
    feature space, so best-of-K runs its real batched program."""

    def _feat(self, x):
        x = np.asarray(x, np.float32)
        f = np.stack([np.abs(x).mean(-1), (x ** 2).mean(-1),
                      np.abs(np.diff(x, axis=-1)).mean(-1)], -1)
        return f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-9)

    def embed_audio(self, wav, sr):
        return self._feat(np.atleast_2d(wav))

    def embed_text(self, texts):
        out = []
        for t in texts:
            v = np.random.default_rng(zlib.crc32(t.encode())).standard_normal(3)
            out.append((v / np.linalg.norm(v)).astype(np.float32))
        return np.stack(out)


def train_phase(n, device):
    """Phase 1: one train step of the tiny MaskDiT over dp x fsdp x tp."""
    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.parallel.mesh import make_mesh
    from ezaudio_tpu_torch.training.trainer import Trainer

    fsdp = 2 if n % 2 == 0 and n >= 4 else 1
    tp = 2 if n % (2 * fsdp) == 0 and n >= 8 else 1
    mesh = make_mesh(dp=n // (fsdp * tp), fsdp=fsdp, tp=tp)
    with torch.device(device):
        model = maskdit_from_config(MODEL)
    init_random_(model, torch.Generator(device=device).manual_seed(0))
    trainer = Trainer.create(model, DDIMSchedule.from_config(DIFF),
                             dict(learning_rate=1e-4, warmup=0), mesh=mesh)
    rng = np.random.default_rng(0)
    B, L, C, Lc, D = 2 * n, 32, 8, 5, 24

    def arr(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    batch = {"latents": arr(B, L, C), "text": arr(B, Lc, D),
             "text_mask": torch.ones(B, Lc, dtype=torch.bool, device=device),
             "uncond": arr(1, Lc, D),
             "uncond_mask": torch.ones(1, Lc, dtype=torch.bool, device=device)}
    loss = float(trainer.train_step(batch, 1)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"train step loss {loss}")
    return trainer, loss, f"train dp{n // (fsdp * tp)}xfsdp{fsdp}xtp{tp}"


def sampling_phases(n, device, trainer):
    """Phases 2 and 3: CFG sampling sharded over dp, then over dp x sp with
    the model's self-attention on the ring."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.diffusion.sampling import sample_latents
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from ezaudio_tpu_torch.parallel.ring_attention import ring_context

    schedule = DDIMSchedule.from_config(DIFF)
    state = trainer.sharding.full_state_dict()
    with torch.device(device):
        model = maskdit_from_config(MODEL).eval()
        model_ring = maskdit_from_config(dict(MODEL, attention_impl="ring")).eval()
    model.load_state_dict(state)
    model_ring.load_state_dict(state)
    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn(n, 32, 8, generator=gen, device=device)

    def fn_for(m):
        def model_fn(lat, t):
            ctx = torch.zeros(lat.shape[0], 5, 24, device=device)
            out, _ = m(lat, torch.tensor(t, device=device), ctx)
            return out
        return model_fn

    with torch.no_grad():
        lat = sample_latents(fn_for(model), schedule, shard_batch(make_mesh(dp=n), noise), 2,
                             guidance_scale=3.0, eta=1.0,
                             generator=torch.Generator(device=device).manual_seed(1))
        if not torch.isfinite(lat).all():
            raise AssertionError("dp sampling is not finite")
        sp = 2 if n % 2 == 0 else 1
        if sp > 1:
            mesh_sp = make_mesh(dp=n // sp, sp=sp)
            with ring_context(mesh_sp, batch_axes=("dp",)):
                lat_sp = sample_latents(fn_for(model_ring), schedule,
                                        shard_batch(mesh_sp, noise), 2, guidance_scale=3.0,
                                        eta=1.0,
                                        generator=torch.Generator(device=device).manual_seed(1))
            if not torch.isfinite(lat_sp).all():
                raise AssertionError("ring sampling is not finite")
    return ["cfg-dp", f"ring-sp{sp}"]


def api_phases(n, device):
    """Phase 4: the public surface on a dp mesh against single-device runs."""
    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.parallel.mesh import make_mesh
    from ezaudio_tpu_torch.serving import GenerationServer

    kw = dict(config=API_CONFIG, t5_config=_t5(), vae_config=VAE_CONFIG, device=device)
    ez_solo = EzAudio(**kw)
    ez_mesh = EzAudio(mesh=make_mesh(dp=n), **kw)
    prompts = [f"sound number {i}" for i in range(n)]
    _, w_solo = ez_solo.generate_audio(prompts, length=2, ddim_steps=2, random_seed=7)
    _, w_mesh = ez_mesh.generate_audio(prompts, length=2, ddim_steps=2, random_seed=7)
    api_err = float(np.abs(w_mesh - w_solo).max())
    if not api_err < TOL:
        raise AssertionError(f"mesh API != single-device: max err {api_err}")
    gt = (0.5 * np.sin(2 * np.pi * 55 * np.arange(2 * SR) / SR)).astype(np.float32)

    def drain(ez):
        cn = EzAudioControlNet(base=ez)
        with GenerationServer(ez, controlnet=cn, clap_scorer=ToyScorer(), max_batch_size=n,
                              max_wait_ms=100, length=2.0, length_buckets=[1.0, 2.0],
                              ddim_steps=2, sampler="dpm") as srv:
            if ez.mesh is not None and not all(b % n == 0 for b in srv.buckets):
                raise AssertionError(f"buckets {srv.buckets} do not align to {n}")
            futs = {
                "gen-1s": srv.submit("a short sound", seed=3, length=1.0),
                "gen-2s": srv.submit("a long sound", seed=4, length=2.0),
                "gen-2s-b": srv.submit("another long sound", seed=5, length=2.0),
                "edit": srv.submit_edit("an edit", gt, boundary=0.25, mask_start=0.5,
                                        mask_length=0.5, seed=6, ddim_steps=2),
                "controlnet": srv.submit_controlnet("a tone", gt, seed=7, ddim_steps=2),
                "rerank": srv.submit_reranked("best of k", n_candidates=2, seed=8, length=1.0),
            }
            return {k: np.asarray(f.result(timeout=600)[1], np.float32)
                    for k, f in futs.items()}

    solo, mesh = drain(ez_solo), drain(ez_mesh)
    errs = {k: float(np.abs(mesh[k] - solo[k]).max()) for k in solo}
    if not max(errs.values()) < TOL:
        raise AssertionError(f"served mesh != single-device: {errs}")
    return api_err, errs


def _rank_main(rank, n, device_type, init_method, out):
    from ezaudio_tpu_torch.parallel.mesh import init_distributed

    try:
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = init_distributed(device_type if device_type == "cpu" else f"cuda:{rank}",
                                  init_method=init_method, rank=rank, world_size=n)
        trainer, loss, train_name = train_phase(n, device)
        phases = [train_name] + sampling_phases(n, device, trainer)
        api_err, errs = api_phases(n, device)
        served = ", ".join(f"{k}={v:.1e}" for k, v in errs.items())
        line = (f"dryrun({n}): ok, loss={loss:.4f}, phases=[{', '.join(phases)}, "
                f"api-mesh(dp{n}, max_err={api_err:.1e}), server per-path max_err: {served}]")
        out.put((rank, True, line))
    except Exception:
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run(n: int, device: str = "cuda", timeout: float = 600.0) -> str:
    """Spawn ``n`` ranks, run every phase, return rank 0's summary line;
    raise if a rank fails or the run passes ``timeout`` seconds."""
    import torch.multiprocessing as mp

    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} GPUs, found {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, args=(r, n, device, init_method, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        results, deadline = {}, time.time() + timeout
        try:
            while len(results) < n:
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(f"dryrun({n}): {n - len(results)} ranks did not finish "
                                       f"within {timeout:.0f} s")
                try:
                    rank, ok, msg = out.get(timeout=min(left, 5.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        raise RuntimeError(f"dryrun({n}): a rank died: "
                                           f"{[p.exitcode for p in procs]}")
                    continue
                results[rank] = (ok, msg)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    bad = {r: m for r, (ok, m) in results.items() if not ok}
    if bad:
        raise RuntimeError(f"dryrun({n}) failed on ranks {sorted(bad)}:\n{next(iter(bad.values()))}")
    return results[0][1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    try:
        print(run(args.procs, args.device, args.timeout), flush=True)
    except Exception as e:
        print(f"dryrun({args.procs}): FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
