"""Training entry point: ``python -m ezaudio_tpu_torch.training.train_cli``
(counterpart of ``ezaudio_tpu/training/train_cli.py``).

    python -m ezaudio_tpu_torch.training.train_cli --config-name train.json \\
        --max-steps 1000 --save-dir ckpts/ --log-dir logs/

The config (a ``.json`` or reference ``.yml`` path, or a registered model
name) carries ``model:``, ``autoencoder:``, ``text_encoder:`` and ``diff:``
as the model configs do, plus ``opt:`` (the optimizer's settings and
``batch_size``) and ``data:`` (``train:``, the ``EACaps`` arguments, and
optionally ``train_frames``).

  * two stages: ``context_dim: null`` is MAE pretraining (no text, no
    T5), anything else text-to-audio;
  * per step: the batch's clips through the VAE encoder (kernel 2), seeded
    per step from ``(seed + 1, step)``; the captions through T5 outside
    inference mode (or the dataset's offline embeddings); then the train
    step (``trainer.py``) with CFG dropout to the empty prompt's
    embedding;
  * a line in ``<log-dir>/<model_name>/log.txt`` every ``--log-step``
    steps; a checkpoint every ``--save-every-step`` steps (written from a
    thread) and at the end; a restart resumes from the latest checkpoint
    in ``<save-dir>/<model_name>``, data order included, and cuDNN runs
    its deterministic algorithms (:func:`deterministic_cudnn`) so the
    steps after the checkpoint come out as they did;
  * ``--ckpt`` and ``--vae-ckpt`` load reference-format files
    (``convert/checkpoints.py``); a model without one starts from seeded
    random weights, T5 included (as the JAX package's CLI).

The DiT trains with f32 parameters in train mode; T5 and the VAE stay
frozen.  ``--dtype bfloat16`` is the JAX package's bf16 trainer: T5 and
the VAE cast to bf16 once (as ``EzAudio(dtype=bf16)``; both kernels in
their bf16 modes), the DiT in mixed precision (``trainer.py``: bf16
compute, f32 parameters and optimizer state).  The ``opt:`` block's
``optimizer`` (``adamw`` or ``adafactor``) and ``mu_dtype`` reach
``optim.make_optimizer``.  Runs on CUDA unless ``--device cpu``.

Sharded training runs under torchrun, one process per GPU::

    torchrun --nproc_per_node=N -m ezaudio_tpu_torch.training.train_cli \
        --config-name train.json --mesh-fsdp 2 ...

Each rank joins the group (``parallel.init_distributed``: NCCL on the
cards, gloo with ``--device cpu``), builds the ``make_mesh(fsdp=N)`` mesh
over the world (dp the rest, as the JAX CLI's), reads the whole batch,
encodes and embeds its own rows (the VAE's posterior noise and the
step's draws are still the whole batch's) and trains them
(``Trainer.create(mesh=)``); rank 0 logs and writes the checkpoints, which
keep the single-device layout.  In a world of one process the CLI trains
without a mesh (a mesh of one is the identity); ``--mesh-fsdp`` must
still divide the world.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ezaudio_tpu_torch.utils import deterministic_cudnn

def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m ezaudio_tpu_torch.training.train_cli")
    p.add_argument("--config-name", type=str, required=True,
                   help="training config (.json/.yml) or registered model name")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--save-every-step", type=int, default=5000)
    p.add_argument("--random-seed", type=int, default=2024)
    p.add_argument("--log-step", type=int, default=100)
    p.add_argument("--log-dir", type=str, default="logs/",
                   help="under the current directory unless given")
    p.add_argument("--save-dir", type=str, default="ckpts/",
                   help="checkpoints; a run resumes from the latest one here")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference DiT checkpoint to fine-tune from")
    p.add_argument("--vae-ckpt", type=str, default=None)
    p.add_argument("--mesh-fsdp", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--remat", type=str, default=None, choices=["full", "dots", "off"],
                   help="activation recompute per DiT block (default: the model config)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA)")
    return p.parse_args(argv)


def load_training_config(name: str):
    from ezaudio_tpu_torch.config import MODEL_REGISTRY, load_config

    cfg = load_config(MODEL_REGISTRY[name]["config"] if name in MODEL_REGISTRY else name)
    missing = [k for k in ("opt", "data") if k not in cfg]
    if missing:
        raise ValueError(f"{name}: a training config needs the blocks {missing}")
    return cfg


def build_models(cfg, device, seed: int, ckpt=None, vae_ckpt=None, t5_config=None,
                 vae_config=None, dtype=torch.float32):
    """(DiT, autoencoder facade, T5 or None, tokenizer or None): seeded
    random weights by the port's init rules, then the given checkpoints;
    the frozen T5 and VAE cast to ``dtype``, the DiT kept f32."""
    from ezaudio_tpu_torch.api.ezaudio import _T5_CONFIGS, init_random_
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
    from ezaudio_tpu_torch.config import MODEL_REGISTRY, load_config
    from ezaudio_tpu_torch.convert.checkpoints import (load_state_dict_strict,
                                                       load_torch_checkpoint, strip_prefix)
    from ezaudio_tpu_torch.convert.from_jax import fold_weight_norm
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.text.t5 import T5Encoder, T5EncoderConfig
    from ezaudio_tpu_torch.text.tokenizer import get_tokenizer
    from ezaudio_tpu_torch.utils import cast_params_

    context_dim = cfg.model.get("context_dim")
    t5_cfg = None
    if context_dim is not None:
        t5_cfg = t5_config or _T5_CONFIGS.get(cfg.text_encoder.model,
                                              lambda: T5EncoderConfig(d_model=context_dim))()
        if t5_cfg.d_model != context_dim:
            raise ValueError("text encoder width must match model context_dim")
    vae_cfg = vae_config or load_config(MODEL_REGISTRY["vae"]["config"]).to_dict()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.device(device):
        dit = maskdit_from_config(cfg.model.to_dict())
        vae = vae_from_config(vae_cfg)
        t5 = T5Encoder(t5_cfg) if t5_cfg is not None else None
    for m in (dit, vae, t5):
        if m is not None:
            init_random_(m, gen)
    if ckpt:
        load_state_dict_strict(dit, load_torch_checkpoint(ckpt, "model"), ckpt)
    if vae_ckpt:
        sd = strip_prefix(load_torch_checkpoint(vae_ckpt, "state_dict"), "autoencoder.")
        load_state_dict_strict(vae, fold_weight_norm(sd), vae_ckpt)
    dit.train().requires_grad_(True)
    for m in (vae, t5):
        if m is not None:
            cast_params_(m.eval().requires_grad_(False), dtype)
    autoencoder = AutoencoderFacade(vae, quantization_first=cfg.autoencoder.get("q_first", True))
    tokenizer = get_tokenizer(None, t5_cfg.vocab_size) if t5 is not None else None
    return dit, autoencoder, t5, tokenizer


def main(argv=None, *, t5_config=None, vae_config=None,
         on_step: Optional[Callable[[int, dict], None]] = None):
    """Train; returns the :class:`~ezaudio_tpu_torch.training.trainer.Trainer`.
    ``t5_config`` / ``vae_config`` replace the default towers' configs
    (tiny towers in tests); ``on_step(step, metrics)`` is called after
    every step (measurement)."""
    from ezaudio_tpu_torch.data.dataset import EACaps, ResumableIterator
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.training.trainer import PreemptionGuard, Trainer, latest_step, step_seed
    from ezaudio_tpu_torch.utils import resolve_device

    from ezaudio_tpu_torch.parallel.mesh import (data_rank, data_world, init_distributed,
                                                 make_mesh, mesh_shape)

    args = parse_args(argv)
    dtype = getattr(torch, args.dtype)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or torch.distributed.is_initialized():
        device = init_distributed(args.device)
        mesh = make_mesh(fsdp=args.mesh_fsdp)
    else:
        mesh_shape(1, fsdp=args.mesh_fsdp)
        device = resolve_device(args.device)
    rank0 = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    cfg = load_training_config(args.config_name)
    if args.remat == "off":
        cfg.model.use_checkpoint = False
    elif args.remat is not None:
        cfg.model.use_checkpoint = True
        cfg.model.remat_policy = args.remat
    audiocaps = cfg.model.get("context_dim") is not None

    dit, autoencoder, t5, tokenizer = build_models(
        cfg, device, args.random_seed, args.ckpt, args.vae_ckpt, t5_config=t5_config,
        vae_config=vae_config, dtype=dtype)
    train_cfg = cfg.data.train.to_dict()
    # CFG dropout happens once: in the dataset where offline embeddings
    # carry their own cfg_prob, else in the train step at the configured rate
    offline_cfg = bool(train_cfg.get("text_path")) and float(train_cfg.get("cfg_prob", 0.0)) > 0
    cfg_dropout = 0.0 if offline_cfg else float(cfg.get("text_encoder", {}).get("cfg", 0.1) or 0)
    trainer = Trainer.create(dit, DDIMSchedule.from_config(cfg.diff), cfg.opt.to_dict(),
                             scale=cfg.autoencoder.get("scale", 1.0),
                             shift=cfg.autoencoder.get("shift", 0.0),
                             train_frames=cfg.data.get("train_frames"),
                             cfg_dropout=cfg_dropout, dtype=dtype, mesh=mesh)

    train_set = EACaps(**train_cfg, seed=args.random_seed)
    batch_size = int(cfg.opt.batch_size)
    it = ResumableIterator(train_set, batch_size, seed=args.random_seed)
    max_length = cfg.text_encoder.max_length if audiocaps else None

    @torch.no_grad()  # not inference mode: the DiT saves these for its backward
    def embed(texts):
        ids, mask = tokenizer(list(texts), max_length=max_length)
        mask = torch.from_numpy(mask).to(device)
        return t5(torch.from_numpy(ids).to(device), mask), mask.bool()

    uncond, uncond_mask = embed([""]) if audiocaps else (None, None)
    model_name = cfg.get("model_name", "model")
    log_dir = os.path.join(args.log_dir, model_name)
    save_dir = os.path.abspath(os.path.join(args.save_dir, model_name))
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(save_dir, exist_ok=True)
    latest = latest_step(save_dir)
    if latest is not None and args.ckpt is None:
        if rank0:
            print(f"resuming from checkpoint step {latest}")
        trainer.restore_checkpoint(save_dir, latest)

    global_step = trainer.step
    steps_per_epoch = max(1, len(train_set) // batch_size)
    total = args.max_steps or args.epochs * steps_per_epoch
    it.load_state_dict({"epoch": global_step // steps_per_epoch,
                        "step": global_step % steps_per_epoch})
    # on a mesh each rank encodes and embeds its rows of the batch alone;
    # the VAE's posterior noise and the step's draws are the whole batch's
    world, rank = (data_world(mesh), data_rank(mesh)) if mesh is not None else (1, 0)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not divide over the data world {world}")
    k = batch_size // world
    own = slice(rank * k, (rank + 1) * k)
    losses, t0 = [], time.time()
    with PreemptionGuard() as guard, deterministic_cudnn():
        try:
            for batch in (it if global_step < total else ()):
                gen = torch.Generator(device=device).manual_seed(
                    step_seed(args.random_seed + 1, global_step))
                audio = torch.from_numpy(batch["audio"][own]).to(device)
                latents = autoencoder.encode(audio[:, :, None], generator=gen,
                                             rows=(own.start, batch_size))
                text = text_mask = None
                if audiocaps and "text_mask" in batch:  # offline embeddings
                    text = torch.from_numpy(batch["text"][own]).to(device, dtype)
                    text_mask = torch.from_numpy(batch["text_mask"][own]).to(device).bool()
                elif audiocaps:
                    text, text_mask = embed(list(batch["text"])[own])
                metrics = trainer.train_step(
                    {"latents": latents, "text": text, "text_mask": text_mask,
                     "uncond": uncond, "uncond_mask": uncond_mask}, args.random_seed,
                    local=mesh is not None)
                losses.append(metrics["loss"])
                global_step += 1
                if on_step is not None:
                    on_step(global_step, metrics)
                if global_step % args.log_step == 0:
                    window = [float(v) for v in losses[-args.log_step:]]
                    del losses[:-args.log_step]
                    msg = (f"{time.asctime()}  step {global_step}  loss {np.mean(window):.6f}  "
                           f"({args.log_step / (time.time() - t0):.2f} it/s)\n")
                    if rank0:  # on a mesh the loss is the mean over the ranks already
                        with open(os.path.join(log_dir, "log.txt"), "a") as f:
                            f.write(msg)
                        print(msg, end="")
                    t0 = time.time()
                if global_step % args.save_every_step == 0:
                    trainer.save_checkpoint(save_dir, global_step, block=False)
                if guard.preempted:
                    print(f"preemption signal: checkpointing at step {global_step} and exiting")
                    break
                if global_step >= total:
                    break
            # the final save runs under the guard: a second signal during
            # the write is absorbed; a step saved periodically is joined
            trainer.save_checkpoint(save_dir, global_step, skip_existing=True)
        finally:
            trainer.close()
    return trainer


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
