"""The diffusion train step, the trainer and its checkpoints (counterpart
of ``ezaudio_tpu/training/trainer.py``).

One step, as the JAX package's jitted step (reference src/train.py:262-313):
latents into model space (``scale_shift``), optional crop to
``train_frames``, CFG dropout to the uncond embedding, noise and a uniform
timestep, the epsilon or v target, MaskDiT with span-masked MAE, the masked
(min-SNR) MSE, the gradients, and the optimizer (``optim.py``: clip,
warmup AdamW or Adafactor, accumulation).  Quantization is forced off for
the step, as ``quant_context('off')`` does in the JAX package: int8
``round`` has no gradient.

``dtype=torch.bfloat16`` is the JAX package's bf16 trainer, which is
mixed precision: flax's ``dtype`` is the compute dtype and the parameters
stay f32.  The forward and the backward run inside
``utils.mixed_precision``: each layer computes with a bf16 copy of its
f32 parameter, gradients reach the f32 parameters through the casts, and
the optimizer's state is that of f32 parameters.  The latents stay in the
VAE's dtype (bf16) through ``scale_shift``, the noise is drawn in f32 and
rounded to it, ``add_noise`` and the target are f32 (the f32 alphas
promote them), and the loss sums in f32.

Every draw of step ``n`` comes from a ``torch.Generator`` seeded from
``(seed, n)`` alone (``jax.random.fold_in``'s role), so a resumed run draws
what the uninterrupted run drew.  torch cannot reproduce JAX's draws
(ROADMAP F1): ``draws=`` takes them from the caller instead.

Checkpoints are the port's own format: ``torch.save`` of the model's state
dict, the optimizer's state and the step into ``<dir>/<step>/state.pt``,
the newest ``MAX_TO_KEEP`` kept.  ``block=False`` copies the state to the
host and writes it from a thread; ``close()`` joins the thread and raises
if the write failed.

``Trainer.create(..., mesh=parallel.make_mesh(...))`` trains on a mesh,
one process per GPU: the DiT placed by ``dit_param_shardings``
(``parallel/sharding.py``: FSDP2 HSDP over dp x fsdp, Megatron tp), the
optimizer built after, over the shards.  Every rank draws step ``n``'s
randomness for the whole batch (noise, timesteps, span masks, CFG
dropout), then keeps its rows of the batch and of the draws
(``parallel.shard_batch``), so a sharded step computes the single-device
step's function.  ``train_step(..., local=True)`` takes a batch of this
rank's rows alone (``train_cli`` encodes only its rows) and still draws
for the whole batch.  Each rank's loss is the mean over its rows; the gradients are
averaged over dp x fsdp (``ShardedParams.grads``), the clip's global norm
counts every shard once (``optim.global_norm``) and Adafactor's factored
moments reduce over whole parameters (DTensor reductions).  The reported
loss is the mean over the data-parallel ranks.  Checkpoints keep the
single-device layout: every rank gathers the whole state, rank 0 writes
it, and a sharded run resumes from a single-device checkpoint and the
other way round.  Mixed precision runs on every mesh: FSDP2 gathers the
parameters it shards in bf16 where ``utils.cast_params_`` casts them
(its norms, snakes and positional embeddings stay f32) and reduces their
gradients in f32 (``parallel/sharding.py``); ``mixed_precision`` casts the
rest.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import signal
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
from ezaudio_tpu_torch.ops.quant import quant_context
from ezaudio_tpu_torch.training.losses import masked_diffusion_loss
from ezaudio_tpu_torch.training.optim import Optimizer, global_norm, make_optimizer, named_grads
from ezaudio_tpu_torch.utils import deterministic_cudnn, mixed_precision, scale_shift

MAX_TO_KEEP = 5
STATE_FILE = "state.pt"


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed that depends on ``(seed, step)`` alone."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _data_mean(mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data-parallel ranks."""
    import torch.distributed as dist

    from ezaudio_tpu_torch.parallel.mesh import data_group, data_world

    world = data_world(mesh)
    if world == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=data_group(mesh))
    return x / world


def noised(schedule: DDIMSchedule, latents, noise, t):
    """The latents noised to ``t`` and the epsilon or v target."""
    noisy = schedule.add_noise(latents, noise, t)
    target = (noise if schedule.prediction_type == "epsilon"
              else schedule.get_velocity(latents, noise, t))
    return noisy, target


class StepLoop:
    """What every train step shares (this module's, the ControlNet's and
    distillation's): the draws of step ``n`` from a generator seeded from
    ``(seed, n)`` unless given, quantization off, cuDNN's deterministic
    algorithms (``utils.deterministic_cudnn``, so a restart retakes its
    steps exactly), the loss and the
    gradients of ``params`` (in ``model``'s compute ``dtype``, see
    ``utils.mixed_precision``), the optimizer's update, the step counter.

    A step sets ``params`` (name -> tensor) and gives ``draw_for(generator,
    batch)`` and ``loss(batch, draws)``; ``update(grads)`` applies the
    optimizer and returns the metrics beside the loss (here the global norm
    of the gradients before the clip, which the clip reuses).
    """

    model: Optional[nn.Module] = None
    dtype: Optional[torch.dtype] = None
    sharding = None  # parallel.sharding.ShardedParams of a step on a mesh

    def draw_for(self, generator: torch.Generator, batch: dict) -> dict:
        return self.draw(generator, batch)

    def update(self, grads: dict) -> dict:
        gnorm = global_norm(grads.values())
        self.optimizer.update(grads, gnorm)
        return {"grad_norm": gnorm}

    def __call__(self, batch: dict, seed: int, draws: Optional[dict] = None,
                 return_grads: bool = False, local: bool = False) -> dict:
        """The loss and the metrics as device scalars; with
        ``return_grads`` the gradients too.  ``local`` (on a mesh): ``batch``
        holds this rank's rows already, of a batch the data world times as
        large; the draws are still the whole batch's (given, or drawn for
        that many rows), of which this rank keeps its rows."""
        sh = self.sharding
        if local and sh is None:
            raise ValueError("local=True needs a step on a mesh")
        if sh is not None and sh.wrapped and sh.dtype != (self.dtype or torch.float32):
            raise ValueError(f"a {self.dtype} step on a model FSDP2 gathers in {sh.dtype}: "
                             "shard it with the step's dtype (shard_params(dtype=))")
        if sh is not None:
            from ezaudio_tpu_torch.parallel.mesh import (activation_sharding, axis_size,
                                                         data_world, shard_batch)
        if draws is None:
            gen = torch.Generator(device=batch["latents"].device).manual_seed(
                step_seed(seed, self.step))
            draws = (self.draw_for(gen, batch) if not local else
                     self.draw_for(gen, batch, rows=len(batch["latents"]) * data_world(sh.mesh)))
        if sh is not None:  # the whole batch's draws, then this rank's rows
            if not local:
                batch = shard_batch(sh.mesh, batch)
            draws = shard_batch(sh.mesh, draws)
            act = (activation_sharding(sh.mesh) if axis_size(sh.mesh, "sp") == 1
                   else contextlib.nullcontext())
        skip = sh.fsdp_names if sh is not None and sh.wrapped else ()
        with (quant_context("off"), mixed_precision(self.model, self.dtype, skip),
              deterministic_cudnn(), act if sh is not None else contextlib.nullcontext()):
            loss = self.loss(batch, draws)
            grads = (named_grads(self.params.items(), loss) if sh is None
                     else sh.grads(loss, self.params))
        loss = loss.detach()
        if sh is not None:
            loss = _data_mean(sh.mesh, loss)
        out = {"loss": loss, **self.update(grads)}
        self.step += 1
        if return_grads:
            out["grads"] = grads
        return out


class TrainStep(StepLoop):
    """``step(batch, seed, draws=None) -> {"loss", "grad_norm"}``: one train
    step of ``model``, updating its parameters through ``optimizer``.

    batch: ``latents`` (B, L, C) VAE latents before ``scale_shift``;
    ``text`` (B, Lc, D) and ``text_mask`` (B, Lc) bool, or None (the MAE
    stage); ``uncond`` (1, Lc, D) and ``uncond_mask`` (1, Lc), the
    empty-prompt embedding for CFG dropout, or None.
    draws: ``noise`` (B, L, C), ``t`` (B,) int, ``cfg`` (B,) uniforms, and
    for an MAE model those of :meth:`MaskDiT.draw_mask`.
    dtype: the compute dtype (None or f32: f32; bf16: mixed precision).
    """

    def __init__(self, model: nn.Module, schedule: DDIMSchedule, optimizer: Optimizer,
                 scale: float = 1.0, shift: float = 0.0, snr_gamma: Optional[float] = None,
                 cfg_dropout: float = 0.1, train_frames: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        if schedule.prediction_type not in ("epsilon", "v_prediction"):
            raise NotImplementedError(schedule.prediction_type)
        self.model, self.schedule, self.optimizer = model, schedule, optimizer
        self.params = optimizer.params
        self.scale, self.shift = scale, shift
        self.snr_gamma, self.cfg_dropout = snr_gamma, cfg_dropout
        self.train_frames = train_frames
        self.dtype = dtype if dtype is not None else torch.float32
        self.step = 0

    def draw(self, generator: torch.Generator, B: int, L: int, C: int, device) -> dict:
        d = dict(noise=torch.randn(B, L, C, generator=generator, device=device),
                 t=torch.randint(0, self.schedule.num_train_timesteps, (B,),
                                 generator=generator, device=device),
                 cfg=torch.rand(B, generator=generator, device=device))
        if self.model.mae:
            d.update(self.model.draw_mask(generator, B, L, device))
        return d

    def draw_for(self, generator: torch.Generator, batch: dict,
                 rows: Optional[int] = None) -> dict:
        """The draws of ``batch``, or of ``rows`` rows of its shape."""
        B, L, C = self._latents(batch).shape
        return self.draw(generator, rows or B, L, C, batch["latents"].device)

    def _latents(self, batch):
        latents = scale_shift(batch["latents"].to(self.dtype), self.scale, self.shift)
        return latents[:, :self.train_frames] if self.train_frames is not None else latents

    def loss(self, batch: dict, draws: dict) -> torch.Tensor:
        latents = self._latents(batch)
        text, text_mask = batch.get("text"), batch.get("text_mask")
        if text is not None and self.cfg_dropout > 0 and batch.get("uncond") is not None:
            drop = draws["cfg"] < self.cfg_dropout
            text = torch.where(drop[:, None, None], batch["uncond"], text)
            text_mask = torch.where(drop[:, None], batch["uncond_mask"], text_mask)
        t = draws["t"]
        noisy, target = noised(self.schedule, latents, draws["noise"].to(latents.dtype), t)
        pred, mask = self.model(noisy, t, text, context_mask=text_mask, gt=latents,
                                mask_draws=draws)
        return masked_diffusion_loss(pred, target, mask, self.schedule, t, self.snr_gamma)


def make_train_step(model, schedule, optimizer, scale=1.0, shift=0.0, snr_gamma=None,
                    cfg_dropout=0.1, train_frames=None, dtype=None) -> TrainStep:
    return TrainStep(model, schedule, optimizer, scale, shift, snr_gamma, cfg_dropout,
                     train_frames, dtype)


def all_steps(ckpt_dir: str) -> list:
    """The steps with a complete checkpoint under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.exists(os.path.join(ckpt_dir, n, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _write(ckpt_dir: str, step: int, state: dict) -> None:
    """Write into a temporary directory, rename it to ``<step>``, prune."""
    final = os.path.join(ckpt_dir, str(step))
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, final)
    for old in all_steps(ckpt_dir)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


@dataclasses.dataclass
class Trainer:
    """The train step, the optimizer and the checkpoints of one model."""

    model: nn.Module
    schedule: DDIMSchedule
    optimizer: Optimizer
    step_fn: TrainStep
    _writer: Optional[threading.Thread] = None
    _write_error: Optional[Exception] = None

    sharding: object = None  # parallel.sharding.ShardedParams on a mesh

    @classmethod
    def create(cls, model, schedule, opt_cfg: dict, scale=1.0, shift=0.0,
               train_frames=None, cfg_dropout=0.1, dtype=None, mesh=None,
               placements=None) -> "Trainer":
        """The trainer of ``model``; with ``mesh`` the model is placed on
        it first (``placements``, default ``dit_param_shardings``) and the
        optimizer built over the shards (FSDP2 gathering in ``dtype``)."""
        sharding = None
        if mesh is not None:
            from ezaudio_tpu_torch.parallel.mesh import check_mesh
            from ezaudio_tpu_torch.parallel.sharding import shard_dit, shard_params

            check_mesh(mesh)
            sharding = (shard_dit(mesh, model, dtype) if placements is None
                        else shard_params(mesh, model, placements, dtype))
        optimizer = make_optimizer(
            model,
            learning_rate=opt_cfg.get("learning_rate", 5e-5),
            beta1=opt_cfg.get("beta1", 0.9),
            beta2=opt_cfg.get("beta2", 0.999),
            weight_decay=opt_cfg.get("weight_decay", 0.01),
            adam_epsilon=opt_cfg.get("adam_epsilon", 1e-8),
            warmup=opt_cfg.get("warmup", 5000),
            grad_clip=opt_cfg.get("grad_clip", 1.0),
            accumulation_steps=opt_cfg.get("accumulation_steps", 1),
            optimizer=opt_cfg.get("optimizer", "adamw"),
            mu_dtype=opt_cfg.get("mu_dtype"),
            factor_min_dim=opt_cfg.get("factor_min_dim", 128),
        )
        step_fn = make_train_step(model, schedule, optimizer, scale=scale, shift=shift,
                                  snr_gamma=opt_cfg.get("snr_gamma"),
                                  cfg_dropout=cfg_dropout, train_frames=train_frames,
                                  dtype=dtype)
        step_fn.sharding = optimizer.sharding = sharding
        return cls(model=model, schedule=schedule, optimizer=optimizer, step_fn=step_fn,
                   sharding=sharding)

    @property
    def step(self) -> int:
        return self.step_fn.step

    def train_step(self, batch: dict, seed: int, local: bool = False) -> dict:
        return self.step_fn(batch, seed, local=local)

    def close(self) -> None:
        """Join the checkpoint write in flight, if any; raise if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise RuntimeError("an asynchronous checkpoint write failed") from err

    def _write_in_thread(self, ckpt_dir: str, step: int, state: dict) -> None:
        try:
            _write(ckpt_dir, step, state)
        except Exception as e:  # the thread's boundary: close() re-raises it
            self._write_error = e

    def save_checkpoint(self, ckpt_dir: str, step: Optional[int] = None, block: bool = True,
                        skip_existing: bool = False) -> None:
        """Save the model, the optimizer and the step.  ``block=False``
        returns once the state is copied to the host; the write goes on in
        a thread.  ``skip_existing`` returns (after joining a write in
        flight) where this step is saved already, instead of raising."""
        step = int(step if step is not None else self.step)
        self.close()
        exists = _agree(self.sharding, step in all_steps(ckpt_dir))
        if exists:
            if skip_existing:
                return
            raise FileExistsError(f"{ckpt_dir}: step {step} is saved already")
        # on a mesh every rank gathers the whole (single-device layout) state
        model_sd = (self.model.state_dict() if self.sharding is None
                    else self.sharding.full_state_dict())
        state = {"model": _to_host(model_sd),
                 "optimizer": _to_host(self.optimizer.state_dict()), "step": step}
        if self.sharding is not None and _rank() != 0:
            if block:
                _barrier()
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        if block:
            _write(ckpt_dir, step, state)
            if self.sharding is not None:
                _barrier()
        else:
            self._writer = threading.Thread(target=self._write_in_thread,
                                            args=(ckpt_dir, step, state))
            self._writer.start()

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None) -> "Trainer":
        self.close()
        step = _agree(self.sharding, step if step is not None else latest_step(ckpt_dir))
        if step is None:
            raise FileNotFoundError(f"{ckpt_dir}: no checkpoint")
        state = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu",
                           weights_only=True)
        if self.sharding is None:
            self.model.load_state_dict(state["model"])
        else:
            self.sharding.load_full_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_fn.step = int(state["step"])
        return self


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _agree(sharding, value):
    """Rank 0's ``value`` on every rank of a sharded trainer."""
    if sharding is None:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a flag the training loop reads at the next
    step boundary, so the run checkpoints and exits cleanly; with the
    CLI's auto-resume, preempt -> save -> restart -> resume loses no
    optimizer state.  A second signal while handling the first falls back
    to the original handler.

    Usage::

        with PreemptionGuard() as guard:
            for batch in data:
                train_step(batch)
                if guard.preempted:
                    trainer.save_checkpoint(dir, step)
                    break
    """

    def __init__(self, signals=None):
        self.signals = tuple(signals) if signals else (signal.SIGTERM, signal.SIGINT)
        self.preempted = False
        self._prev: dict = {}

    def _handler(self, signum, frame):
        self.preempted = True
        for sig, prev in self._prev.items():  # a repeat signal acts as usual
            signal.signal(sig, prev)

    def __enter__(self) -> "PreemptionGuard":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> bool:
        for sig, prev in self._prev.items():
            if signal.getsignal(sig) == self._handler:
                signal.signal(sig, prev)
        self._prev.clear()
        return False

