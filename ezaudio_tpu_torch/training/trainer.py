"""The diffusion train step, the trainer and its checkpoints (counterpart
of ``ezaudio_tpu/training/trainer.py``).

One step, as the JAX package's jitted step (reference src/train.py:262-313):
latents into model space (``scale_shift``), optional crop to
``train_frames``, CFG dropout to the uncond embedding, noise and a uniform
timestep, the epsilon or v target, MaskDiT with span-masked MAE, the masked
(min-SNR) MSE, the gradients, and the optimizer (``optim.py``: clip,
warmup AdamW, accumulation).  Quantization is forced off for the step, as
``quant_context('off')`` does in the JAX package: int8 ``round`` has no
gradient.

Every draw of step ``n`` comes from a ``torch.Generator`` seeded from
``(seed, n)`` alone (``jax.random.fold_in``'s role), so a resumed run draws
what the uninterrupted run drew.  torch cannot reproduce JAX's draws
(ROADMAP F1): ``draws=`` takes them from the caller instead.

Checkpoints are the port's own format: ``torch.save`` of the model's state
dict, the optimizer's state and the step into ``<dir>/<step>/state.pt``,
the newest ``MAX_TO_KEEP`` kept.  ``block=False`` copies the state to the
host and writes it from a thread; ``close()`` joins the thread and raises
if the write failed.
"""

from __future__ import annotations

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
from ezaudio_tpu_torch.training.optim import AdamW, global_norm, make_optimizer, named_grads
from ezaudio_tpu_torch.utils import scale_shift

MAX_TO_KEEP = 5
STATE_FILE = "state.pt"


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed that depends on ``(seed, step)`` alone."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


class TrainStep:
    """``step(batch, seed, draws=None) -> {"loss", "grad_norm"}``: one train
    step of ``model``, updating its parameters through ``optimizer``.

    batch: ``latents`` (B, L, C) VAE latents before ``scale_shift``;
    ``text`` (B, Lc, D) and ``text_mask`` (B, Lc) bool, or None (the MAE
    stage); ``uncond`` (1, Lc, D) and ``uncond_mask`` (1, Lc), the
    empty-prompt embedding for CFG dropout, or None.
    draws: ``noise`` (B, L, C), ``t`` (B,) int, ``cfg`` (B,) uniforms, and
    for an MAE model those of :meth:`MaskDiT.draw_mask`.
    """

    def __init__(self, model: nn.Module, schedule: DDIMSchedule, optimizer: AdamW,
                 scale: float = 1.0, shift: float = 0.0, snr_gamma: Optional[float] = None,
                 cfg_dropout: float = 0.1, train_frames: Optional[int] = None):
        if schedule.prediction_type not in ("epsilon", "v_prediction"):
            raise NotImplementedError(schedule.prediction_type)
        self.model, self.schedule, self.optimizer = model, schedule, optimizer
        self.scale, self.shift = scale, shift
        self.snr_gamma, self.cfg_dropout = snr_gamma, cfg_dropout
        self.train_frames = train_frames
        self.step = 0

    def draw(self, generator: torch.Generator, B: int, L: int, C: int, device) -> dict:
        d = dict(noise=torch.randn(B, L, C, generator=generator, device=device),
                 t=torch.randint(0, self.schedule.num_train_timesteps, (B,),
                                 generator=generator, device=device),
                 cfg=torch.rand(B, generator=generator, device=device))
        if self.model.mae:
            d.update(self.model.draw_mask(generator, B, L, device))
        return d

    def _latents(self, batch):
        latents = scale_shift(batch["latents"].float(), self.scale, self.shift)
        return latents[:, :self.train_frames] if self.train_frames is not None else latents

    def loss(self, batch: dict, draws: dict) -> torch.Tensor:
        latents = self._latents(batch)
        text, text_mask = batch.get("text"), batch.get("text_mask")
        if text is not None and self.cfg_dropout > 0 and batch.get("uncond") is not None:
            drop = draws["cfg"] < self.cfg_dropout
            text = torch.where(drop[:, None, None], batch["uncond"], text)
            text_mask = torch.where(drop[:, None], batch["uncond_mask"], text_mask)
        noise, t = draws["noise"], draws["t"]
        noisy = self.schedule.add_noise(latents, noise, t)
        target = (noise if self.schedule.prediction_type == "epsilon"
                  else self.schedule.get_velocity(latents, noise, t))
        pred, mask = self.model(noisy, t, text, context_mask=text_mask, gt=latents,
                                mask_draws=draws)
        return masked_diffusion_loss(pred, target, mask, self.schedule, t, self.snr_gamma)

    def __call__(self, batch: dict, seed: int, draws: Optional[dict] = None,
                 return_grads: bool = False) -> dict:
        """The loss and the global norm of the step's gradients (before the
        clip) as device scalars; with ``return_grads`` the gradients too."""
        if draws is None:
            latents = self._latents(batch)
            gen = torch.Generator(device=latents.device).manual_seed(step_seed(seed, self.step))
            draws = self.draw(gen, *latents.shape, latents.device)
        with quant_context("off"):
            loss = self.loss(batch, draws)
            grads = named_grads(self.optimizer.params.items(), loss)
        gnorm = global_norm(grads.values())
        self.optimizer.update(grads, gnorm)
        self.step += 1
        out = {"loss": loss.detach(), "grad_norm": gnorm}
        if return_grads:
            out["grads"] = grads
        return out


def make_train_step(model, schedule, optimizer, scale=1.0, shift=0.0, snr_gamma=None,
                    cfg_dropout=0.1, train_frames=None) -> TrainStep:
    return TrainStep(model, schedule, optimizer, scale, shift, snr_gamma, cfg_dropout,
                     train_frames)


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
    optimizer: AdamW
    step_fn: TrainStep
    _writer: Optional[threading.Thread] = None
    _write_error: Optional[Exception] = None

    @classmethod
    def create(cls, model, schedule, opt_cfg: dict, scale=1.0, shift=0.0,
               train_frames=None, cfg_dropout=0.1) -> "Trainer":
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
        )
        step_fn = make_train_step(model, schedule, optimizer, scale=scale, shift=shift,
                                  snr_gamma=opt_cfg.get("snr_gamma"),
                                  cfg_dropout=cfg_dropout, train_frames=train_frames)
        return cls(model=model, schedule=schedule, optimizer=optimizer, step_fn=step_fn)

    @property
    def step(self) -> int:
        return self.step_fn.step

    def train_step(self, batch: dict, seed: int) -> dict:
        return self.step_fn(batch, seed)

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
        if step in all_steps(ckpt_dir):
            if skip_existing:
                return
            raise FileExistsError(f"{ckpt_dir}: step {step} is saved already")
        state = {"model": _to_host(self.model.state_dict()),
                 "optimizer": _to_host(self.optimizer.state_dict()), "step": step}
        os.makedirs(ckpt_dir, exist_ok=True)
        if block:
            _write(ckpt_dir, step, state)
        else:
            self._writer = threading.Thread(target=self._write_in_thread,
                                            args=(ckpt_dir, step, state))
            self._writer.start()

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None) -> "Trainer":
        self.close()
        step = step if step is not None else latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"{ckpt_dir}: no checkpoint")
        state = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu",
                           weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_fn.step = int(state["step"])
        return self


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

