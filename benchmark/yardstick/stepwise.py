"""The step-wise check of a sampled clip: the reference follows the
program step by step from the program's own state.

Over 100 sampler steps at CFG 5, a bf16 program and the f32
reference drift apart whatever their precision: the clips of the bf16
program and of an fp8 control both end a third to a half of their norm
away from the f32 reference's (an H100 at s3_xl's size).  So for a bf16 cell the
check reads the program's state at every stage of one call and
the reference recomputes each stage from it:

  * ``noise_gap``: the program's starting latents against the reference's
    draw from the call's seed;
  * ``text_gap``: each T5 block's output against the reference's block on
    the program's input to it, the token embedding and the final norm
    likewise (random-weight T5 attends almost one-hot without a score
    scale, so a bf16 T5 and the f32 one part by half of their norm over
    24 layers, and a whole-tower comparison cannot tell bf16 from fp8);
    so for the call's prompts, and so for the empty prompt's pass that
    the program caches as the CFG uncond branch (read in the warm-up
    call, which makes it), whose output has to be the uncond half of the
    probed call's DiT context;
  * ``step_gap``: the guided prediction of sampled steps against the
    reference's on the program's latents and T5 context;
  * ``update_gap``: each next latent against the reference's sampler
    update from the program's latent and guided prediction;
  * ``decode_gap``: the clip delivered against the reference's decode of
    the latents the program decoded.

Each is a relative L2 gap, the worst over the rows and steps compared.
``Probe`` records these states for one ``generate_audio`` call: device
copies of the sampled rows at each DiT call and each decode chunk.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from yardstick import reference as ref

NUMBERS = ("noise_gap", "text_gap", "step_gap", "update_gap", "decode_gap")


class T5Probe:
    """Wraps a T5 encoder's blocks and final norm; while ``rows`` is set it
    keeps the rows' input and output of each, pass after pass."""

    def __init__(self, t5):
        self.rows = None
        self.io: List[tuple] = []
        self.n = len(t5.block) + 1
        for blk in t5.block:
            blk.forward = self._wrap(blk.forward, lambda out: out[0])
        t5.final_layer_norm.forward = self._wrap(t5.final_layer_norm.forward, lambda out: out)

    def _wrap(self, fn, first):
        def wrapped(x, *a, **kw):
            out = fn(x, *a, **kw)
            if self.rows is not None:
                self.io.append((x[self.rows].clone(), first(out)[self.rows].clone()))
            return out
        return wrapped

    def take(self) -> List[List[tuple]]:
        """The recorded passes, each its blocks' and final norm's ``(input, output)``."""
        io, self.io = [(a.float(), b.float()) for a, b in self.io], []
        return [io[i:i + self.n] for i in range(0, len(io), self.n)]


@torch.no_grad()
def text_gap(pipe, io: List[tuple], texts, control=None) -> float:
    """The worst T5 stage of a recorded pass (``io``: each block's and the
    final norm's input and output): the embedding of the tokens, each
    block, the final norm, each from the program's input to it.  With
    ``control`` (the reference in fp8) the control's gap on the same inputs."""
    t5 = pipe.t5
    dev = io[0][0].device
    ids, mask = pipe.tokens(list(texts), dev)
    bias = t5.bias(mask, ids.shape[1])
    other = control.t5 if control is not None else None
    if other is None:
        gaps = [gap(io[0][0], t5.embed_tokens(ids))]
        gaps += [gap(out, t5.block_forward(i, x, bias)) for i, (x, out) in enumerate(io[:-1])]
        gaps.append(gap(io[-1][1], t5.final_layer_norm(io[-1][0])))
        return max(gaps)
    gaps = [gap(other.block_forward(i, x, bias), t5.block_forward(i, x, bias))
            for i, (x, _) in enumerate(io[:-1])]
    gaps.append(gap(other.final_layer_norm(io[-1][0]), t5.final_layer_norm(io[-1][0])))
    return max(gaps)


def _text_gaps(pipe, rec: dict, texts, dev, control=None) -> float:
    """:func:`text_gap` of the prompts' pass and of the empty prompt's."""
    on = lambda io: [(a.to(dev), b.to(dev)) for a, b in io]  # noqa: E731
    return max(text_gap(pipe, on(rec["t5"]), texts, control),
               text_gap(pipe, on(rec["t5_uncond"]), [""] * len(texts), control))


def gap(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class Probe:
    """Wraps an ``EzAudio``'s DiT and decode; while :meth:`on` is active it
    keeps the sampled rows of every call's inputs and outputs."""

    def __init__(self, ez):
        self.ez = ez
        self.t5 = T5Probe(ez.t5)
        self.rows: Optional[torch.Tensor] = None
        self.calls: List[dict] = []
        self.decodes: List[tuple] = []
        self.context = self.uncond_t5 = None
        dit_forward, decode = ez.dit.forward, ez.autoencoder.decode

        def forward(x, timesteps, context=None, *a, **kw):
            out = dit_forward(x, timesteps, context, *a, **kw)
            if self.rows is not None:
                y = out[0][0] if kw.get("collect_deep_k") is not None else out[0]
                half = x.shape[0] // 2
                self.calls.append(dict(x=x[self.rows].clone(), cond=y[self.rows].clone(),
                                       uncond=y[self.rows + half].clone()))
                if self.context is None:
                    self.context = torch.cat([context[self.rows], context[self.rows + half]])
            return out

        def decode_rec(z, *a, **kw):
            out = decode(z, *a, **kw)
            if self.rows is not None:
                self.decodes.append((z.clone(), out.clone()))
            return out

        ez.dit.forward = forward
        ez.autoencoder.decode = decode_rec

    @contextlib.contextmanager
    def on(self, rows):
        """Record the rows ``rows`` of the calls made inside."""
        self.calls, self.decodes, self.context = [], [], None
        self.rows = self.t5.rows = torch.as_tensor(rows, device=self.ez.device)
        try:
            yield
        finally:
            self.taken, self.rows, self.t5.rows = self.rows, None, None

    @contextlib.contextmanager
    def uncond(self, rows):
        """Record T5's passes of the call made inside (the first, which makes
        and caches the empty prompt's embedding after the prompts' own):
        the last pass is kept as the uncond one."""
        self.t5.rows = torch.as_tensor(rows, device=self.ez.device)
        try:
            yield
        finally:
            self.t5.rows = None
            self.uncond_t5 = self.t5.take()[-1]

    def record(self, delivered) -> dict:
        """What the last probed call kept: ``x`` (steps, R, L, C), ``cond``
        and ``uncond`` outputs, the ``context`` (cond rows, then uncond rows),
        the ``t5`` pass of its prompts and ``t5_uncond`` (:meth:`uncond`),
        the decoded ``latents``; ``delivered`` is the rows' clips as the
        caller received them."""
        z = torch.cat([d[0] for d in self.decodes])[self.taken]
        return dict(t5=self.t5.take()[0], t5_uncond=self.uncond_t5, x=torch.stack([c["x"] for c in self.calls]).float(),
                    cond=torch.stack([c["cond"] for c in self.calls]).float(),
                    uncond=torch.stack([c["uncond"] for c in self.calls]).float(),
                    context=self.context.float(), latents=z.float(),
                    waveform=torch.as_tensor(np.asarray(delivered)).float())


def _guided(recipe, cond, uncond):
    """The guided prediction of each step from its (R, L, C) outputs."""
    return torch.stack([ref.guided(torch.cat([c, u]), recipe["guidance_scale"],
                                   recipe["guidance_rescale"]) for c, u in zip(cond, uncond)])


class Follower:
    """The reference (``pipe``) following a recorded DDIM call step by step.
    ``texts`` and ``noise`` are the rows' prompts and starting latents as
    the reference draws them; ``step_noise[i]`` the rows' eta noise;
    ``context`` the program's T5 context of the rows (cond, then uncond),
    on which the DiT steps are followed."""

    def __init__(self, pipe, recipe: dict, texts, noise, step_noise=None, context=None):
        if recipe["sampler"] != "ddim":
            raise NotImplementedError(f"step-wise check of {recipe['sampler']!r}")
        self.pipe, self.recipe, self.texts = pipe, recipe, list(texts)
        self.noise, self.step_noise = noise, step_noise
        dev = noise.device
        self.cmask = torch.cat([pipe.tokens(self.texts, dev)[1],
                                pipe.tokens([""] * len(self.texts), dev)[1]])
        self.ctx = context.to(dev)
        self.steps = recipe["steps"]
        self.ts = pipe.sched.timesteps(self.steps)
        self._pred = {}

    @torch.no_grad()
    def prediction(self, i: int, xs) -> torch.Tensor:
        """The guided prediction at step ``i`` from the recorded latents ``xs``."""
        if i not in self._pred:
            r, x = self.recipe, xs[i]
            out = self.pipe.dit(torch.cat([x, x]), int(self.ts[i]), self.ctx, self.cmask)
            self._pred[i] = ref.guided(out, r["guidance_scale"], r["guidance_rescale"])
        return self._pred[i]

    def update(self, i: int, xs, preds) -> torch.Tensor:
        """The sampler's step ``i`` from the recorded latents and predictions."""
        eta = self.recipe.get("eta", 0.0)
        noise = self.step_noise[i] if eta > 0 else None
        return ref.ddim_update(self.pipe.sched, self.steps, i, xs[i], preds[i], noise, eta)

    @torch.no_grad()
    def decode(self, latents) -> torch.Tensor:
        return self.pipe.vae.decode(latents)


def step_sample(rng: np.random.Generator, steps: int, n: int) -> List[int]:
    """``n`` steps: the first, the last and the rest drawn from ``rng``."""
    middle = rng.choice(np.arange(1, steps - 1), size=max(0, min(n, steps) - 2), replace=False)
    return sorted({0, steps - 1, *(int(i) for i in middle)})


def check(rec: dict, fol: Follower, sample: List[int],
          control: Optional[Follower] = None) -> Dict[str, float]:
    """The five gaps of the program's record against the follower; with
    ``control`` (the reference in fp8 put in the program's place, its
    carried latents rounded to fp8 as the program rounds them to its dtype)
    the control's five gaps instead, on the program's same states."""
    pipe, r = fol.pipe, fol.recipe
    dev = fol.noise.device
    xs = rec["x"].to(dev)
    preds = _guided(r, rec["cond"].to(dev), rec["uncond"].to(dev))
    with ref.math_mode("f32"):
        out = {}
        if control is None:
            out["noise_gap"] = gap(xs[0], fol.noise)
            out["text_gap"] = max(
                _text_gaps(pipe, rec, fol.texts, dev),
                gap(rec["context"][len(fol.texts):].to(dev), rec["t5_uncond"][-1][1].to(dev)))
            out["step_gap"] = max(gap(preds[i], fol.prediction(i, xs)) for i in sample)
            nxt = list(xs[1:]) + [(rec["latents"].to(dev) + pipe.shift) * pipe.scale]
            out["update_gap"] = max(gap(nxt[i], fol.update(i, xs, preds))
                                    for i in range(len(xs)))
            out["decode_gap"] = gap(rec["waveform"], fol.decode(rec["latents"].to(dev)))
        else:
            q = ref._fp8
            out["noise_gap"] = gap(q(fol.noise), fol.noise)
            out["text_gap"] = _text_gaps(pipe, rec, fol.texts, dev, control.pipe)
            out["step_gap"] = max(gap(control.prediction(i, xs), fol.prediction(i, xs))
                                  for i in sample)
            out["update_gap"] = max(gap(q(fol.update(i, xs, preds)), fol.update(i, xs, preds))
                                    for i in range(len(xs)))
            lat = rec["latents"].to(dev)
            out["decode_gap"] = gap(control.decode(lat), fol.decode(lat))
    return out
