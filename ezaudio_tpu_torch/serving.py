"""Micro-batching generation server (counterpart of
``ezaudio_tpu/serving.py::GenerationServer``).

A blocking ``generate_audio`` call per user wastes the card: one prompt
keeps it partly idle while a batch of four costs little more per call.  The
server aggregates concurrent requests into batches:

  * requests enter a queue; a worker thread drains up to
    ``max_batch_size`` requests, waiting at most ``max_wait_ms`` for the
    batch to fill;
  * batches are padded to a fixed set of bucket sizes (``max_batch_size``
    always among them), pad slots repeating real prompts, so every call
    reuses a fused program (one CUDA graph per signature with
    ``fused=True``);
  * each request may carry its own ``length``: requests are grouped by
    length bucket (``length_buckets``, rounded up), one ``generate_audio``
    call per group, and the waveform is trimmed back to the requested
    length;
  * editing requests (``submit_edit``) and ControlNet requests
    (``submit_controlnet``, with ``controlnet=`` an ``EzAudioControlNet``
    sharing the server's EzAudio) ride the same queue and are served one
    by one (both APIs are single-clip);
  * best-of-K requests (``submit_reranked``, with ``clap_scorer=`` a
    ``CLAPScorer``) are served one by one through the same queue: the K
    candidates of one request already fill a batch;
  * each request carries its own seed: its slot's starting noise is the
    draw a solo ``generate_audio(random_seed=seed)`` makes, so a (text,
    seed, length bucket) triple reproduces across batch compositions under
    a deterministic sampler.  Results come back through futures.

On a mesh (``EzAudio(mesh=)``, one process per GPU, every rank running
a server and submitting the same requests in the same order) the batch
sizes are multiples of the data-parallel world, as the JAX server's are,
and rank 0's drain decides each batch for every rank (a broadcast of its
size), so all ranks make the same calls; unseeded requests draw their
seeds from a generator rank 0 seeds.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ezaudio_tpu_torch import utils


@dataclass
class _Request:
    text: str
    seed: int
    kind: str = "generate"            # "generate" | "edit" | "controlnet" | "rerank"
    length: Optional[float] = None    # requested seconds (generate, rerank)
    bucket: Optional[float] = None    # length bucket (generate)
    edit_kwargs: Optional[dict] = None
    future: Future = field(default_factory=Future)


def _new_seed(seed: Optional[int]) -> int:
    return int(seed if seed is not None else np.random.randint(0, 2**31 - 1))


PG_JOIN_SECONDS = 120  # a mesh server's wait for rank 0 to stop


class GenerationServer:
    def __init__(
        self,
        ez,  # EzAudio-like: generate_audio(list[str], ...) -> (sr, (B, T))
        max_batch_size: int = 8,
        max_wait_ms: float = 50.0,
        batch_buckets: Optional[Sequence[int]] = None,
        length: float = 10.0,
        length_buckets: Optional[Sequence[float]] = None,
        ddim_steps: int = 100,
        guidance_scale: float = 5.0,
        guidance_rescale: float = 0.75,
        sampler: str = "ddim",
        guidance_interval: Optional[Tuple[float, float]] = None,
        quant: Optional[str] = None,
        layer_cache: Optional[Tuple[int, int]] = None,
        attn_impl: Optional[str] = None,
        cfg_refresh: int = 1,  # uncond every P-th in-band group (dpm)
        fused: bool = False,  # the whole pipeline as one CUDA graph
        controlnet=None,  # EzAudioControlNet(base=ez): shares ez's weights
        clap_scorer=None,  # CLAPScorer enabling submit_reranked
    ):
        if sampler == "distilled" and (layer_cache is not None
                                       or guidance_interval is not None):
            # fail at construction, not on the first drained batch
            raise ValueError(
                "sampler='distilled' does not compose with layer_cache or "
                "guidance_interval (guidance is folded into the student)")
        self.ez = ez
        self.controlnet = controlnet
        self.clap_scorer = clap_scorer
        self.max_wait = max_wait_ms / 1000.0
        # on a mesh, the batch sizes are multiples of the data-parallel world,
        # so a batch splits over the ranks without more padding
        world = getattr(ez, "_world", 1) or 1
        if world > 1:
            max_batch_size = -(-max_batch_size // world) * world
        self.max_batch_size = max_batch_size
        buckets = batch_buckets or [b for b in (1, 2, 4, 8, 16) if b <= max_batch_size]
        self.buckets = sorted({-(-b // world) * world for b in buckets}
                              | {max_batch_size})  # a bucket >= any drain
        # every rank of a mesh serves the same requests in the same batches:
        # rank 0's drain decides and the others follow (_drain)
        mesh = getattr(ez, "mesh", None)
        self._spmd = mesh is not None and mesh.size() > 1
        self._seeds = None  # a mesh draws unseeded requests' seeds alike on every rank
        if self._spmd:
            import torch.distributed as dist

            box = [int(np.random.randint(0, 2**31 - 1))]
            dist.broadcast_object_list(box, src=0)
            self._seeds = np.random.default_rng(box[0])
        self.default_length = float(length)
        # a request's length rounds UP to the nearest bucket; lengths above
        # every bucket run at their exact value (a program of their own)
        self.length_buckets = sorted(
            {float(b) for b in (length_buckets or [])} | {self.default_length})
        self.gen_kwargs = dict(ddim_steps=ddim_steps, guidance_scale=guidance_scale,
                               guidance_rescale=guidance_rescale, sampler=sampler,
                               guidance_interval=guidance_interval, quant=quant,
                               layer_cache=layer_cache, attn_impl=attn_impl,
                               cfg_refresh=cfg_refresh, fused=fused)
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "edit_requests": 0, "controlnet_requests": 0,
                      "rerank_requests": 0}

    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            # on a mesh the loop ends when rank 0's does
            self._thread.join(timeout=PG_JOIN_SECONDS if self._spmd else 30)
        # resolve still-queued requests so no waiter blocks forever
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.future.cancel()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    def _length_bucket(self, length: float) -> float:
        for b in self.length_buckets:
            if length <= b:
                return b
        return float(length)

    def _new_seed(self, seed: Optional[int]) -> int:
        if seed is None and self._seeds is not None:
            return int(self._seeds.integers(0, 2**31 - 1))
        return _new_seed(seed)

    def _enqueue(self, req: _Request) -> Future:
        if self._stop.is_set():
            raise RuntimeError("GenerationServer is stopped; requests submitted now "
                               "would never be processed")
        self.stats["requests"] += 1
        self._q.put(req)
        return req.future

    def submit(self, text: str, seed: Optional[int] = None,
               length: Optional[float] = None) -> Future:
        """Enqueue a generation request.  ``length`` (seconds) defaults to
        the server's; it rounds up to a length bucket and the result is
        trimmed back."""
        length = float(length if length is not None else self.default_length)
        return self._enqueue(_Request(text=text, seed=self._new_seed(seed), length=length,
                                      bucket=self._length_bucket(length)))

    def submit_edit(self, text: str, gt_file, boundary: float, mask_start: float,
                    mask_length: float, seed: Optional[int] = None, **kw) -> Future:
        """Enqueue an editing (inpaint/outpaint) request, served on its own
        through the same queue."""
        edit_kwargs = dict(gt_file=gt_file, boundary=boundary, mask_start=mask_start,
                           mask_length=mask_length, **kw)
        fut = self._enqueue(_Request(text=text, seed=self._new_seed(seed), kind="edit",
                                     edit_kwargs=edit_kwargs))
        self.stats["edit_requests"] += 1
        return fut

    def submit_controlnet(self, text: str, audio_path, seed: Optional[int] = None,
                          **kw) -> Future:
        """Enqueue a ControlNet-conditioned generation, served on its own
        through the same queue.  ``kw`` goes to
        ``EzAudioControlNet.generate_audio`` (``conditioning_scale``,
        ``surpass_noise`` ...); the server's ``quant``, ``sampler`` and
        ``ddim_steps`` apply unless ``kw`` overrides them."""
        if self.controlnet is None:
            raise ValueError("this GenerationServer was built without a controlnet=; "
                             "pass an EzAudioControlNet sharing the same base EzAudio")
        fut = self._enqueue(_Request(text=text, seed=self._new_seed(seed), kind="controlnet",
                                     edit_kwargs=dict(audio_path=audio_path, **kw)))
        self.stats["controlnet_requests"] += 1
        return fut

    def submit_reranked(self, text: str, n_candidates: int = 4, seed: Optional[int] = None,
                        length: Optional[float] = None, **kw) -> Future:
        """Enqueue a best-of-K generation (``EzAudio.generate_audio_reranked``
        scored by the server's ``clap_scorer``), served on its own.  ``kw``
        goes to that call (``text_ids`` when the scorer has no tokenizer);
        the server's recipe applies unless ``kw`` overrides it."""
        if self.clap_scorer is None:
            raise ValueError("this GenerationServer was built without a clap_scorer=; "
                             "pass a CLAPScorer (ezaudio_tpu_torch.audio.clap) to enable "
                             "submit_reranked")
        length = float(length if length is not None else self.default_length)
        fut = self._enqueue(_Request(text=text, seed=self._new_seed(seed), kind="rerank",
                                     length=length,
                                     edit_kwargs=dict(n_candidates=int(n_candidates), **kw)))
        self.stats["rerank_requests"] += 1
        return fut

    def generate(self, text: str, seed: Optional[int] = None,
                 timeout: Optional[float] = None,
                 length: Optional[float] = None) -> Tuple[int, np.ndarray]:
        return self.submit(text, seed, length=length).result(timeout)

    # ------------------------------------------------------------------
    def _slot_noise(self, seed: int, length: float) -> torch.Tensor:
        """(frames, latent_dim) starting noise of one slot: the first draw
        of ``torch.Generator(device).manual_seed(seed)``, as a solo
        ``generate_audio(random_seed=seed)`` makes it."""
        ez = self.ez
        frames = int(length * ez.latent_sr)
        gen = torch.Generator(device=ez.device).manual_seed(int(seed))
        return utils.randn((1, frames, ez.latent_dim), gen, ez.device,
                           getattr(ez, "dtype", torch.float32))[0]

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if n <= b)

    def _drain(self) -> List[_Request]:
        if self._spmd:
            return self._drain_agreed()
        return self._drain_local()

    def _drain_agreed(self) -> List[_Request]:
        """On a mesh: rank 0 drains as alone, then tells every rank how
        many requests the batch takes (-1: stop); the others take as many
        from their queues, which hold the same requests in the same order
        (every rank submits alike)."""
        import torch.distributed as dist

        rank0 = dist.get_rank() == 0
        batch = self._drain_local() if rank0 else []
        n = torch.tensor([-1 if rank0 and self._stop.is_set() and not batch else len(batch)],
                         device=self.ez.device)
        dist.broadcast(n, src=0)
        n = int(n.item())
        if n < 0:
            self._agreed_stop = True
            return []
        while not rank0 and len(batch) < n:
            batch.append(self._q.get())
        return batch

    def _drain_local(self) -> List[_Request]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        t0 = time.perf_counter()
        while len(batch) < self.max_batch_size:
            remaining = self.max_wait - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    # ------------------------------------------------------------------
    def _run_generate(self, bucket_len: float, group: List[_Request]):
        n = len(group)
        size = self._bucket(n)
        # pad slots repeat real prompts: an empty-string pad would turn CFG
        # off for the whole batch (generate_audio's empty-prompt rule)
        slots = [group[i % n] for i in range(size)]
        self.stats["batches"] += 1
        self.stats["padded_slots"] += size - n
        try:
            # each slot starts from its own request's seeded draw; the eta
            # noise of a DDIM step is shared and follows group[0].seed
            extra = {}
            if hasattr(self.ez, "latent_sr") and hasattr(self.ez, "latent_dim"):
                extra["initial_latents"] = torch.stack(
                    [self._slot_noise(r.seed, bucket_len) for r in slots])
            sr, wavs = self.ez.generate_audio(
                [r.text for r in slots], random_seed=group[0].seed, length=bucket_len,
                **extra, **self.gen_kwargs)
            for i, r in enumerate(group):
                wav = np.asarray(wavs[i])
                if r.length is not None and r.length < bucket_len:
                    wav = wav[: int(r.length * sr)]
                r.future.set_result((sr, wav))
        except Exception as e:  # every waiter of the group learns of it
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)

    def _run_edit(self, req: _Request):
        self.stats["batches"] += 1
        try:
            # only the knobs editing_audio takes (its own guidance defaults,
            # DDIM only)
            kw = {k: self.gen_kwargs[k]
                  for k in ("ddim_steps", "quant", "layer_cache", "attn_impl")}
            kw.update(req.edit_kwargs)
            sr, wav = self.ez.editing_audio(req.text, random_seed=req.seed, **kw)
            req.future.set_result((sr, np.asarray(wav)))
        except Exception as e:
            if not req.future.done():
                req.future.set_exception(e)

    def _run_controlnet(self, req: _Request):
        self.stats["batches"] += 1
        try:
            # the server's recipe knobs that the ControlNet API takes (it has
            # no fused program); the request's own kwargs win
            kw = {k: self.gen_kwargs[k] for k in ("quant", "sampler", "ddim_steps")
                  if self.gen_kwargs[k] is not None}
            kw.update(req.edit_kwargs)
            sr, wav = self.controlnet.generate_audio(req.text, random_seed=req.seed, **kw)
            req.future.set_result((sr, np.asarray(wav)))
        except Exception as e:
            if not req.future.done():
                req.future.set_exception(e)

    def _run_rerank(self, req: _Request):
        self.stats["batches"] += 1
        try:
            # the staged batched path: the fused program is not taken here,
            # as in the JAX server
            kw = {k: v for k, v in self.gen_kwargs.items() if k != "fused"}
            kw.update(req.edit_kwargs)
            sr, wav = self.ez.generate_audio_reranked(req.text, self.clap_scorer,
                                                      random_seed=req.seed,
                                                      length=req.length, **kw)
            req.future.set_result((sr, np.asarray(wav)))
        except Exception as e:
            if not req.future.done():
                req.future.set_exception(e)

    _agreed_stop = False

    def _running(self) -> bool:
        if self._spmd:  # every rank runs until rank 0 stops
            return not self._agreed_stop
        return not self._stop.is_set()

    def _loop(self):
        while self._running():
            batch = self._drain()
            groups = {}
            for r in batch:
                if r.kind == "edit":
                    self._run_edit(r)
                elif r.kind == "controlnet":
                    self._run_controlnet(r)
                elif r.kind == "rerank":
                    self._run_rerank(r)
                else:
                    groups.setdefault(r.bucket, []).append(r)
            for bucket_len, group in sorted(groups.items()):
                self._run_generate(bucket_len, group)
