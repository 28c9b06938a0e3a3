"""One program as one CUDA graph: the port's counterpart of a ``jax.jit``
program that runs with a single device dispatch (``fused=True``).

:class:`GraphProgram` wraps a function of tensors that returns one tensor.
On CUDA its first call runs the function once eagerly (the warm-up: the
kernels' libraries load and set their attributes, cuBLAS and cuDNN choose
their algorithms, the DiT's caches fill), then captures it into a
``torch.cuda.CUDAGraph`` and replays that; every later call copies its
inputs into the captured ones and replays.  A failed capture raises.  On
the CPU, which has no graphs, the same function runs eagerly on every call.

The hand-written kernels count their launches in Python, which a replay
does not reach: the capture records the launches it saw (``launches``,
and by dtype ``launches_by_dtype``), and ``replays`` counts the replays,
so a replay's launches are ``launches[k] * replays``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

_KERNELS = {"attention": fused_attention, "resunit": fused_residual_unit}


def kernel_launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in _KERNELS.items()}


def kernel_launches_by_dtype() -> Dict[str, int]:
    """``{"<kernel>.<dtype>": launches}``, e.g. ``"attention.bfloat16"``."""
    return {f"{k}.{dt}": n for k, fn in _KERNELS.items()
            for dt, n in fn.launches_by_dtype.items()}


class GraphProgram:
    """``fn(*inputs) -> tensor`` as a CUDA graph on CUDA, eagerly elsewhere.

    ``inputs`` are tensors of fixed shapes (or None, the same on every
    call).  The output of a replay is the graph's own tensor: read it
    before the next replay of any graph that shares ``pool``.  Capture runs
    in ``thread_local`` error mode, so CUDA work of other threads cannot
    invalidate it.
    """

    def __init__(self, fn: Callable, device: torch.device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._inputs, self._output = None, None
        self.launches: Dict[str, int] = {}
        self.launches_by_dtype: Dict[str, int] = {}
        self.replays = 0
        self.timings: Dict[str, float] = {}

    def __call__(self, *inputs):
        if self.device.type != "cuda":
            return self.fn(*inputs)
        if self.graph is None:
            return self._capture(inputs)
        for dst, src in zip(self._inputs, inputs):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        return self._output

    def _capture(self, inputs):
        t0 = time.perf_counter()
        self.fn(*inputs)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        # the graph's inputs live outside its pool, owned by this program
        static = [None if x is None else x.clone() for x in inputs]
        before, before_dt = kernel_launches(), kernel_launches_by_dtype()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            t2 = time.perf_counter()
            out = self.fn(*static)
            t3 = time.perf_counter()
        t4 = time.perf_counter()
        self.launches = {k: n - before[k] for k, n in kernel_launches().items()}
        self.launches_by_dtype = {k: n - before_dt.get(k, 0)
                                  for k, n in kernel_launches_by_dtype().items()
                                  if n != before_dt.get(k, 0)}
        self.graph, self._inputs, self._output = graph, static, out
        graph.replay()
        self.replays += 1
        torch.cuda.synchronize(self.device)
        self.timings = dict(warmup_s=t1 - t0, capture_s=t3 - t2, instantiate_s=t4 - t3,
                            first_replay_s=time.perf_counter() - t4)
        return out
