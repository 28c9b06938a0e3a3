"""A traced window with ``torch.profiler`` and its reduction: the union of
the device's kernel intervals (busy time), device time by kernel name,
the top device operations, and the idle gaps by the CUDA call the host
was in.

Only the device's activity is traced (kernels, copies and the CUDA
runtime calls that launch them): recording every host operator as well
stretched a traced s3_xl call from 9.6 s to 15-17 s, which would read the
profiler's own cost as idle device time."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


HOST_CODE = "(no CUDA call: host code)"


class TraceSummary:
    """What the per-layer readers read of a traced window."""

    def __init__(self, window_s: float, busy_s: float, kernels: Dict[str, float],
                 device_ops: List[list], idle_gaps: List[list]):
        self.window_s, self.busy_s = window_s, busy_s
        self.kernels = kernels          # device seconds by kernel name
        self.device_ops, self.idle_gaps = device_ops, idle_gaps

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds ``fragment``."""
        return sum(t for name, t in self.kernels.items() if fragment in name)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce the profiler's events of a window of ``window_s`` seconds."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    kernels: Dict[str, float] = {}
    for s, t, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (t - s) * 1e-6
    busy = _merge([(s, t) for s, t, _ in dev])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    # the idle gaps between device intervals, named by the innermost CUDA
    # runtime call open at the gap's start (none open: the host is in Python)
    host.sort()
    gaps: Dict[str, float] = {}
    j = 0
    open_ranges: List[tuple] = []
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        while j < len(host) and host[j][0] <= e0:
            open_ranges.append(host[j])
            j += 1
        open_ranges = [h for h in open_ranges if h[1] >= e0]
        name = max(open_ranges, key=lambda h: h[0])[2] if open_ranges else HOST_CODE
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    ops = sorted(([n, t] for n, t in kernels.items()), key=lambda r: -r[1])[:top]
    idle = sorted(([n, t] for n, t in gaps.items()), key=lambda r: -r[1])[:top]
    return TraceSummary(window_s, busy_s, kernels, ops, idle)


class Tracer:
    """``with tracer.window(): ...`` profiles the device when enabled, and
    leaves a :class:`TraceSummary` in ``summary``."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        self.summary = summarize(prof.events(), window_s)
