"""What the metric readers share: idle and roofline shares."""

from __future__ import annotations

from typing import Optional

from yardstick import flops


def idle_pct(run, kind: str) -> Optional[float]:
    if run.kind != kind or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def t2a_roofline_pct(run, kernel: str) -> Optional[float]:
    """The share of the kernel's roofline over the traced window's calls:
    the least time of the launches the calls make, over the device time of
    the kernel; None where the launch counter disagrees with the calls."""
    if run.kind != "t2a_closed" or run.trace is None or not run.calls:
        return None
    tr, cfg = run.traffic, run.config
    dtype, B, secs = tr["dtype"], tr["batch"], float(tr["seconds"])
    if kernel == "attn_fwd":
        per_call = flops.dit_attention_launches(cfg, 2 * B, secs, dtype) * tr["recipe"]["steps"]
        counted = run.counters["launches"]["attention"].get(dtype, 0)
    else:
        per_call = flops.decode_resunit_launches(cfg, B, secs, dtype)
        counted = run.counters["launches"]["resunit"].get(dtype, 0)
    n = len(run.calls)
    seconds = run.trace.kernel_seconds(kernel)
    if counted != n * len(per_call) or seconds <= 0:
        return None
    return 100.0 * n * flops.bound_seconds(per_call, dtype) / seconds
