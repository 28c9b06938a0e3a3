"""mfu_pct.t2a: model FLOPs of the traced window's completed calls (T5 and the
CFG-paired DiT calls, yardstick/flops.py) over the window and the peak of the
cell's dtype (989 TFLOP/s bf16, 495 TFLOP/s f32)."""

from yardstick.flops import PEAK_FLOPS


def read(run):
    if run.kind != "t2a_closed" or run.trace is None or not run.calls:
        return None
    work = sum(c["flops"] for c in run.calls)
    return 100.0 * work / run.trace.window_s / PEAK_FLOPS[run.traffic["dtype"]]
