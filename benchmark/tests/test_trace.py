"""The reduction of a traced window: busy time as the union of the device's
intervals, device time by kernel name, idle gaps by the CUDA call open."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from yardstick import trace


def _event(name, start_us, end_us, device):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start_us, end=end_us),
                           device_type=device)


def test_busy_is_the_union_and_gaps_are_named():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_event("gemm", 0, 100, cuda), _event("gemm", 50, 150, cuda),  # overlapping
              _event("attn_fwd", 300, 400, cuda), _event("norm", 1000, 1100, cuda),
              _event("cudaStreamSynchronize", 140, 320, cpu)]
    s = trace.summarize(events, window_s=2e-3)
    assert s.busy_s == pytest.approx(350e-6)
    assert s.kernels["gemm"] == pytest.approx(200e-6)
    assert s.kernel_seconds("attn") == pytest.approx(100e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(150e-6)
    assert gaps[trace.HOST_CODE] == pytest.approx(600e-6)
    assert s.device_ops[0] == ["gemm", pytest.approx(200e-6)]


def test_disabled_tracer_leaves_no_summary():
    t = trace.Tracer(False, cuda=False)
    with t.window():
        pass
    assert t.summary is None
