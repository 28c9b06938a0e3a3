"""device_idle_pct.t2a: share of the traced window in which no kernel ran
(the window less the union of the kernels' intervals)."""

from yardstick.readers import idle_pct


def read(run):
    return idle_pct(run, "t2a_closed")
