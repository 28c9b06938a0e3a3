"""resunit_roofline_pct.t2a: kernel 2's share of its roofline in the decode:
the least time of its launches over its device time in the trace."""

from yardstick.readers import t2a_roofline_pct


def read(run):
    return t2a_roofline_pct(run, "resunit_fwd")
