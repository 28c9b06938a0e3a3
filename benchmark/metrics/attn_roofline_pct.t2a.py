"""attn_roofline_pct.t2a: kernel 1's share of its roofline at the cell's
shapes: the least time of its launches over its device time in the trace."""

from yardstick.readers import t2a_roofline_pct


def read(run):
    return t2a_roofline_pct(run, "attn_fwd")
