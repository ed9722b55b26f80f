"""rk4_bwd's share of its roofline on a Kerr hole, percent: the least time
its work on the traced rays, counted on the Kerr reference, needs at the
card's peaks over its traced device time."""

from gpubench.work import _kerr, rk4_bwd_kerr


def read(rec):
    return _kerr.roofline(rec, rk4_bwd_kerr)
