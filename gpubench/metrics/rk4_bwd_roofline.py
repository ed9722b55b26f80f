"""rk4_bwd's share of its roofline, percent: the least time its work on the
traced rays needs at the card's peaks over its traced device time."""

from gpubench.work import rk4_bwd


def read(rec):
    return rec.roofline(rk4_bwd)
