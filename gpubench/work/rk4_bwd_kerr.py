"""rk4_bwd (K3) on a Kerr hole: the RK4 adjoint, each segment recomputed
from its checkpoint onto a tape and swept backwards, its work counted on
the Kerr reference (``_kerr.replay``)."""

from ._common import adjoint_ops, segment, tables

KERNEL = "rk4_bwd_kernel"


def work(rep):
    """Every live ray-step again and its adjoint; the checkpoints (32 bytes
    a ray and segment) read, 28 bytes a ray of energy and cotangents in,
    28 out, and the tables twice."""
    n_seg = -(-rep.n_steps // segment(rep.n_steps))
    nbytes = 32 * n_seg * rep.rays + 56 * rep.rays + 2 * tables(rep)
    return adjoint_ops(rep), nbytes
