"""rk4_ckpt (K2) on a Kerr hole: the RK4 forward of the gradient path,
writing a checkpoint before every segment of steps, its work counted on
the Kerr reference (``_kerr.replay``)."""

from ._common import forward_ops, segment, tables

KERNEL = "rk4_ckpt_kernel"


def work(rep):
    """Every live ray-step; 40 bytes a ray of state read (x, p, E, lam,
    status, hit_obj), 36 written (x, p, lam, status, hit_obj), the
    checkpoints (32 bytes a ray and segment) and the live-segment byte
    written, and the tables."""
    n_seg = -(-rep.n_steps // segment(rep.n_steps))
    nbytes = 32 * n_seg * rep.rays + 77 * rep.rays + tables(rep)
    return forward_ops(rep), nbytes
