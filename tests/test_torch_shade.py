"""The shading kernels' plain statement, ops/shade_adjoint.py, against the
port's plain path on the CPU: ``shade_forward`` against ``shade`` of
``final_direction``, and ``shade_vjp`` -- the hand-derived VJP that
csrc/shade_bwd.cu follows line for line -- against ``torch.autograd`` of
the same, carried back to the scene's leaves through ``shade_scene``'s
packing.  One case of the feature matrix each (tests/shade_cases.py):
Schwarzschild and Kerr, a sky or none, a plain disk or a beaming one of
either orbit direction, no spheres, four, or four and two lights whose
segments a sphere and the horizon shadow; every status, the sky's seam and
poles.

Tolerances, each with its reason: the colours agree to 2e-5 (float32
rounding: the kernel's statement multiplies by float32 1/pi where the
plain path divides by pi, and its Kerr velocity is the right-hand side's,
not ks_fields', a few ulp of the direction; near the sky's pole the
longitude turns on them by 1 / |(d_x, d_y)|, 200 on this suite's rays,
which read 1.1e-5; elsewhere 2e-6); the gradients to 2e-4 of each leaf's largest entry (the
VJPs are exact transposes; float32 rounding in the longer chains -- the
redshift, the normal's arctan -- reads up to about 1e-5 of it).  The
plain path's dense disk shader runs on the sky's pole rays too, where
x = y = 0 and its sqrt's derivative is infinite: autograd's zero cotangent
times it is NaN there, in x's cotangent.  Those reference entries are
compared to nothing; the VJP's must be finite everywhere.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu_torch.ops import shade_adjoint as sa  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.integrate import final_direction  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene.shading import (  # noqa: E402
    shade, shade_scene)

from shade_cases import (autograd_grads, case_id, feature_matrix,  # noqa: E402
                         leaf_gap, make_case, ray_gaps)

TOL_COLOUR = 2e-5
TOL_GRAD = 2e-4


def plain(case):
    s = case.state
    return shade(case.scene, s, final_direction(case.env, s))


@pytest.mark.parametrize("features", feature_matrix(), ids=case_id)
def test_shade_vjp_matches_autograd(features):
    """shade_forward equals the plain path's colours and shade_vjp its
    gradients, for every leaf of the scene and the state."""
    case = make_case(*features)
    ref_out, ref = autograd_grads(case, plain)
    s = case.state
    ss = shade_scene(case.scene)
    with torch.no_grad():
        out = sa.shade_forward(s.x, s.p, s.E, s.status, s.hit_obj, ss)
        grads = sa.shade_vjp(s.x, s.p, s.E, s.status, s.hit_obj, ss, case.g)
    assert float((out - ref_out.detach()).abs().max()) <= TOL_COLOUR
    gx, gp, gE, gscal, gsph, glights, gsky, gdisk, gmoon = grads
    # the packed scene's cotangents back to the leaves
    packed, cots = [ss.scal, ss.sph, ss.lights], [gscal, gsph, glights]
    for t, g in ((ss.sky, gsky), (ss.disk_tex, gdisk), (ss.sph_tex, gmoon)):
        if t is not None:
            packed.append(t)
            cots.append(g)
    names = [k for k in case.leaves if k not in ("x", "p", "E")]
    back = torch.autograd.grad(
        [t for t in packed if t.requires_grad],
        [case.leaves[k] for k in names],
        grad_outputs=[g for t, g in zip(packed, cots) if t.requires_grad],
        allow_unused=True)
    got = dict(x=gx, p=gp, E=gE)
    got.update({k: torch.zeros_like(case.leaves[k]) if b is None else b
                for k, b in zip(names, back)})
    for k, want in ref.items():
        assert torch.isfinite(got[k]).all(), k
        if k in ("x", "p", "E"):
            if k != "x":
                assert bool(torch.isfinite(want).all()), k
            gap = float(ray_gaps(got[k], want).max())
        else:
            gap = leaf_gap(got[k], want)
        assert gap <= TOL_GRAD, (k, gap)


def test_shade_vjp_covers_every_branch():
    """The matrix's rays reach every branch: the sky's seam and poles (the
    equirect's clamp and its degenerate atan2), both redshift zeros, and
    lit, unlit and shadowed sphere points."""
    case = make_case(True, True, "beam+", 4, 2)
    s = case.state
    ss = shade_scene(case.scene)
    with torch.no_grad():
        sky, dsk, sph, black, error = sa.branches(s.status, ss)
        assert all(bool(m.any()) for m in (sky, dsk, sph, black, error))
        x, p = sa._split(s.x), sa._split(s.p)
        d, _, _ = sa.unit(sa.velocity(x, p, s.E, ss.scal, True))
        deg = (d[0].abs() < sa.ACOS_EPS) & (d[1].abs() < sa.ACOS_EPS)
        assert bool((deg & sky).any())
        assert bool(((d[2].abs() > sa.ACOS_HI) & sky).any())
        g, z = sa.redshift(x, p, s.E, ss.scal)
        assert bool((~z["valid"] & (z["d2"] <= sa.R2_FLOOR) & dsk).any())
        assert bool((~z["valid"] & (z["rel"] <= 0) & dsk).any())
        assert bool((z["valid"] & dsk).any())
        _, zs = sa.sphere(x, s.hit_obj, ss)
        lit = [t["vis"] * (t["ndl"] > 0) for t in zs["lights"]]
        shadowed = [(t["vis"] == 0) & (t["ndl"] > 0) for t in zs["lights"]]
        assert all(bool((m.bool() & sph).any()) for m in lit)
        assert all(bool((m & sph).any()) for m in shadowed)
