"""Ray states and scenes for the shading kernel's tests: every status, the
sky's seam and poles, disk hits inside and outside the annulus (and with
redshifts that are 0 by either of their two cases), sphere hits on four
spheres, two lights whose segments a sphere and the horizon shadow.
tests/test_torch_shade.py (the CPU) and tests/test_torch_cuda.py (the
card) build their cases here."""

import dataclasses

import numpy as np
import torch

import blackhole_geodesic_calculator_tpu_torch as P
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint
from blackhole_geodesic_calculator_tpu_torch.ops import states

MASS, SPIN = 0.5, 0.45
R_IN, R_OUT = 2.0, 6.0
# A and B on the +x axis, so B shadows A's side that faces the light at
# +20 x, and the horizon shadows A's side that faces the light at -20 x.
CENTERS = ((10.0, 0.0, 0.0), (14.0, 0.2, 0.0), (0.0, 10.0, 0.0),
           (-3.0, -9.0, 2.0))
RADII = (1.0, 1.0, 0.8, 0.7)
EMISSION = (1.0, 0.3, 0.0, 0.6)
LIGHTS = ((20.0, 0.5, 0.2), (-20.0, 0.3, 0.0))
DISKS = {"plain": (None, 1.0), "beam+": (4.0, 1.0), "beam-": (4.0, -1.0)}


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def ray_state(n, rng, dtype=np.float32):
    """(x, p, E, status, hit_obj) numpy arrays of n rays, n >= 400."""
    x = np.zeros((n, 3))
    p = np.zeros((n, 3))
    E = rng.uniform(0.8, 1.2, n)
    st = np.zeros(n, dtype=np.int32)
    obj = np.full(n, -1, dtype=np.int32)
    # statuses: 40% sky (ESCAPED, BUDGET, ACTIVE), 20% DISK, 25% OBJECT,
    # the rest CAPTURED, INSIDE_HORIZON, ERROR
    cuts = (np.array([0.4, 0.6, 0.85]) * n).astype(int)
    sky, dsk, sph, rest = np.split(np.arange(n), cuts)
    st[sky] = rng.choice([states.ESCAPED, states.BUDGET, states.ACTIVE],
                         len(sky))
    st[dsk] = states.DISK
    st[sph] = states.OBJECT
    st[rest] = rng.choice([states.CAPTURED, states.INSIDE_HORIZON,
                           states.ERROR], len(rest))
    # the sky: anywhere far out; then the seam (the -x half of the y = 0
    # plane, where the longitude wraps) and the poles (along +-z)
    x[sky] = _unit(rng.normal(size=(len(sky), 3))) * rng.uniform(
        30.0, 60.0, (len(sky), 1))
    p[sky] = _unit(rng.normal(size=(len(sky), 3))) * rng.uniform(
        0.9, 1.3, (len(sky), 1))
    seam, pole = sky[:24], sky[24:48]
    x[seam] = np.array([-40.0, 0.0, 3.0])
    tilt = np.array([0.0, 1e-9, -1e-9, 1e-7, -1e-7, 1e-4, -1e-4, 2e-2] * 3)
    p[seam] = np.stack([-np.ones(24), tilt, 0.1 * rng.normal(size=24)], -1)
    x[pole] = np.array([0.0, 0.0, 45.0]) * np.repeat([1.0, -1.0], 12)[:, None]
    small = np.array([0.0, 1e-8, 1e-7, 5e-7, 1e-3, 0.0] * 4)
    p[pole] = np.stack([small, small[::-1], np.sign(x[pole, 2])], -1)
    # the disk: the annulus and either side of it, the +-x axis (acos's
    # clamp, sign(y) at y = 0), some rays inside the last circular orbit
    # and some whose redshift has E - Omega L_z <= 0 (|p| large)
    r = rng.uniform(R_IN - 0.5, R_OUT + 0.5, len(dsk))
    r[:6] = [0.6, 0.7, 0.8, 0.9, 1.0, 1.2]
    phi = rng.uniform(0.0, 2.0 * np.pi, len(dsk))
    phi[6:10] = [0.0, np.pi, 0.0, np.pi]
    x[dsk] = np.stack([r * np.cos(phi), r * np.sin(phi),
                       np.zeros(len(dsk))], -1)
    x[dsk[6:10], 1] = 0.0
    p[dsk] = _unit(rng.normal(size=(len(dsk), 3)))
    fast = dsk[10:22]
    p[fast] = np.stack([-20.0 * np.sin(phi[10:22]), 20.0 * np.cos(phi[10:22]),
                        rng.normal(size=12)], -1)
    # the spheres: points on their surfaces, normals along the axes too
    obj[sph] = rng.integers(0, len(CENTERS), len(sph))
    nrm = _unit(rng.normal(size=(len(sph), 3)))
    nrm[:6] = [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0],
               [0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]
    x[sph] = (np.asarray(CENTERS)[obj[sph]]
              + np.asarray(RADII)[obj[sph], None] * nrm)
    p[sph] = _unit(rng.normal(size=(len(sph), 3)))
    x[rest] = _unit(rng.normal(size=(len(rest), 3))) * 0.8
    p[rest] = _unit(rng.normal(size=(len(rest), 3)))
    return (x.astype(dtype), p.astype(dtype), E.astype(dtype), st, obj)


def textures(rng, n_sph):
    """sky (16, 32, 3), disk (8, 16, 3), spheres (n_sph, 8, 16, 3)."""
    return (rng.uniform(0.0, 1.0, (16, 32, 3)),
            rng.uniform(0.0, 1.0, (8, 16, 3)),
            rng.uniform(0.0, 1.0, (n_sph, 8, 16, 3)))


@dataclasses.dataclass
class Case:
    scene: P.Scene
    env: tint.GeodesicEnv
    state: states.RayState
    g: torch.Tensor
    leaves: dict


def make_case(kerr, sky, disk, n_sph, n_lights, n=2048, device="cpu",
              seed=0) -> Case:
    """A scene (in the hole's frame) with the features asked for, every
    float tensor of it a leaf that needs its gradient, a state of n rays
    whose x, p and E need theirs, and a colour cotangent g."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def leaf(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=dev,
                            requires_grad=True)

    sky_t, disk_t, moon_t = textures(rng, n_sph)
    leaves = dict(mass=leaf(MASS))
    if kerr:
        leaves["spin"] = leaf(SPIN)
    bh = P.BlackHole(mass=leaves["mass"], loc=torch.zeros(3, device=dev),
                     spin=leaves.get("spin"))
    scene = P.Scene(bh=bh)
    if sky:
        leaves["sky"] = scene.background = leaf(sky_t)
    if disk is not None:
        beaming, orbit = DISKS[disk]
        d = dict(r_in=leaf(R_IN), r_out=leaf(R_OUT), phase=leaf(0.3),
                 mean=leaf(0.5), stddev=leaf(0.2), intensity=leaf(1.2),
                 texture=leaf(disk_t), orbit_dir=leaf(orbit),
                 beaming=None if beaming is None else leaf(beaming))
        leaves.update({"disk_" + k: v for k, v in d.items()
                       if v is not None})
        scene.disk = P.Disk(**d)
    if n_sph:
        s = dict(center=leaf(CENTERS[:n_sph]), radius=leaf(RADII[:n_sph]),
                 emission=leaf(EMISSION[:n_sph]),
                 albedo=leaf(rng.uniform(0.2, 1.0, (n_sph, 3))),
                 texture=leaf(moon_t))
        leaves.update({"sph_" + k: v for k, v in s.items()})
        scene.spheres = P.Spheres(**s)
    if n_lights:
        ll = dict(position=leaf(LIGHTS[:n_lights]), intensity=leaf(10.0))
        leaves.update({"light_" + k: v for k, v in ll.items()})
        scene.lights = P.Lights(**ll)
    env = tint.GeodesicEnv(mass=leaves["mass"], r_capture=2.0 * MASS,
                           r_escape=70.0, lam_max=100.0,
                           spin=leaves.get("spin"))
    x, p, E, st, obj = ray_state(n, rng)
    state = states.RayState(
        x=leaf(x), p=leaf(p), E=leaf(E),
        lam=torch.zeros(n, device=dev),
        status=torch.tensor(st, device=dev),
        hit_obj=torch.tensor(obj, device=dev))
    for k in ("x", "p", "E"):
        leaves[k] = getattr(state, k)
    g = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                     device=dev)
    return Case(scene, env, state, g, leaves)


def feature_matrix():
    """(kerr, sky, disk, n_sph, n_lights) of every case: Schwarzschild and
    Kerr, a sky or none, a plain disk or a beaming one of either orbit
    direction, no spheres, four, or four and two lights."""
    out = []
    for kerr in (False, True):
        for sky in (True, False):
            for disk in DISKS:
                for n_sph, n_lights in ((0, 0), (4, 0), (4, 2)):
                    out.append((kerr, sky, disk, n_sph, n_lights))
    return out


def case_id(case) -> str:
    kerr, sky, disk, n_sph, n_lights = case
    return "-".join(["kerr" if kerr else "schw", "sky" if sky else "nosky",
                     disk, f"{n_sph}sph", f"{n_lights}lights"])


def autograd_grads(case: Case, shade_fn):
    """The gradients of sum(g * colour) with respect to every leaf of the
    case, the colour from ``shade_fn(case)``; zeros where a leaf gets
    none."""
    out = shade_fn(case)
    names = list(case.leaves)
    grads = torch.autograd.grad((out * case.g).sum(),
                                [case.leaves[k] for k in names],
                                allow_unused=True)
    return out, {k: torch.zeros_like(case.leaves[k]) if gr is None else gr
                 for k, gr in zip(names, grads)}


def rel_gap(a, b) -> float:
    """max |a - b| over max(max |b|, 1e-30)."""
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def leaf_gap(a, b) -> float:
    """rel_gap of a scene leaf's cotangent; a table (K, C) -- the spheres'
    centres and albedos, the lights' positions -- row by row, so that one
    sphere's legitimately huge cotangent (ray_gaps) does not hide the
    others'."""
    if a.dim() == 2:
        return max((rel_gap(ra, rb) for ra, rb in zip(a, b)), default=0.0)
    return rel_gap(a, b)


def ray_gaps(a, b):
    """Each ray's gap between per-ray cotangents a and b (n, ...): the
    largest |a - b| of its entries over the larger of its largest |b| and
    the rays' 99.9th percentile of that, so that a ray whose cotangent is
    legitimately huge (a sphere normal on its own pole, where the
    arctan form's derivative is 1 / n_x) neither hides the others' gaps
    nor reads its own against a tiny scale.  Rays where b is not finite
    read 0."""
    n = b.shape[0]
    a, b = a.reshape(n, -1), b.reshape(n, -1)
    ok = torch.isfinite(b).all(-1)
    mag = torch.where(ok, b.abs().max(-1).values, torch.zeros(n, device=b.device))
    scale = max(float(torch.quantile(mag[ok].double(), 0.999)), 1e-30)
    gap = (a - b).abs().max(-1).values / torch.clamp_min(mag, scale)
    return torch.where(ok, gap, torch.zeros_like(gap))

