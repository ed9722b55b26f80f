"""Branchless shading (PyTorch port of scene/shading.py).

Each shader runs densely over the batch and a status-mask select composes
the final colour: escaped and budget rays look up the sky, disk rays the
Gaussian-profile textured disk, sphere rays the emission texture or the
Lambert lights with shadow rays, captured and inside-horizon rays are
black, non-finite rays are red.

``shade_rays`` is the renderer's entry: on a CUDA device it shades each
ray once, by its own status, in one launch of ops/csrc/shade.cu with a
hand-written backward (ops/cuda_kernel.py ``ShadeKernel``), from the scene
as ``shade_scene`` packs it; on the CPU it is ``final_direction`` +
``shade``.
"""

from __future__ import annotations

import math

import torch

from ..ops import cuda_kernel, states
from ..ops.integrate import GeodesicEnv, final_direction
from ..ops.shade_adjoint import (DISK_BEAMING, DISK_NONE, DISK_PLAIN,
                                 SPH_COLS, ShadeScene)
from ..ops.states import RayState
from ..utils.profiling import annotate
from .scene import Scene
from .texture import safe_arccos, sample_bpy, sample_equirect, sphere_uv_bpy

ERROR_COLOR = (1.0, 0.0, 0.0)   # rogue-ray colour
BLACK = (0.0, 0.0, 0.0)


def shade_background(scene: Scene, directions: torch.Tensor) -> torch.Tensor:
    """Equirect sky lookup; black when no sky is configured."""
    if scene.background is None:
        return torch.zeros(directions.shape[:-1] + (3,),
                           dtype=directions.dtype, device=directions.device)
    d = directions / torch.clamp_min(
        torch.linalg.norm(directions, dim=-1, keepdim=True), 1e-20)
    return sample_equirect(scene.background, d)


def disk_redshift(x: torch.Tensor, p: torch.Tensor, E: torch.Tensor, mass,
                  spin=None, orbit_dir=1.0) -> torch.Tensor:
    """Gravitational + Doppler shift g = E_inf / E_emitted of a photon
    crossing the equatorial disk, for matter on Keplerian circular orbits
    (Kerr equatorial kinematics, Boyer-Lindquist radius at z = 0):

        Omega = s sqrt(M) / (r^(3/2) + s a sqrt(M)),       s = orbit_dir
        u^t   = (r^(3/2) + s a sqrt(M))
                / (r^(3/4) sqrt(r^(3/2) - 3 M sqrt(r) + s 2 a sqrt(M)))
        L_z   = x p_y - y p_x
        g     = E / (u^t (E - Omega L_z))

    Inside the innermost circular photon orbit (u^t undefined) g is 0, and
    so it is where E - Omega L_z <= 0: no matter on the orbit emits such a
    photon (its energy there would not be positive), a state that only a
    ray whose RK4 step went through the horizon's interior reaches (a step
    of 0.1 a little outside the horizon of a/M = 0.9 can), and whose g
    would grow without bound."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    a = f(0.0 if spin is None else spin)
    s = f(orbit_dir)
    rho2 = x[..., 0] ** 2 + x[..., 1] ** 2
    r = torch.sqrt(torch.clamp_min(rho2 - a * a, 1e-12))
    sqr = torch.sqrt(r)
    sqM = torch.sqrt(torch.clamp_min(f(mass), 1e-20))
    omega = s * sqM / (r * sqr + s * a * sqM)
    denom2 = r * sqr - 3.0 * mass * sqr + s * 2.0 * a * sqM
    ut = (r * sqr + s * a * sqM) / (
        r ** 0.75 * torch.sqrt(torch.clamp_min(denom2, 1e-12)))
    lz = x[..., 0] * p[..., 1] - x[..., 1] * p[..., 0]
    rel = E - omega * lz
    e_emit = ut * torch.clamp_min(rel, 1e-12)
    g = E / torch.clamp_min(e_emit, 1e-12)
    return torch.where((denom2 > 1e-12) & (rel > 0), g, 0.0)


def disk_uv(disk, hit_point: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The disk texture's bpy coords (tex_x, s) at a hit point (see
    shade_disk)."""
    x, y = hit_point[..., 0], hit_point[..., 1]
    rr = torch.sqrt(x * x + y * y)
    s = (rr - disk.r_in) / torch.clamp_min(disk.r_out - disk.r_in, 1e-20)
    sign_y = torch.where(y >= 0, 1.0, -1.0)
    tex_x = (disk.phase + safe_arccos(x / torch.clamp_min(rr, 1e-20))
             * sign_y) / math.pi
    return tex_x, s


def shade_disk(scene: Scene, hit_point: torch.Tensor,
               p: torch.Tensor | None = None,
               E: torch.Tensor | None = None) -> torch.Tensor:
    """Accretion-disk shader, the reference's checkHitDisk model:

        s         = (R - R_in) / (R_out - R_in)
        intensity = I exp(-(s - mean)^2 / (2 stddev^2)) / sqrt(2 pi stddev)
        tex_x     = (phase + arccos(x / R) sign(y)) / pi
        color     = tex(tex_x, s) intensity

    times g^beaming (``disk_redshift``) when the disk has a beaming
    exponent and the momentum is given, in the profiler span
    ``bhgc.render.redshift``."""
    disk = scene.disk
    tex_x, s = disk_uv(disk, hit_point)
    gauss = torch.exp(-((s - disk.mean) ** 2) / (2.0 * disk.stddev ** 2))
    intensity = (disk.intensity * gauss
                 / torch.sqrt(2.0 * math.pi * disk.stddev))
    out = sample_bpy(disk.texture, tex_x, s) * intensity[..., None]
    if disk.beaming is not None and p is not None:
        with annotate("bhgc.render.redshift"):
            g = disk_redshift(hit_point, p, E, scene.bh.mass, scene.bh.spin,
                              disk.orbit_dir if disk.orbit_dir is not None
                              else 1.0)
            out = out * (g ** disk.beaming)[..., None]
    return out


def _occluded(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
              dist: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Whether a sphere or the horizon blocks the segment origin ->
    origin + direction dist (the reference's shadow ray, with its 1e-5
    self-intersection offset)."""
    o = origin + direction * eps
    blocked = torch.zeros(origin.shape[:-1], dtype=torch.bool,
                          device=origin.device)

    def seg_hits_sphere(center, radius):
        oc = o - center
        b = torch.sum(oc * direction, dim=-1)
        c = torch.sum(oc * oc, dim=-1) - radius * radius
        disc = b * b - c
        # guarded sqrt, as in integrate._sphere_events
        sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
        t0 = -b - sq
        return (disc > 0) & (t0 > eps) & (t0 < dist)

    if scene.spheres is not None:
        for j in range(scene.spheres.center.shape[0]):
            blocked = blocked | seg_hits_sphere(scene.spheres.center[j],
                                                scene.spheres.radius[j])
    # the hole's horizon sphere, at the origin of the BH frame
    blocked = blocked | seg_hits_sphere(torch.zeros_like(origin),
                                        2.0 * scene.bh.mass)
    return blocked


def shade_sphere(scene: Scene, s: RayState) -> torch.Tensor:
    """Surface shader, the reference's normal_hit: the emission texture at
    the spherical UV of the object-local normal, or Lambert with shadow
    rays (the reference's light intensity enters twice, kept), mixed by
    each sphere's emission weight.  Positions are BH-centred."""
    sph = scene.spheres
    obj = torch.clamp(s.hit_obj, 0, sph.center.shape[0] - 1).long()
    normal = s.hit_normal(sph.center)

    # K cheap bilinear samples selected by object id
    ph, th = sphere_uv_bpy(normal)
    emission_rgb = torch.zeros_like(normal)
    for j in range(sph.texture.shape[0]):
        rgb_j = sample_bpy(sph.texture[j], ph, th)
        emission_rgb = torch.where((obj == j)[..., None], rgb_j,
                                   emission_rgb)

    lambert_rgb = torch.zeros_like(normal)
    if scene.lights is not None:
        base = sph.albedo[obj] * scene.lights.intensity
        for j in range(scene.lights.position.shape[0]):
            lv = scene.lights.position[j] - s.x
            d2 = torch.sum(lv * lv, dim=-1)
            ld = lv / torch.clamp_min(torch.sqrt(d2)[..., None], 1e-20)
            ndotl = torch.sum(normal * ld, dim=-1)
            shadow = _occluded(scene, s.x, ld, torch.sqrt(d2))
            vis = torch.where(shadow, 0.0, 1.0)
            lambert_rgb = lambert_rgb + base * (
                scene.lights.intensity * vis * torch.clamp_min(ndotl, 0.0)
                / d2)[..., None]

    w = sph.emission[obj][..., None]
    return w * emission_rgb + (1.0 - w) * lambert_rgb


def shade(scene: Scene, s: RayState, end_dir: torch.Tensor) -> torch.Tensor:
    """Compose the final per-ray RGB from the termination taxonomy: disk,
    then object, then capture-black, then error-red, over the sky."""
    st = s.status
    color = shade_background(scene, end_dir)  # ESCAPED and BUDGET
    if scene.disk is not None:
        on = st == states.DISK
        # A beaming disk's g^beaming of a ray that ended elsewhere (inside
        # the horizon, say) can overflow to inf, and the select's zero
        # cotangent times inf is NaN: those rays enter with E = 0, so g = 0.
        E = s.E if scene.disk.beaming is None else torch.where(on, s.E, 0.0)
        color = torch.where(on[..., None], shade_disk(scene, s.x, s.p, E),
                            color)
    if scene.spheres is not None:
        color = torch.where((st == states.OBJECT)[..., None],
                            shade_sphere(scene, s), color)
    black = (st == states.CAPTURED) | (st == states.INSIDE_HORIZON)
    color = torch.where(black[..., None], color.new_tensor(BLACK), color)
    color = torch.where((st == states.ERROR)[..., None],
                        color.new_tensor(ERROR_COLOR), color)
    return color


def shade_scene(scene: Scene) -> ShadeScene:
    """``scene`` (in the hole's frame: renderer._bh_frame) as the shading
    kernels take it (ops/shade_adjoint.py ``ShadeScene``): the scalars
    stacked into one vector, the spheres' [centre, radius, emission,
    albedo] rows into one table, the light positions, the textures; each
    in the autograd graph of the scene's tensors.  An absent scalar is 0
    (the orbit direction 1, as ``shade_disk`` defaults it)."""
    bh, disk, sph, lights = scene.bh, scene.disk, scene.spheres, scene.lights
    mass = bh.mass
    zero = mass.new_zeros(())

    def f(v):
        if v is None:
            return zero
        return torch.as_tensor(v, dtype=torch.float32,
                               device=mass.device).reshape(())

    vals = [mass, bh.spin]
    if disk is None:
        vals += [None] * 8
    else:
        vals += [disk.r_in, disk.r_out, disk.phase, disk.mean, disk.stddev,
                 disk.intensity, disk.beaming,
                 1.0 if disk.orbit_dir is None else disk.orbit_dir]
    vals.append(None if lights is None else lights.intensity)
    scal = torch.stack([f(v) for v in vals])
    if sph is None:
        table = mass.new_zeros((0, SPH_COLS))
        sph_tex = None
    else:
        table = torch.cat([sph.center, sph.radius[:, None],
                           sph.emission[:, None], sph.albedo],
                          dim=1).contiguous()
        sph_tex = sph.texture.contiguous()
    pos = (mass.new_zeros((0, 3)) if lights is None
           else lights.position.reshape(-1, 3).contiguous())
    mode = (DISK_NONE if disk is None
            else DISK_PLAIN if disk.beaming is None else DISK_BEAMING)
    return ShadeScene(
        scal=scal, sph=table, lights=pos,
        sky=None if scene.background is None
        else scene.background.contiguous(),
        disk_tex=None if disk is None else disk.texture.contiguous(),
        sph_tex=sph_tex, kerr=bh.spin is not None, disk=mode)


def shade_rays(env: GeodesicEnv, scene: Scene, s: RayState) -> torch.Tensor:
    """The colours of the rays of final state ``s`` in ``scene`` (the
    hole's frame): ``shade(scene, s, final_direction(env, s))``.  On a CUDA
    device that is ops/cuda_kernel.py ``shade_cuda``: one launch that
    shades each ray by its own status, and one hand-written backward; a
    CUDA tensor launches it or raises.  On the CPU, the plain path."""
    if s.x.is_cuda:
        return cuda_kernel.shade_cuda(shade_scene(scene), s)
    return shade(scene, s, final_direction(env, s))
