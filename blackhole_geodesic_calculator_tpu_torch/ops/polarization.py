"""Polarization transport along null geodesics (PyTorch port of
ops/polarization.py).

Schwarzschild, closed form: every null geodesic is planar (the orbital
plane normal n = unit(x cross k) is conserved) and reflection symmetry
through the plane keeps the transported polarization's components in the
frame (e_out = n, e_in = unit(d cross n)) constant -- no gravitational
Faraday rotation; the observable rotation is the geometric turn of e_in as
the ray bends.

Any metric, Kerr included: ``transport_polarization_ode`` integrates the
12 ODEs of x, k and the parallel-transported f with RK4, batched over the
rays, on the tensors' device.  Kerr-Schild metrics contract the
Christoffel symbols with the analytic ``ks_directional_christoffel``,
others with ``Metric.christoffel``.  In the JAX package the transport is
an XLA scan, not a Pallas kernel; here it is a loop of PyTorch operations
that stops once no ray is alive (a frozen ray is an identity under a
step).
"""

from __future__ import annotations

import torch

from ..models.kerr import ks_scalars

_EPS = 1e-12


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               _EPS)


def plane_normal(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The conserved orbital-plane normal unit(x cross d); for a radial ray
    (|x cross d| < 1e-8, which does not bend) a fixed unit vector
    orthogonal to d, so what follows stays finite."""
    n = _cross(x, d)
    radial = torch.linalg.norm(n, dim=-1, keepdim=True) < 1e-8
    e_x = d.new_tensor([1.0, 0.0, 0.0]).expand(d.shape)
    e_y = d.new_tensor([0.0, 1.0, 0.0]).expand(d.shape)
    alt = _cross(d, torch.where(torch.abs(d[..., :1]) < 0.9, e_x, e_y))
    return _unit(torch.where(radial, alt, n))


def transport_polarization(x0: torch.Tensor, d0: torch.Tensor,
                           f0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """Carry the polarization ``f0`` (unit, orthogonal to ``d0``) from the
    launch state (x0, d0) to the escape direction ``d1``, exactly for
    Schwarzschild: its components in the (n, e_in) frame at launch, rebuilt
    in the frame at escape.  A unit vector orthogonal to d1."""
    n = plane_normal(x0, d0)
    e_in0 = _unit(_cross(d0, n))
    e_in1 = _unit(_cross(d1, n))
    a = _dot(f0, n)[..., None]
    b = _dot(f0, e_in0)[..., None]
    f1 = a * n + b * e_in1
    f1 = f1 - _dot(f1, d1)[..., None] * d1
    return _unit(f1)


def polarization_rotation(x0: torch.Tensor, d0: torch.Tensor,
                          d1: torch.Tensor) -> torch.Tensor:
    """The rotation angle (radians) of the in-plane basis from launch to
    escape: the deflection signed within the orbital plane, 0 in flat
    space."""
    n = plane_normal(x0, d0)
    cos = torch.clamp(_dot(d0, d1), -1.0, 1.0)
    sin = _dot(_cross(d0, d1), n)
    return torch.atan2(sin, cos)


def _ft_from_orthogonality(g, k4, f3):
    """f^t making (f^t, f3) orthogonal to k4 under g: f^t = -(f^i k_i)/k_t
    with k_mu = g_{mu nu} k^nu."""
    k_low = torch.sum(g * k4[..., None, :], dim=-1)
    return -_dot(f3, k_low[..., 1:]) / k_low[..., 0]


def _ks_jacobians(x3, mass, a):
    """(H, l3, dH, J3) at each point of ``x3`` (..., 3): the Kerr-Schild
    scalars and their spatial jacobians dH_j = dH/dx_j and J3[i, j] =
    d l_i / d x_j, by jacfwd of ``ks_scalars`` at each point under vmap."""
    def one(q):
        # the point as a batch of one, as Metric.metric_jacobian does
        H, l3 = ks_scalars(q[None], mass, a)
        return H[0], l3[0]

    flat = x3.reshape(-1, 3)
    dH, J3 = torch.func.vmap(torch.func.jacfwd(one))(flat)
    H, l3 = ks_scalars(x3, mass, a)
    return (H, l3, dH.reshape(x3.shape),
            J3.reshape(x3.shape[:-1] + (3, 3)))


def _ks_contract(H, l3, dH, J3, k4, v4):
    """Gamma^s_{mu nu} k^mu v^nu from the Kerr-Schild scalars and their
    jacobians at the point (``ks_directional_christoffel``)."""
    k0, k3v = k4[..., 0], k4[..., 1:]
    v0, v3v = v4[..., 0], v4[..., 1:]
    u = k0 + _dot(l3, k3v)                 # l_mu k^mu
    w = v0 + _dot(l3, v3v)
    Hk = _dot(dH, k3v)
    Hv = _dot(dH, v3v)
    a3 = torch.sum(J3 * k3v[..., None, :], dim=-1)   # a_i = l_{i,j} k^j
    b3 = torch.sum(J3 * v3v[..., None, :], dim=-1)
    c3 = torch.sum(J3 * k3v[..., :, None], dim=-2)   # c_j = l_{i,j} k^i
    d3v = torch.sum(J3 * v3v[..., :, None], dim=-2)
    va = _dot(v3v, a3)
    kb = _dot(k3v, b3)
    # V_rho = 1/2 k^mu v^nu (d_mu g_{nu rho} + d_nu g_{rho mu}
    #                        - d_rho g_{mu nu})
    S = Hk * w + Hv * u + H * (va + kb)
    V0 = S                                 # l_0 = 1, H_0 = 0, a_0 = c_0 = 0
    V3 = (S[..., None] * l3 + H[..., None] * (w[..., None] * a3
                                              + u[..., None] * b3)
          - (u * w)[..., None] * dH
          - H[..., None] * (w[..., None] * c3 + u[..., None] * d3v))
    # raise with g^{s rho} = eta^{s rho} - 2 H l^s l^rho, l^rho = (-1, l3)
    lv = -V0 + _dot(l3, V3)
    g0 = -V0 - 2.0 * H * (-1.0) * lv
    g3 = V3 - (2.0 * H * lv)[..., None] * l3
    return torch.cat([g0[..., None], g3], dim=-1)


def ks_directional_christoffel(mass, a):
    """The Kerr-Schild contraction Gamma^s_{mu nu} k^mu v^nu without the
    (4, 4, 4) Christoffel symbols.  With g = eta + 2 H l l (l null),

        d_alpha g_{mu nu} = 2 [H_alpha l_mu l_nu
                               + H (l_{mu,alpha} l_nu + l_mu l_{nu,alpha})]
        g^{s rho}        = eta^{s rho} - 2 H l^s l^rho   (exact),

    so it takes (H, l) and their spatial jacobian, jacfwd of the ~30-flop
    ``ks_scalars``, and a few 3-vector products; it equals the
    ``Metric.christoffel`` contraction.  Returns ``contract(x4, k4, v4)``
    -> (..., 4); v4 = k4 for the geodesic and v4 = f4 for the transport."""
    def contract(x4, k4, v4):
        H, l3, dH, J3 = _ks_jacobians(x4[..., 1:], mass, a)
        return _ks_contract(H, l3, dH, J3, k4, v4)

    return contract


def _transport_rhs(metric):
    """rhs(x4, k4, f4) -> (k4, dk4, df4) of the transport ODE.  A
    Kerr-Schild metric contracts analytically, its (H, l) jacobians taken
    once a stage for both contractions; any other goes through
    ``metric.christoffel``."""
    if metric.name in ("kerr_ks", "schwarzschild_ks"):
        mass = metric.params[0]
        spin = metric.params[1] if len(metric.params) > 1 else 0.0

        def rhs(x4, k4, f4):
            jac = _ks_jacobians(x4[..., 1:], mass, spin)
            return (k4, -_ks_contract(*jac, k4, k4),
                    -_ks_contract(*jac, k4, f4))
        return rhs

    def rhs(x4, k4, f4):
        gam = metric.christoffel(x4)
        kk = k4[..., None, :, None] * k4[..., None, None, :]
        kf = k4[..., None, :, None] * f4[..., None, None, :]
        return (k4, -torch.sum(gam * kk, dim=(-2, -1)),
                -torch.sum(gam * kf, dim=(-2, -1)))
    return rhs


def _bilinear(g, u, v):
    return torch.sum(g * u[..., :, None] * v[..., None, :], dim=(-2, -1))


def transport_polarization_ode(metric, x3: torch.Tensor, d3: torch.Tensor,
                               f3: torch.Tensor, *, n_steps: int = 600,
                               dt: float = 0.1, r_stop: float = 70.0,
                               r_capture: float = 1.0, dt_boost: float = 16.0,
                               r_ref: float = 1.6):
    """Parallel-transport the polarization along null geodesics of any
    metric (Kerr's frame dragging included) by RK4 on the 12 ODEs

        dx^mu/dlam = k^mu,  dk^a/dlam = -Gamma^a_{mu nu} k^mu k^nu,
        df^a/dlam = -Gamma^a_{mu nu} k^mu f^nu,

    the step dt grown by clip((r / r_ref)^1.5, 1, dt_boost) at the
    Euclidean |x|, a ray stopping at |x| >= r_stop or <= r_capture (the
    JAX package's choices, polarization.py:209-224).

    Args: launch positions ``x3`` (N, 3), unit directions ``d3`` and unit
    polarizations ``f3`` orthogonal to them, on one device.  Returns
    ``(f_obs, d_out, x_out, diag)``: the gauge-fixed observable unit
    polarization (f -> f - (f^t/k^t) k, then made orthogonal to d_out), the
    escape direction, the final position, and {"fk_drift": |f.k|,
    "norm_drift": |g(f, f) - g(f, f) at launch|, "unfinished": the rays
    still alive}."""
    rhs = _transport_rhs(metric)
    x4 = torch.cat([torch.zeros_like(x3[..., :1]), x3], dim=-1)
    kt = metric.null_k_t(x4, d3)
    k4 = torch.cat([kt[..., None], d3], dim=-1)
    g0 = metric.g(x4)
    ft = _ft_from_orthogonality(g0, k4, f3)
    f4 = torch.cat([ft[..., None], f3], dim=-1)
    gff0 = _bilinear(g0, f4, f4)
    alive = torch.ones(x3.shape[:-1], dtype=torch.bool, device=x3.device)

    for _ in range(n_steps):
        if not bool(alive.any()):
            break
        r = torch.linalg.norm(x4[..., 1:], dim=-1)
        q = r / r_ref
        h = (torch.where(alive, dt, 0.0)
             * torch.clamp(q * torch.sqrt(torch.clamp_min(q, 0.0)), 1.0,
                           dt_boost))[..., None]
        k1 = rhs(x4, k4, f4)
        k2 = rhs(x4 + 0.5 * h * k1[0], k4 + 0.5 * h * k1[1],
                 f4 + 0.5 * h * k1[2])
        k3 = rhs(x4 + 0.5 * h * k2[0], k4 + 0.5 * h * k2[1],
                 f4 + 0.5 * h * k2[2])
        k4s = rhs(x4 + h * k3[0], k4 + h * k3[1], f4 + h * k3[2])
        s6 = h / 6.0
        x4n = x4 + s6 * (k1[0] + 2 * (k2[0] + k3[0]) + k4s[0])
        k4n = k4 + s6 * (k1[1] + 2 * (k2[1] + k3[1]) + k4s[1])
        f4n = f4 + s6 * (k1[2] + 2 * (k2[2] + k3[2]) + k4s[2])
        rn = torch.linalg.norm(x4n[..., 1:], dim=-1)
        stop = (rn >= r_stop) | (rn <= r_capture)
        upd = alive[..., None]
        x4 = torch.where(upd, x4n, x4)
        k4 = torch.where(upd, k4n, k4)
        f4 = torch.where(upd, f4n, f4)
        alive = alive & ~stop

    g1 = metric.g(x4)
    fk = _bilinear(g1, f4, k4)
    gff = _bilinear(g1, f4, f4)
    # gauge fix f -> f - (f^t/k^t) k: a purely spatial observable
    f_obs = f4[..., 1:] - (f4[..., 0] / k4[..., 0])[..., None] * k4[..., 1:]
    d_out = _unit(k4[..., 1:])
    f_obs = f_obs - _dot(f_obs, d_out)[..., None] * d_out
    return _unit(f_obs), d_out, x4[..., 1:], {
        "fk_drift": torch.abs(fk), "norm_drift": torch.abs(gff - gff0),
        "unfinished": alive}
