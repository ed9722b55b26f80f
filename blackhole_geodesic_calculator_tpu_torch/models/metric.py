"""Generic spacetime-metric API (PyTorch port of models/metric.py).

A metric is a function ``g_fn(x4, *params)`` from points ``(..., 4)`` to
covariant metric tensors ``(..., 4, 4)``; the Christoffel symbols are the
forward-mode derivative of the metric itself,

    Gamma^sigma_{mu nu} = 1/2 g^{sigma rho} (d_mu g_{nu rho} + d_nu g_{rho mu}
                                             - d_rho g_{mu nu}),

``torch.func.jacfwd`` of ``g_fn`` at each point under ``torch.func.vmap``
over the points.  The JAX class takes one point and is vmapped by its
callers; this one takes a batch with any leading shape.

Conventions: coordinates ``x4 = (t, x, y, z)``, signature (-, +, +, +),
geometrized units with r_s = 2M, ``k4 = dx4/dlambda``.  Contractions are
written as products and sums, so no TF32 setting can touch them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _contract(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """a_{mn} u^m v^n over the last two axes of ``a``: (...,)."""
    return torch.sum(a * u[..., :, None] * v[..., None, :], dim=(-2, -1))


@dataclasses.dataclass
class Metric:
    """A spacetime metric ``g_fn(x4, *params)``, batched over the leading
    axes of ``x4``.

    ``params`` are tensors (mass, spin), so autograd reaches them through
    every quantity below; ``g_inv_fn`` is the closed-form inverse where one
    is known (better in float32 than a solve)."""

    g_fn: Callable[..., torch.Tensor]
    params: tuple
    name: str = "generic"
    g_inv_fn: Callable[..., torch.Tensor] | None = None

    def __post_init__(self):
        self.params = tuple(
            p if isinstance(p, torch.Tensor)
            else torch.as_tensor(p, dtype=torch.float32) for p in self.params)

    def g(self, x4: torch.Tensor) -> torch.Tensor:
        """Covariant g_{mu nu} at ``x4`` (..., 4): (..., 4, 4)."""
        return self.g_fn(x4, *self.params)

    def g_inv(self, x4: torch.Tensor) -> torch.Tensor:
        """Contravariant g^{mu nu}: the closed form when known, else an
        inverse of g."""
        if self.g_inv_fn is not None:
            return self.g_inv_fn(x4, *self.params)
        return torch.linalg.inv(self.g(x4))

    def metric_jacobian(self, x4: torch.Tensor) -> torch.Tensor:
        """dg[..., mu, nu, rho] = d_rho g_{mu nu} at ``x4``: jacfwd of g at
        each point, vmapped over the points."""
        params = self.params

        def one(y):
            # the point as a batch of one: forward-mode AD promotes the
            # tangent of a 0-d tensor times a Python float to float64
            return self.g_fn(y[None], *params)[0]

        flat = x4.reshape(-1, 4)
        dg = torch.func.vmap(torch.func.jacfwd(one))(flat)
        return dg.reshape(x4.shape[:-1] + (4, 4, 4))

    def christoffel(self, x4: torch.Tensor) -> torch.Tensor:
        """Gamma^sigma_{mu nu}, (..., 4, 4, 4) with indices [sigma, mu, nu]."""
        g_inv = self.g_inv(x4)
        dg = self.metric_jacobian(x4)
        # 1/2 (d_mu g_{nu rho} + d_nu g_{rho mu} - d_rho g_{mu nu}), indexed
        # [mu, nu, rho]: dg[n, r, m] and dg[r, m, n] moved to [m, n, r]
        sym = 0.5 * (torch.einsum("...nrm->...mnr", dg)
                     + torch.einsum("...rmn->...mnr", dg) - dg)
        # raise rho: Gamma^s_{mn} = g^{sr} sym_{mnr}
        return torch.sum(g_inv[..., :, None, None, :]
                         * sym[..., None, :, :, :], dim=-1)

    def geodesic_rhs(self, x4: torch.Tensor, k4: torch.Tensor):
        """(dx4/dlam, dk4/dlam) = (k, -Gamma^s_{mn} k^m k^n)."""
        gamma = self.christoffel(x4)
        dk = -_contract(gamma, k4[..., None, :], k4[..., None, :])
        return k4, dk

    def norm_sq(self, x4: torch.Tensor, k4: torch.Tensor) -> torch.Tensor:
        """g_{mu nu} k^mu k^nu: 0 along a null geodesic."""
        return _contract(self.g(x4), k4, k4)

    def null_k_t(self, x4: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
        """Future-directed k^t making (k^t, k3) null at ``x4``: the root of
        g_tt (k^t)^2 + 2 g_ti k^t k^i + g_ij k^i k^j = 0 with k^t > 0
        (g_tt < 0 outside the horizon).  The square root is guarded, so its
        jacobian stays finite where the discriminant is clamped."""
        g = self.g(x4)
        a = g[..., 0, 0]
        b = 2.0 * torch.sum(g[..., 0, 1:] * k3, dim=-1)
        c = _contract(g[..., 1:, 1:], k3, k3)
        d2 = b * b - 4.0 * a * c
        pos = d2 > 0
        disc = torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))) * pos
        return (-b - disc) / (2.0 * a)

