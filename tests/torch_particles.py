"""The massive-particle fan that tests/test_torch_timelike.py and
tests/test_torch_cuda.py send through ``launch(..., time_like=True)``
(chip_smoke.py's ``particle_fan`` is its full-size copy).  Imports numpy
alone, so the card's tests, which run without JAX, can import it."""

import numpy as np


def particle_fan(n, seed=0, M=0.5):
    """Massive particles about a hole of mass M in random orbital planes:
    circular orbits at r = 4-20 M (dx/dtau = r Omega u^t along the
    tangent, exact in Kerr-Schild coordinates since dr = 0), bound
    eccentric orbits at perihelion (p~ = 20, e = 0.2, as
    test_perihelion_precession), plunging and escaping particles, and a
    band that starts inside the horizon.  Returns float32 (x0, v0)."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(5, size=n, p=[0.4, 0.2, 0.15, 0.15, 0.1])
    n_hat = rng.normal(size=(n, 3))
    n_hat /= np.linalg.norm(n_hat, axis=-1, keepdims=True)
    a = rng.normal(size=(n, 3))
    t_hat = a - np.sum(a * n_hat, -1, keepdims=True) * n_hat
    t_hat /= np.linalg.norm(t_hat, axis=-1, keepdims=True)
    r = rng.uniform(4.0, 20.0, n) * M
    speed = r * np.sqrt(M / r ** 3) / np.sqrt(1.0 - 3.0 * M / r)
    # eccentric: p~ = 20, e = 0.2, at perihelion
    pt, e = 20.0, 0.2
    L = M * pt / np.sqrt(pt - 3 - e * e)
    r_peri = pt * M / (1 + e)
    ecc = kind == 1
    r[ecc], speed[ecc] = r_peri, L / r_peri
    v = speed[:, None] * t_hat
    # plunging: inward from r = 4-15 with a little angular momentum
    plunge = kind == 2
    r[plunge] = rng.uniform(4.0, 15.0, int(plunge.sum()))
    v[plunge] = (-rng.uniform(0.3, 1.0, (int(plunge.sum()), 1)) * n_hat[plunge]
                 + rng.uniform(0.0, 0.1, (int(plunge.sum()), 1))
                 * t_hat[plunge])
    # escaping: outward from r = 6-20 above the escape speed
    esc = kind == 3
    r[esc] = rng.uniform(6.0, 20.0, int(esc.sum()))
    v[esc] = (rng.uniform(0.6, 2.0, (int(esc.sum()), 1)) * n_hat[esc]
              + rng.uniform(0.0, 0.3, (int(esc.sum()), 1)) * t_hat[esc])
    # inside the horizon (r < 2M)
    inside = kind == 4
    r[inside] = rng.uniform(0.05, 0.95, int(inside.sum())) * 2 * M
    v[inside] = rng.normal(size=(int(inside.sum()), 3)) * 0.5
    x = r[:, None] * n_hat
    return x.astype(np.float32), v.astype(np.float32)
