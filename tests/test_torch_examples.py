"""The port's example programs (``blackhole_geodesic_calculator_tpu_torch.
examples``) against the JAX scripts in examples/, on the CPU.

The JAX scripts' functions are loaded from their files; each port
function runs with ``device="cpu"`` (the plain PyTorch loops) on the same
small arguments: ``bardeen_edges`` to the last bit, the deflection angles
within 1e-4 rad, the shadow edges within one final bisection bracket, the
disk's flux ratios within 1e-3 relative, and kerr_faraday's excess map
(lifted to module level in the port; rebuilt here from the JAX script's
lines and its package's public functions) by its rms per spin within 5%
(at a = 0, where the excess is float32 rounding, pixel by pixel).
The examples' ``main`` runs are in tests/test_torch_examples_mains.py and
tests/test_torch_examples_study.py.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu_torch.examples import (  # noqa: E402
    kerr_faraday, parameter_study)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 0.5


def jax_script(name):
    """examples/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jstudy():
    return jax_script("parameter_study")


def test_bardeen_edges_bit_for_bit(jstudy):
    for a in (0.0, 0.15, 0.3, 0.4, 0.45, -0.3):
        assert parameter_study.bardeen_edges(M, a) == jstudy.bardeen_edges(
            M, a)


def test_deflection_matches_jax(jstudy):
    bs = np.asarray([10.0, 20.0, 40.0]) * M
    got = parameter_study.measure_deflection(M, bs, D=100.0, n_steps=2000,
                                             device="cpu")
    want = jstudy.measure_deflection(M, bs, D=100.0, n_steps=2000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_shadow_edges_match_jax(jstudy):
    """a = 0.45 (a/M = 0.9): one ray a bisection step, 12 steps a side;
    both sides' edges within the last bracket, and near Bardeen's."""
    iters = 12
    got = parameter_study.measure_shadow_edges(M, 0.45, iters=iters,
                                               n_steps=3000, device="cpu")
    want = jstudy.measure_shadow_edges(M, 0.45, iters=iters, n_steps=3000)
    bracket = 12.0 * M / 2 ** iters     # D times the last alpha bracket
    np.testing.assert_allclose(got, want, rtol=0, atol=bracket)
    anal = sorted(parameter_study.bardeen_edges(M, 0.45))
    np.testing.assert_allclose(sorted(got), anal, rtol=0.01)


def test_disk_asymmetry_matches_jax(jstudy):
    got = parameter_study.measure_disk_asymmetry([0.0, 1.1], size=32,
                                                 device="cpu")
    want = jstudy.measure_disk_asymmetry([0.0, 1.1], size=32)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[1] > 1.5 > 1.3 > got[0]


def jax_excess_map(a, size, n_steps):
    """examples/kerr_faraday.py's excess_map (nested in its main) from the
    JAX package's public functions, line for line."""
    import jax.numpy as jnp

    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.camera.pinhole import (
        generate_rays, pixel_grid)
    from blackhole_geodesic_calculator_tpu.models import kerr_ks_metric
    from blackhole_geodesic_calculator_tpu.ops.polarization import (
        _unit, plane_normal, transport_polarization,
        transport_polarization_ode)

    D = 25.0
    cam = Camera.make(position=(0.0, -D, 0.0),
                      euler=(jnp.pi / 2, 0.0, 0.0), fov=(0.55, 0.55))
    ys, xs = pixel_grid(size, size, 0, size, 0, size)
    o, d = generate_rays(cam, size, size, ys, xs, None)
    o3, d3 = o.reshape(-1, 3), d.reshape(-1, 3)
    f0 = _unit(jnp.cross(d3, plane_normal(o3, d3)))
    f_obs, d1, x1, _ = transport_polarization_ode(
        kerr_ks_metric(0.5, a), o3, d3, f0, n_steps=n_steps, dt=0.08,
        r_stop=2.0 * D, dt_boost=16.0, r_ref=1.6)
    esc = np.asarray(jnp.linalg.norm(x1, axis=-1) >= 0.99 * 2 * D)
    f_pred = transport_polarization(o3, d3, f0, d1)
    cosang = jnp.clip(jnp.sum(f_obs * f_pred, -1), -1.0, 1.0)
    sgn = jnp.sign(jnp.sum(jnp.cross(f_pred, f_obs) * d1, -1))
    ang = np.asarray(jnp.arccos(cosang) * sgn)
    return np.where(esc, ang, np.nan).reshape(size, size)


# the a = 0 maps against each other, pixel by pixel (chip_smoke's TOL_POL
# for the card's map against the CPU's)
TOL_A0 = 1e-3


@pytest.mark.parametrize("a", [0.0, 0.25, 0.45])
def test_faraday_excess_map_matches_jax(a):
    """24^2 at 300 steps, the escaped rays the same but at most 2.  A
    spinning hole's excess rms within 5% of the JAX script's.  At a = 0
    there is no excess: each angle is the arccos of a cosine k float32
    ulps below 1, sqrt(2 k) 2^-12 rad (0, 3.5e-4, 4.9e-4, ...), so the two
    rms are rounding noise; there both maps hold the script's gate (rms <
    2e-3) and agree pixel by pixel within TOL_A0."""
    got = kerr_faraday.excess_map(a, 24, 300, "cpu")
    want = jax_excess_map(a, 24, 300)
    assert got.shape == want.shape == (24, 24)
    assert int((np.isnan(got) != np.isnan(want)).sum()) <= 2
    rms = [float(np.sqrt(np.nanmean(m ** 2))) for m in (got, want)]
    if a == 0.0:
        assert max(rms) < 2e-3, rms
        both = np.isfinite(got) & np.isfinite(want)
        assert np.abs(got - want)[both].max() <= TOL_A0
    else:
        assert rms[0] == pytest.approx(rms[1], rel=0.05), rms


def test_examples_import_no_jax():
    """The four examples and utils.profiling import neither jax nor optax
    nor anything of the JAX package."""
    code = (
        "import sys\n"
        "import blackhole_geodesic_calculator_tpu_torch.utils.profiling\n"
        "from blackhole_geodesic_calculator_tpu_torch.examples import (\n"
        "    fit_orbit, kerr_faraday, parameter_study, tutorial)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'optax', 'blackhole_geodesic_calculator_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=300)


@pytest.mark.parametrize("name", ["parameter_study", "kerr_faraday",
                                  "fit_orbit", "tutorial"])
def test_examples_need_a_card_unless_told(name, tmp_path):
    """Without --device cpu an example runs on the card: on a host
    without CUDA its main raises, nothing falls back to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    mod = importlib.import_module(
        f"blackhole_geodesic_calculator_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(["--outdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
