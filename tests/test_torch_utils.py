"""PyTorch port against the JAX package: the subpackages' exports and
``utils/timing.py``.

Each subpackage the host surfaces reach (``scene``, ``camera``, ``io_``,
``utils``) exports the JAX package's names (``utils``' profiler names
from utils/profiling.py on torch.profiler); the CLI and compat export the
JAX modules' public names.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackhole_geodesic_calculator_tpu_torch.utils import (  # noqa: E402
    PhaseTimers, benchmark, timed)
from blackhole_geodesic_calculator_tpu_torch.utils import timing  # noqa: E402

@pytest.mark.parametrize("sub", ["scene", "camera", "io_", "utils"])
def test_subpackage_exports_match_jax(sub):
    jmod = importlib.import_module(f"blackhole_geodesic_calculator_tpu.{sub}")
    pmod = importlib.import_module(
        f"blackhole_geodesic_calculator_tpu_torch.{sub}")
    assert sorted(pmod.__all__) == sorted(jmod.__all__)
    for name in pmod.__all__:
        assert getattr(pmod, name) is not None


@pytest.mark.parametrize("mod", ["compat", "cli"])
def test_host_modules_have_the_jax_names(mod):
    jmod = importlib.import_module(f"blackhole_geodesic_calculator_tpu.{mod}")
    pmod = importlib.import_module(
        f"blackhole_geodesic_calculator_tpu_torch.{mod}")
    want = {n for n, v in vars(jmod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == jmod.__name__}
    assert want and want <= set(vars(pmod))


def test_timers_and_benchmark():
    """Twin of tests/test_io_cli.py::test_timers_and_benchmark."""
    t = PhaseTimers()
    with t.phase("a"):
        pass
    with t.phase("a", sync=True):
        pass
    assert t.count["a"] == 2 and "a" in t.report()

    def f(x):
        return x * 2

    out, dt = timed(f, torch.ones(8))
    assert dt >= 0 and float(out[0]) == 2.0
    out, best = benchmark(f, torch.ones(8), warmup=1, repeat=2)
    assert best >= 0 and float(out[1]) == 2.0


def test_timing_synchronizes_only_cuda_outputs(monkeypatch):
    """timed and benchmark wait for the devices of the CUDA tensors in
    the output (nested in tuples, dicts and dataclasses) and for nothing
    on the CPU."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    timed(lambda: (torch.ones(2), {"a": [torch.zeros(1)]}))
    benchmark(lambda: np.ones(3), warmup=1, repeat=1)
    assert calls == []

    class FakeCuda:
        is_cuda = True
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch, "Tensor", FakeCuda)
    assert timing._cuda_devices({"x": [FakeCuda()]}) == {
        torch.device("cuda", 1)}
    timing.synchronize((FakeCuda(),))
    assert calls == [torch.device("cuda", 1)]
