"""The port's profiler spans (``utils.profiling.annotate``): a Trainer step
and a render open their ``bhgc.*`` spans, each inside its parent, as many
times as the step and the render run their layers; with no profiler
running ``annotate`` enters no ``record_function``.  The CUDA case, which
skips without a card (decided in a fixture), checks the integrator's
adjoint span on autograd's device thread."""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.utils import profiling  # noqa: E402

# each span and the span it opens inside
PARENT = {
    "bhgc.step.scene": "bhgc.step",
    "bhgc.step.render": "bhgc.step",
    "bhgc.step.loss": "bhgc.step",
    "bhgc.step.backward": "bhgc.step",
    "bhgc.step.update": "bhgc.step",
    "bhgc.render.rays": "bhgc.step.render",
    "bhgc.render.integrate": "bhgc.step.render",
    "bhgc.render.shade": "bhgc.step.render",
    "bhgc.texture.backward": "bhgc.step.backward",
    "bhgc.integrate.backward": "bhgc.step.backward",
}
RENDER = ("bhgc.render.rays", "bhgc.render.integrate", "bhgc.render.shade")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sky(device):
    h, w = 8, 16
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    uc = 0.5 + 0.5 * np.sin(2.0 * np.pi * u) * np.sin(np.pi * v)
    return torch.as_tensor(np.stack([
        np.broadcast_to(uc, (h, w)), np.broadcast_to(v, (h, w)),
        0.5 * np.ones((h, w))], -1), dtype=torch.float32, device=device)


def config(samples):
    return P.RenderConfig(
        width=12, height=10, samples=samples, lam_max=40.0,
        integrator=P.IntegratorConfig(n_steps=30, dt=0.3))


def camera(device):
    return P.Camera.make(position=(0.0, 0.0, 12.0), fov=(0.8, 0.8),
                         device=device)


def spans_of(logdir):
    """The program's spans of the newest trace under ``logdir``:
    (name, start, end)."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in profiling._load_trace_events(str(logdir))
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("bhgc.")]


def assert_nested(spans):
    """Every span lies inside a span of its parent's name."""
    for name, a, b in spans:
        parent = PARENT.get(name)
        if parent is None:
            continue
        assert any(n == parent and pa <= a and b <= pb
                   for n, pa, pb in spans), (name, parent)


def traced_steps(tmp_path, device, n_steps):
    """``n_steps`` multisampled Trainer steps with the mask, the clip and
    a learned sky and mass, traced; returns the spans."""
    cfg = config(samples=2)
    target = P.render_image(
        P.Scene(bh=P.BlackHole.make(mass=0.5, device=device),
                background=sky(device)), camera(device), cfg,
        draws=torch.rand((2, 2, 10, 12), device=device))

    def param_fn(p):
        scene = P.Scene(bh=P.BlackHole.make(mass=0.0, device=device),
                        background=p["sky"])
        return dataclasses.replace(scene, bh=dataclasses.replace(
            scene.bh, mass=p["mass"])), camera(device)

    tr = P.Trainer(cfg=cfg, param_fn=param_fn,
                   optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                   clip_norm=0.5, mask_critical=0.25)
    params = {"mass": torch.tensor(0.45, device=device, requires_grad=True),
              "sky": (0.9 * sky(device)).requires_grad_(True)}
    opt = tr.init(params)
    flat, ys, xs = tr.shard_target(target)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    with profiling.trace(str(tmp_path)):
        for _ in range(n_steps):
            params, opt, loss = tr.step(
                params, opt, flat, ys, xs,
                torch.rand((2, 2, 10, 12), generator=gen, device=device))
    assert torch.isfinite(loss)
    return spans_of(tmp_path)


def test_trainer_step_opens_each_span_in_its_parent(tmp_path):
    """Two steps: one span of each phase a step, the samples in one
    render (one of each render span), one texture backward (the sky's)."""
    spans = traced_steps(tmp_path, "cpu", 2)
    counts = collections.Counter(n for n, _, _ in spans)
    want = {n: 2 for n in PARENT if n != "bhgc.integrate.backward"}
    want["bhgc.step"] = 2
    assert dict(counts) == want
    assert_nested(spans)


def test_render_image_opens_the_render_spans(tmp_path):
    """``render_image`` renders all its samples through one
    ``render_rays`` call: one of each render span, in turn."""
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"),
                    background=sky("cpu"))
    with profiling.trace(str(tmp_path)):
        P.render_image(scene, camera("cpu"), config(samples=2))
    spans = spans_of(tmp_path)
    assert collections.Counter(n for n, _, _ in spans) == {
        n: 1 for n in RENDER}
    order = sorted(spans, key=lambda s: s[1])
    for (n0, _, b0), (n1, a1, _) in zip(order, order[1:]):
        assert b0 <= a1, (n0, n1)


def test_annotate_enters_no_record_function_without_a_profiler(
        monkeypatch, tmp_path):
    """With no profiler running, ``annotate`` hands back one shared null
    context and never builds a ``record_function``, through a whole render
    too; under a profiler it opens one by the span's name."""
    entered = []

    def recorder(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", recorder)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.annotate("bhgc.a") is profiling.annotate("bhgc.b")
    with profiling.annotate("bhgc.a"):
        pass
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"),
                    background=sky("cpu"))
    P.render_image(scene, camera("cpu"), config(samples=1))
    assert entered == []
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("bhgc.a"):
            pass
    assert entered == ["bhgc.a"]


def test_cuda_step_opens_the_adjoint_span(card, tmp_path):
    """On the card the integrator's gradient runs through RK4Adjoint,
    whose backward runs on autograd's device thread: its span opens once
    a step, inside the step's backward span.  The shading kernel's
    backward opens the texture span twice a step, around the sky's
    scratch fill and around its scatter."""
    spans = traced_steps(tmp_path, card, 2)
    counts = collections.Counter(n for n, _, _ in spans)
    assert counts["bhgc.integrate.backward"] == 2
    assert counts["bhgc.texture.backward"] == 4
    assert counts["bhgc.step"] == 2
    assert_nested(spans)
