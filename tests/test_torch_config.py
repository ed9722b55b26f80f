"""PyTorch port against the JAX package: the JSON scene config
(``io_/config.py``: ``SceneConfig``, ``load_config``, ``build_scene``,
``build_limited``).

One JSON file configures either package: the dataclass has the JAX
package's fields, order and defaults, and every ``examples/*.json``
builds in both, the port's tree equal to ``convert.*_from_reference`` of
the JAX tree leaf for leaf.  The sphere-texture resize is held to
``jax.image.resize(..., "linear")`` within 1e-6, growing and shrinking;
twins of tests/test_io_cli.py's config checks hold the rejections and the
surrogate mismatch.
"""

import dataclasses
import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.io_ import config as JC  # noqa: E402
from blackhole_geodesic_calculator_tpu.models import surrogate as JS  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.io_ import (  # noqa: E402
    SceneConfig, build_scene, load_config)
from blackhole_geodesic_calculator_tpu_torch.io_ import config as PC  # noqa: E402

EXAMPLES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "*.json")))


def assert_tree_equal(a, b, where="tree"):
    """Two dataclass trees of this package: the same fields, tensors equal
    bit for bit (dtype, shape, values), everything else equal."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            assert_tree_equal(getattr(a, f.name), getattr(b, f.name),
                              f"{where}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def test_scene_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default, f.default_factory)
          for f in dataclasses.fields(JC.SceneConfig)]
    pf = [(f.name, f.default, f.default_factory)
          for f in dataclasses.fields(SceneConfig)]
    assert pf == jf
    assert json.loads(SceneConfig().to_json()) == json.loads(
        JC.SceneConfig().to_json())


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_builds_as_the_jax_tree(path):
    """load_config + build_scene of each shipped example in both packages:
    the port's (Scene, Camera, RenderConfig) equals convert's twin of the
    JAX package's, and build_limited's LimitedConfig equals its twin."""
    cfg = load_config(path)
    jcfg = JC.load_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    scene, cam, rcfg = build_scene(cfg, device="cpu")
    jscene, jcam, jrcfg = JC.build_scene(jcfg)
    assert_tree_equal(scene, convert.scene_from_reference(jscene, "cpu"),
                      "scene")
    assert_tree_equal(cam, convert.camera_from_reference(jcam, "cpu"), "cam")
    assert rcfg == convert.render_config_from_reference(jrcfg)
    lcfg, table = PC.build_limited(cfg, device="cpu")
    jlcfg, jtable = JC.build_limited(jcfg)
    assert lcfg == convert.limited_config_from_reference(jlcfg)
    assert table is None and jtable is None


@pytest.mark.parametrize("src,dst", [((6, 10), (13, 23)),
                                     ((40, 70), (13, 23)),
                                     ((6, 70), (13, 23)),
                                     ((64, 128), (24, 40))],
                         ids=["grow", "shrink", "mixed", "shrink-more"])
def test_sphere_texture_resize_matches_jax(src, dst):
    tex = np.random.default_rng(1).random(src + (3,)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(tex), dst + (3,),
                                      "linear"))
    out = PC.resize_linear(tex, *dst)
    assert out.shape == dst + (3,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_spheres_of_different_texture_sizes_build_as_jax(tmp_path):
    """A registry texture and a small image file on two spheres: both
    packages resize the smaller to the larger's shape."""
    img = np.random.default_rng(2).random((20, 30, 3)).astype(np.float32)
    from blackhole_geodesic_calculator_tpu_torch.io_ import write_png

    path = write_png(str(tmp_path / "tex.png"), img)
    d = dict(width=8, height=8, spheres=[
        {"center": [3.0, 0.0, -8.0], "radius": 1.0, "texture": "moon"},
        {"center": [-3.0, 0.0, -8.0], "radius": 0.5, "texture": path,
         "emission": 0.0, "albedo": [0.2, 0.4, 0.6]},
        {"center": [0.0, 3.0, -8.0], "radius": 0.7,
         "texture": [0.1, 0.9, 0.3]}],
        lights=[[10.0, 10.0, 10.0]], disk_on=True, spin=0.3)
    scene, _, _ = build_scene(SceneConfig(**d), device="cpu")
    jscene, _, _ = JC.build_scene(JC.SceneConfig(**d))
    ref = convert.scene_from_reference(jscene, "cpu")
    assert scene.spheres.texture.shape == (3, 512, 1024, 3)
    torch.testing.assert_close(scene.spheres.texture, ref.spheres.texture,
                               rtol=0, atol=1e-6)
    scene.spheres.texture = ref.spheres.texture
    assert_tree_equal(scene, ref, "scene")


def test_infinite_budgets_reach_the_port_as_math_inf():
    cfg = SceneConfig(width=8, height=8, integration_depth=0.0,
                      method="dopri", max_integration_step=0.0)
    _, _, rcfg = build_scene(cfg, device="cpu")
    assert rcfg.lam_max == math.inf and type(rcfg.lam_max) is float
    assert rcfg.integrator.max_step == math.inf
    assert type(rcfg.integrator.max_step) is float
    _, _, jrcfg = JC.build_scene(JC.SceneConfig(**dataclasses.asdict(cfg)))
    assert rcfg == convert.render_config_from_reference(jrcfg)
    _, _, rk = build_scene(SceneConfig(method="rk4",
                                       max_integration_step=0.2), "cpu")
    assert rk.integrator.max_step == math.inf


@pytest.mark.parametrize("name,want", [("auto", "auto"), ("pallas", "cuda"),
                                       ("scan", "torch"), ("cuda", "cuda"),
                                       ("torch", "torch")])
def test_backend_names_map_through_convert(name, want):
    _, _, rcfg = build_scene(SceneConfig(width=8, height=8, backend=name),
                             device="cpu")
    assert rcfg.integrator.backend == want
    assert PC.integrator_backend(name) == want


def test_config_roundtrip_and_rejections(tmp_path):
    """Twin of test_scene_config_roundtrip_and_build and
    test_config_rejects_unknown_engine_and_metric."""
    cfg = SceneConfig(
        mass=0.7, width=32, height=24, disk_on=True, spin=0.0,
        spheres=[{"center": [0.0, 0.0, -12.0], "radius": 1.0,
                  "texture": [0.2, 1.0, 0.2]}],
        lights=[[10.0, 10.0, 10.0]])
    p = str(tmp_path / "scene.json")
    with open(p, "w") as f:
        f.write(cfg.to_json())
    cfg2 = load_config(p)
    assert json.loads(cfg2.to_json()) == json.loads(cfg.to_json())
    scene, cam, rcfg = build_scene(cfg2, device="cpu")
    assert float(scene.bh.mass) == pytest.approx(0.7)
    assert scene.disk is not None and scene.spheres is not None
    assert scene.lights is not None
    assert rcfg.width == 32 and rcfg.height == 24
    # '__' keys are comments; unknown keys are refused
    assert SceneConfig.from_dict({"__comment": "x", "mass": 0.3}).mass == 0.3
    with pytest.raises(ValueError, match="unknown config keys"):
        SceneConfig.from_dict({"no_such_key": 1})
    with pytest.raises(ValueError, match="engine"):
        build_scene(SceneConfig(engine="blender"), device="cpu")
    with pytest.raises(ValueError, match="metric"):
        build_scene(SceneConfig(metric="kerr-newman"), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        build_scene(SceneConfig(backend="tpu"), device="cpu")
    # metric='flat': mass 0 and no spin
    flat, _, _ = build_scene(SceneConfig(metric="flat", spin=0.4), "cpu")
    assert float(flat.bh.mass) == 0.0 and flat.bh.spin is None


def test_build_scene_defaults_to_the_card():
    """Without a device the scene goes to the card: on a host without CUDA
    that raises, nothing falls back to the CPU."""
    cfg = SceneConfig(width=8, height=8)
    if torch.cuda.is_available():
        scene, cam, _ = build_scene(cfg)
        assert scene.bh.mass.is_cuda and cam.position.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_scene(cfg)


def jax_surrogate(path, spin=0.45, r=12.0, r_exit=13.2):
    scfg = JS.SurrogateConfig(width=32, depth=2, r_influence=r)
    sur = JS.NeuralSurrogate(params=JS.init_params(jax.random.PRNGKey(0),
                                                   scfg),
                             mass=jnp.asarray(0.5), spin=jnp.asarray(spin),
                             r_influence=jnp.asarray(r),
                             r_exit=jnp.asarray(r_exit))
    JS.save_surrogate(path, sur)
    return sur


def test_jax_saved_surrogate_loads():
    """build_limited loads a surrogate npz the JAX package wrote: the
    same weights, and the same trace on the same rays within float32
    rounding."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "s.npz")
        jsur = jax_surrogate(p)
        cfg = SceneConfig(engine="limited", approx=True, mass=0.5,
                          spin=0.45, ratio_obj_to_blackhole=12.0,
                          surrogate_path=p)
        lcfg, table = PC.build_limited(cfg, device="cpu")
    assert lcfg.approx and lcfg.r_influence == 12.0
    for (w, b), (jw, jb) in zip(table.params, jsur.params):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    entry = (-12.0 * d + rng.normal(size=(64, 3)) * 0.5).astype(np.float32)
    loc, dirs, cap = table.trace(torch.as_tensor(entry), torch.as_tensor(d))
    jloc, jdirs, jcap = jsur.trace(jnp.asarray(entry), jnp.asarray(d))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), atol=1e-4)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), atol=1e-5)


@pytest.mark.parametrize("field,value", [("ratio_obj_to_blackhole", 20.0),
                                         ("mass", 0.7), ("spin", 0.2),
                                         ("exit_tolerance", 0.3)])
def test_surrogate_mismatch_rejected(tmp_path, field, value):
    """Twin of test_surrogate_path_mismatch_rejected: a surrogate npz that
    does not match the config is refused, the message naming the field
    and the port's CLI."""
    p = str(tmp_path / "s.npz")
    jax_surrogate(p)
    ok = dict(engine="limited", approx=True, mass=0.5, spin=0.45,
              ratio_obj_to_blackhole=12.0, surrogate_path=p)
    _, table = PC.build_limited(SceneConfig(**ok), device="cpu")
    assert table is not None
    with pytest.raises(ValueError, match=field) as e:
        PC.build_limited(SceneConfig(**dict(ok, **{field: value})),
                         device="cpu")
    assert "bhgc-torch train-surrogate" in str(e.value)
    with pytest.raises(ValueError, match=field):
        JC.build_limited(JC.SceneConfig(**dict(ok, **{field: value})))
