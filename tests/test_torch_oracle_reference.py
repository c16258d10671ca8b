"""The port's pure-Python float64 oracle (``oracle/reference.py``) held
against the JAX package's (both float64 transcriptions of the fragment
shader, fed the same scene tables): ``trace_ray`` and ``render_image``
equal to 1e-12 at 16 x 12 on the demo scene with a test ray bent by the
hole, and on config 3; and against the port's native oracle at
tests/test_native_oracle.py's tolerance (1e-10)."""

import jax
import numpy as np
import pytest

from schwarzschild_tpu import camera as jcam
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import features as jfeatures
from schwarzschild_tpu.oracle import reference as jref
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import oracle
from schwarzschild_tpu_torch.oracle import native, reference

W, H = 16, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def scenes():
    """{name: (JAX OracleScene, port OracleScene, camera arrays)} for the
    demo scene with the test ray of a camera aimed past the hole (it
    bends into the horizon) and for config 3."""
    cam = jconfigs.demo_camera()
    aimed = jcam.look_at(cam, (2.5, 0.0, 0.0))
    tray = jfeatures.calculate_test_ray(aimed)
    sc, bg = jconfigs.demo_scene(), jconfigs.background_texture()
    tex = jconfigs.demo_texture_stack()
    c3 = jconfigs.config3_full_scene()
    out = {}
    for name, (s, b, t, tr, c) in {
            "demo_test_ray": (sc, bg, tex, tray, aimed),
            "config3": (c3["scene"], c3["background"], c3["tex"], None,
                        c3["camera"])}.items():
        port = reference.OracleScene.from_scene(
            convert.scene(_np(s), device="cpu"),
            convert.texture(_np(b), device="cpu"),
            convert.texture_stack(_np(t), device="cpu"),
            test_ray=None if tr is None else convert.test_ray(_np(tr),
                                                              device="cpu"))
        out[name] = (jref.OracleScene.from_scene(s, b, t, test_ray=tr), port,
                     (np.asarray(c.pos), np.asarray(c.axes), float(c.fov)))
    return out


def test_exports():
    assert oracle.render_image is reference.render_image
    assert oracle.OracleScene is reference.OracleScene is native.OracleScene
    assert {"trace_ray", "render_pixel"} <= set(oracle.__all__)


def test_from_scene_tables_equal_jax(scenes):
    for jo, to, _ in scenes.values():
        for field in ("materials", "spheres", "planes", "cylinders",
                      "boxes"):
            a, b = getattr(jo, field), getattr(to, field)
            assert a.keys() == b.keys()
            for k in a:
                assert np.asarray(a[k]).dtype == b[k].dtype, (field, k)
                np.testing.assert_array_equal(a[k], b[k])
        for field in ("background", "tex_data", "test_ray_points",
                      "test_ray_flat_origin", "test_ray_flat_dir"):
            a, b = getattr(jo, field), getattr(to, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert len(scenes["demo_test_ray"][1].test_ray_points) > 10


@pytest.mark.parametrize("name", ["demo_test_ray", "config3"])
def test_trace_ray_matches_jax(scenes, name):
    jo, to, (pos, axes, _) = scenes[name]
    rng = np.random.default_rng(5)
    dirs = [axes @ np.array([*rng.uniform(-0.6, 0.6, 2), 1.0])
            for _ in range(8)]
    if to.test_ray_points is not None:
        # Aimed at the middle of the test ray's fifth segment, where the
        # bent and the straight tube still run side by side: a tube.
        dirs.append(to.test_ray_points[4:6].mean(0) - pos)
    for d in dirs:
        d = d / np.linalg.norm(d)
        got = reference.trace_ray(to, pos, d)
        np.testing.assert_allclose(got, jref.trace_ray(jo, pos, d),
                                   rtol=0, atol=1e-12)
    if to.test_ray_points is not None:
        assert any(np.array_equal(got, c) for c in (
            reference.TEST_RAY_CURVED_COLOR, reference.TEST_RAY_FLAT_COLOR))


@pytest.mark.parametrize("name,kwargs", [
    ("demo_test_ray", dict(percent_black=-1.0)),
    ("config3", dict(percent_black=-1.0)),
    ("config3", dict(percent_black=-1.0, raytrace_type=2, crosshair=True)),
    ("config3", dict(percent_black=0.5, noise_mode="hash", noise_seed=5)),
], ids=["demo_test_ray", "config3", "config3_half_width_crosshair",
        "config3_hash_noise"])
def test_render_image_matches_jax(scenes, name, kwargs):
    jo, to, cam = scenes[name]
    got = reference.render_image(to, *cam, W, H, **kwargs)
    ref = jref.render_image(jo, *cam, W, H, **kwargs)
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_native_matches_python_oracle(scenes):
    """The port's two oracles agree to round-off (the native one draws no
    test ray, so on config 3)."""
    _, to, cam = scenes["config3"]
    for kwargs in (dict(percent_black=-1.0),
                   dict(percent_black=0.75, noise_mode="hash", noise_seed=5)):
        py = reference.render_image(to, *cam, W, H, **kwargs)
        nat = native.render_image(to, *cam, W, H, **kwargs)
        np.testing.assert_allclose(nat, py, rtol=1e-10, atol=1e-10)
    with pytest.raises(NotImplementedError):
        native.render_image(scenes["demo_test_ray"][1], *cam, W, H)
