"""The PyTorch port's host-side modules held against the JAX package on the
CPU: rays, noise fields, scene and texture builds, sampling, intersection
and shading.  Inputs come from a numpy seed or from the JAX package's own
configs, converted with ``schwarzschild_tpu_torch.convert``."""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import camera as jcam
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import geometry as jgeo
from schwarzschild_tpu import intersect as jint
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu import shading as jshade
from schwarzschild_tpu import textures as jtex
from schwarzschild_tpu_torch import camera as tcam
from schwarzschild_tpu_torch import configs as tconfigs
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import geometry as tgeo
from schwarzschild_tpu_torch import noise as tnoise
from schwarzschild_tpu_torch import intersect as tint
from schwarzschild_tpu_torch import physics as tphys
from schwarzschild_tpu_torch import shading as tshade
from schwarzschild_tpu_torch import textures as ttex

# Both packages export a function named ``render`` that hides the module.
trender = importlib.import_module("schwarzschild_tpu_torch.render")
jrender = importlib.import_module("schwarzschild_tpu.render")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def demo():
    """The JAX demo scene, camera and textures, and their converted twins."""
    j = dict(scene=jconfigs.demo_scene(), cam=jconfigs.demo_camera(),
             bg=jconfigs.background_texture(),
             tex=jconfigs.demo_texture_stack())
    t = dict(scene=convert.scene(_np(j["scene"]), device="cpu"),
             cam=convert.camera(_np(j["cam"]), device="cpu"),
             bg=convert.texture(_np(j["bg"]), device="cpu"),
             tex=convert.texture_stack(_np(j["tex"]), device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def seeded_rays():
    """Rays from random points around the scene aimed near the demo scene's
    objects, half of them bounded by a random window, half unbounded."""
    rng = np.random.default_rng(7)
    n = 4000
    origin = rng.uniform(-16.0, 16.0, (n, 3)).astype(np.float32)
    centres = np.array([[-10, 0, 0], [0, 0, -10], [0, 0, 0], [0, 12, 0],
                        [1.5, 0, 11], [10.5, 0.5, 0.5]], np.float64)
    target = centres[rng.integers(0, len(centres), n)] + rng.normal(
        scale=2.0, size=(n, 3))
    d = target - origin
    direction = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    window = np.where(rng.random(n) < 0.5, -1.0,
                      rng.uniform(1.0, 40.0, n)).astype(np.float32)
    return origin, direction, window


def _assert_tree_close(a, b, path="", atol=0.0):
    """Leaves of two NamedTuple trees (numpy vs torch) equal in shape and
    dtype kind, floats within ``atol``, the rest exactly."""
    if hasattr(a, "_fields"):
        for f in b._fields:
            _assert_tree_close(getattr(a, f), getattr(b, f), f"{path}.{f}",
                               atol)
        return
    if isinstance(b, tuple):  # a texture's mip levels
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_close(x, y, f"{path}[{i}]", atol)
        return
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, path
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)
    else:
        np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.mark.parametrize("size", [(37, 23), (48, 32)])
def test_pixel_grid_and_rays(demo, size):
    j, t = demo
    W, H = size
    ju, jv = jcam.pixel_grid(W, H)
    tu, tv = tcam.pixel_grid(W, H, device="cpu")
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    jo, jd = jcam.generate_rays(j["cam"], ju, jv, W, H)
    to, td = tcam.generate_rays(t["cam"], tu, tv, W, H)
    assert to.shape == (H, W, 3) and td.shape == (H, W, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("point", [(0.0, 0.0, 0.0), (3.0, -1.0, 2.5)])
def test_look_at_matches(demo, point):
    j, t = demo
    ref = jcam.look_at(j["cam"]._replace(pos=np.float32([4.0, 3.0, 12.0])),
                       point)
    got = tcam.look_at(t["cam"]._replace(pos=_t(np.float32([4.0, 3.0, 12.0]))),
                       point)
    np.testing.assert_allclose(got.axes.numpy(), np.asarray(ref.axes),
                               rtol=0, atol=1e-6)


def test_rk4_step_and_radial_test_match():
    rng = np.random.default_rng(11)
    u = rng.uniform(0.01, 0.6, 1000).astype(np.float32)
    du = rng.uniform(-1.0, 1.0, 1000).astype(np.float32)
    h = rng.uniform(0.01, 0.2, 1000).astype(np.float32)
    for r_s in (1.0, 0.7):
        ref = jphys.rk4_step(u, du, h, np.float32(r_s))
        got = tphys.rk4_step(_t(u), _t(du), _t(h),
                             torch.tensor(r_s, dtype=torch.float32))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    d = rng.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = np.where(rng.random((1000, 1)) < 0.3, d, -d[::-1])
    np.testing.assert_array_equal(
        tphys.is_radial(_t(d), _t(n)).numpy(),
        np.asarray(jphys.is_radial(d, n)))


def test_quaternion_frames_match():
    axis = np.array([1.0, 2.0, -0.5])
    for angle in (0.3, np.pi / 4.0, 2.5):
        ref = jgeo.quat_to_axes(jgeo.angle_axis(angle, axis))
        got = tgeo.quat_to_axes(tgeo.angle_axis(angle, axis))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF, 12345678901])
def test_pixel_hash_bit_equal(seed):
    ref = jrender.pixel_hash_rand_np(53, 29, seed)
    np.testing.assert_array_equal(
        tnoise.pixel_hash_rand(53, 29, seed, device="cpu").numpy(), ref)
    np.testing.assert_array_equal(
        tnoise.pixel_hash_rand(53, 29, seed, device="cpu").numpy(),
        np.asarray(jrender.pixel_hash_rand(53, 29, seed)))


@pytest.mark.parametrize("seed,tile", [(0, (16, 128)), (5, (8, 8)),
                                       (0xFFFFFFFF, (3, 5))])
def test_tile_hash_bit_equal(seed, tile):
    ref = jrender.tile_hash_rand_np(300, 40, seed, tile)
    np.testing.assert_array_equal(
        tnoise.tile_hash_rand(300, 40, seed, tile, device="cpu").numpy(), ref)


@pytest.mark.parametrize("name", ["demo_scene", "_orbiting_planets_scene"])
def test_converted_scene_equals_port_build(name):
    ref = _np(getattr(jconfigs, name)())
    port = getattr(tconfigs, name)(device="cpu")
    # quat_to_axes(angle_axis(...)) runs sin/cos in f32 on both sides.
    _assert_tree_close(ref, port, name, atol=1e-6)
    _assert_tree_close(ref, convert.scene(ref, device="cpu"), name)


@pytest.mark.parametrize("name", ["demo_texture_stack", "planet_texture_stack",
                                  "background_texture", "demo_camera"])
def test_converted_assets_equal_port_build(name):
    ref = _np(getattr(jconfigs, name)())
    port = getattr(tconfigs, name)(device="cpu")
    fields = [f for f in port._fields]
    _assert_tree_close(type(port)(*(getattr(ref, f) for f in fields)), port,
                       name, atol=1e-7)


@pytest.mark.parametrize("name", ["config1_flat", "config2_curved",
                                  "config3_full_scene", "config4_animation"])
def test_config_bundles_equal_port_build(name):
    ref = getattr(jconfigs, name)()
    port = getattr(tconfigs, name)(device="cpu")
    assert sorted(port) == sorted(ref)
    assert dataclasses.asdict(port["cfg"]) == dataclasses.asdict(ref["cfg"])
    assert (port["tex"] is None) == (ref["tex"] is None)
    for key in ("scene", "camera", "background", "tex"):
        if ref.get(key) is not None:
            _assert_tree_close(_np(ref[key]), port[key], f"{name}.{key}",
                               atol=1e-6)
    if "times" in ref:  # the flyby's frame times and conic
        np.testing.assert_array_equal(port["times"], ref["times"])
        assert port["trajectory"] == ref["trajectory"]


def test_render_config_converts():
    ref = st.RenderConfig(width=64, height=48, noise_mode="tile",
                          noise_tile=(8, 8), horizon_softness=0.05,
                          raytrace_type=st.HALF_HEIGHT)
    cfg = convert.render_config(ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.max_angle == ref.max_angle
    assert dataclasses.asdict(sp.RenderConfig()) == dataclasses.asdict(
        st.RenderConfig())


def test_texture_with_mips_round_trips(demo):
    """A JAX texture with mips converts level for level, and samples
    trilinearly as the JAX one does."""
    j, _ = demo
    ref = jtex.with_mips(j["bg"])
    got = convert.texture(_np(ref), device="cpu")
    assert len(got.mips) == len(ref.mips) > 0
    for g, r in zip((got.data,) + got.mips, (ref.data,) + ref.mips):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    u, v = _uv(500, 4)
    lod = np.random.default_rng(5).uniform(0, 8, 500).astype(np.float32)
    np.testing.assert_allclose(
        ttex.sample_texture_trilinear(got, _t(u), _t(v), _t(lod)).numpy(),
        np.asarray(jtex.sample_texture_trilinear(ref, u, v, lod)),
        rtol=1e-6, atol=1e-7)


def _uv(n, seed):
    rng = np.random.default_rng(seed)
    # Spans several repeats on both sides, so the REPEAT wrap is exercised.
    return (rng.uniform(-2.5, 2.5, n).astype(np.float32),
            rng.uniform(-2.5, 2.5, n).astype(np.float32))


def test_sample_texture_matches(demo):
    j, t = demo
    u, v = _uv(5000, 1)
    ref = np.asarray(jtex.sample_texture(j["bg"], u, v))
    got = ttex.sample_texture(t["bg"], _t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_sample_stack_matches(demo):
    j, t = demo
    u, v = _uv(5000, 2)
    idx = np.random.default_rng(3).integers(-1, 3, 5000).astype(np.int32)
    ref = np.asarray(jtex.sample_stack(j["tex"], idx, u, v))
    got = ttex.sample_stack(t["tex"], _t(idx), _t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bilinear_keeps_opaque_alpha_exact(demo):
    _, t = demo
    u, v = _uv(5000, 4)
    got = ttex.sample_stack(t["tex"], torch.zeros(5000, dtype=torch.int32),
                            _t(u) * 0.5, _t(v) * 0.5)
    # The checker fills the whole padded layer, so every sample has alpha 1.
    assert (got[..., 3] == 1.0).all()


@pytest.fixture(scope="module")
def hits(demo, seeded_rays):
    j, t = demo
    o, d, w = seeded_rays
    jh = jint.intersect_scene(o, d, w, j["scene"], 1.0)
    th = tint.intersect_scene(_t(o), _t(d), _t(w), t["scene"], 1.0)
    return jh, th


def test_intersect_scene_matches(hits):
    jh, th = hits
    valid = np.asarray(jh.valid)
    same = (th.valid.numpy() == valid) & (
        th.obj_type.numpy() == np.asarray(jh.obj_type))
    assert same.mean() >= 0.999, same.mean()
    assert valid.mean() > 0.2  # the rays do hit the scene
    m = same & valid
    for f in ("dist", "point", "tangent", "bitangent", "normal", "uv",
              "plane_tex_offset", "plane_tex_size"):
        a = np.asarray(getattr(jh, f))[m]
        b = getattr(th, f).numpy()[m]
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(th.mat_idx.numpy()[m],
                                  np.asarray(jh.mat_idx)[m])


@pytest.mark.parametrize("with_tex", [True, False])
def test_shade_matches(demo, hits, seeded_rays, with_tex):
    j, t = demo
    jh, _ = hits
    _, d, _ = seeded_rays
    th = tint.Hit(*(_t(getattr(jh, f)) for f in tint.Hit._fields))
    ref = np.asarray(jshade.shade(jh, -d, j["scene"],
                                  j["tex"] if with_tex else None))
    got = tshade.shade(th, -_t(d), t["scene"],
                       t["tex"] if with_tex else None).numpy()
    valid = np.asarray(jh.valid)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5, atol=1e-5)


def test_get_background_matches(demo, seeded_rays):
    j, t = demo
    _, d, _ = seeded_rays
    ju, jv = jshade.equirect_uv(d)
    tu, tv = tshade.equirect_uv(_t(d))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    ref = np.asarray(jshade.get_background(j["bg"], d))
    got = tshade.get_background(t["bg"], _t(d)).numpy()
    # atan2/asin differ by an ulp between the two libraries, and a texel
    # step of the star field (~0.8 per texel at 1024 texels) turns that into
    # ~5e-5 on a handful of lanes: all but 0.1% must agree to 1e-5.
    ok = (np.abs(got - ref) <= 1e-5).all(-1)
    assert ok.mean() >= 0.999, ok.mean()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_crosshair_mask_matches():
    ju, jv = jcam.pixel_grid(64, 48)
    ref = np.asarray(jshade.crosshair_mask(ju, jv, 64, 48))
    tu, tv = tcam.pixel_grid(64, 48, device="cpu")
    got = tshade.crosshair_mask(tu, tv, 64, 48).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


def test_to_uint8_matches():
    img = np.random.default_rng(5).uniform(-0.2, 1.2, (7, 9, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(trender.to_uint8(_t(img)).numpy(),
                                  np.asarray(jrender.to_uint8(img)))
