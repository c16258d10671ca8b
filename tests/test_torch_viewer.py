"""The port's viewer engine (``schwarzschild_tpu_torch.viewer``): the seven
checks of tests/test_viewer.py on the port, and parity with the JAX
package's viewer.  The states that SELFTEST_SCRIPT's keys and flyby ticks
reach equal the JAX viewer's bit for bit (float32 pos, axes and fov),
from the JAX initial state or from the port's; ansi_frame, hud and
decode_keys build the same strings; and the geometry and physics helpers
the viewer stands on match the JAX package's exactly, or within 1e-6
where an operation differs (a sin or cos of torch against XLA's), as
the numpy hash fields do bit for bit."""

import importlib
import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from schwarzschild_tpu import geometry as jgeo
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu import viewer as jviewer
from schwarzschild_tpu_torch import camera as cam_mod
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import geometry as tgeo
from schwarzschild_tpu_torch import physics as tphys
from schwarzschild_tpu_torch import viewer

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float32)


def _equal_states(a, b):
    """A JAX viewer state and a port one are equal: float32 camera fields
    bit for bit, and every flag."""
    for f in ("pos", "axes", "fov"):
        ja, tb = _host(getattr(a.cam, f)), _host(getattr(b.cam, f))
        assert ja.tobytes() == tb.tobytes(), (f, ja, tb)
    assert (a.raytrace_type, a.test_ray, a.flyby_t, a.quit) == (
        b.raytrace_type, b.test_ray, b.flyby_t, b.quit)


# --- the checks of tests/test_viewer.py, on the port ----------------------


def test_move_keys_translate_along_camera_frame():
    s = viewer.initial_state()
    fwd, right, p0 = (_host(x) for x in (s.cam.forward, s.cam.right,
                                         s.cam.pos))
    s2 = viewer.apply_key(s, "w")
    np.testing.assert_allclose(_host(s2.cam.pos),
                               p0 + viewer.MOVE_STEP * fwd, rtol=1e-6)
    s3 = viewer.apply_key(s, "d")
    np.testing.assert_allclose(_host(s3.cam.pos),
                               p0 + viewer.MOVE_STEP * right, rtol=1e-6)
    s4 = viewer.apply_key(viewer.apply_key(s, "w"), "s")
    np.testing.assert_allclose(_host(s4.cam.pos), p0, atol=1e-5)


def test_arrow_keys_rotate_and_preserve_orthonormality():
    s = viewer.initial_state()
    for k in ("left", "up", "right", "right", "down", "left"):
        s = viewer.apply_key(s, k)
    axes = _host(s.cam.axes)
    np.testing.assert_allclose(axes.T @ axes, np.eye(3), atol=1e-5)
    det0 = float(np.linalg.det(_host(viewer.initial_state().cam.axes)))
    assert abs(np.linalg.det(axes) - det0) < 1e-5


def test_mode_fov_testray_quit_keys():
    s = viewer.initial_state()
    assert viewer.apply_key(s, "3").raytrace_type == cam_mod.HALF_WIDTH
    assert viewer.apply_key(s, "1").raytrace_type == cam_mod.CURVED
    f0 = float(s.cam.fov)
    assert float(viewer.apply_key(s, "+").cam.fov) == f0 - viewer.FOV_STEP
    assert float(viewer.apply_key(s, "-").cam.fov) == f0 + viewer.FOV_STEP
    assert viewer.apply_key(s, "r").test_ray
    assert not viewer.apply_key(viewer.apply_key(s, "r"), "r").test_ray
    assert viewer.apply_key(s, "q").quit
    assert viewer.apply_key(s, "esc").quit
    assert viewer.apply_key(s, "?") is s


def test_flyby_follows_trajectory_then_releases():
    s = viewer.apply_key(viewer.initial_state(), "h")
    assert s.flyby_t == 0.0
    s = viewer.advance_flyby(s, 0.5 * cam_mod.HYPERBOLIC_TRAJECTORY_DURATION)
    assert abs(s.flyby_t - 0.5) < 1e-9
    base = cam_mod.make_camera((0.0, 2.0, 15.0), device="cpu")
    expect = cam_mod.hyperbolic_trajectory(base, 30.0, 10.0, 0.5)
    np.testing.assert_allclose(_host(s.cam.pos), _host(expect.pos),
                               rtol=1e-6)
    assert s.cam.pos.device.type == "cpu"
    s = viewer.advance_flyby(s, cam_mod.HYPERBOLIC_TRAJECTORY_DURATION)
    assert s.flyby_t is None
    s2 = viewer.apply_key(viewer.apply_key(viewer.initial_state(), "h"), "w")
    assert s2.flyby_t is None


def test_decode_keys_arrows_and_escape():
    assert viewer.decode_keys(b"wasd") == ["w", "a", "s", "d"]
    assert viewer.decode_keys(b"\x1b[A\x1b[B\x1b[C\x1b[D") == [
        "up", "down", "right", "left"]
    assert viewer.decode_keys(b"\x1b") == ["esc"]
    assert viewer.decode_keys(b"W") == ["w"]


def test_ansi_frame_encodes_half_blocks():
    img = np.zeros((4, 3, 4), np.float32)
    img[0] = [1.0, 0.0, 0.0, 1.0]
    img[1] = [0.0, 0.0, 1.0, 1.0]
    out = viewer.ansi_frame(img, status="hud")
    assert out.startswith("\x1b[H")
    assert "\x1b[38;2;255;0;0m" in out
    assert "\x1b[48;2;0;0;255m" in out
    assert out.count("▀") == 6
    assert out.rstrip().endswith("hud")
    assert out.count("\x1b[38;2;255;0;0m") == 1
    # A tensor and a uint8 frame encode alike.
    assert viewer.ansi_frame(torch.from_numpy(img), "hud") == out
    u8 = (np.clip(img[..., :3], 0, 1) * 255 + 0.5).astype(np.uint8)
    assert viewer.ansi_frame(u8, "hud") == out


def test_hud_mentions_mode_and_fps():
    line = viewer.hud(viewer.initial_state(), 10.0)
    assert "CURVED" in line and "100 FPS" in line


# --- parity with the JAX viewer --------------------------------------------


def _play(v, state, script, dt=0.05):
    """Every state of a scripted run, as run_script plays it."""
    out = [state]
    for k in script:
        state = v.advance_flyby(v.apply_key(state, k), dt)
        out.append(state)
        if state.quit:
            break
    return out


def test_selftest_script_is_the_jax_viewers():
    port = _example("live_viewer_torch")
    assert port.SELFTEST_SCRIPT == _example("live_viewer").SELFTEST_SCRIPT


@pytest.mark.parametrize("start", ["initial", "converted"])
def test_selftest_states_equal_jax(start):
    """SELFTEST_SCRIPT's keys with run_script's 0.05 s flyby tick: every
    state equals the JAX viewer's bit for bit, from the port's own initial
    state or from the JAX one converted (convert.viewer_state)."""
    script = _example("live_viewer_torch").SELFTEST_SCRIPT
    j0 = jviewer.initial_state()
    t0 = (viewer.initial_state() if start == "initial"
          else convert.viewer_state(
              j0.replace(cam=jax.tree.map(np.asarray, j0.cam))))
    jstates = _play(jviewer, j0, script)
    tstates = _play(viewer, t0, script)
    assert len(jstates) == len(tstates) == len(script) + 1
    for a, b in zip(jstates, tstates):
        _equal_states(a, b)
    assert any(s.flyby_t is not None for s in tstates)


def test_flyby_ticks_match_jax():
    """A whole key-H flyby in 0.13 s ticks: positions within 1e-6 of the
    JAX viewer's (torch's float32 cos of the trajectory time can differ
    from XLA's by an ulp), and the flyby releases at the same tick."""
    j = jviewer.apply_key(jviewer.initial_state(), "h")
    t = viewer.apply_key(viewer.initial_state(), "h")
    for _ in range(60):
        j, t = jviewer.advance_flyby(j, 0.13), viewer.advance_flyby(t, 0.13)
        assert j.flyby_t == t.flyby_t
        if j.flyby_t is None:
            break
        np.testing.assert_allclose(_host(t.cam.pos), _host(j.cam.pos),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_host(t.cam.axes), _host(j.cam.axes),
                                   rtol=0, atol=1e-6)
    assert j.flyby_t is None


def test_strings_equal_jax():
    rng = np.random.default_rng(2)
    img = rng.random((7, 5, 4)).astype(np.float32)
    img[2:4] = 0.25  # a run of one colour
    assert viewer.ansi_frame(img, "x") == jviewer.ansi_frame(img, "x")
    u8 = (rng.random((6, 9, 3)) * 255).astype(np.uint8)
    assert viewer.ansi_frame(u8) == jviewer.ansi_frame(u8)
    raw = b"wasd\x1b[A\x1b[Dq\x1bZ+-=1234hr\x1b[C"
    assert viewer.decode_keys(raw) == jviewer.decode_keys(raw)
    script = _example("live_viewer_torch").SELFTEST_SCRIPT
    for a, b in zip(_play(jviewer, jviewer.initial_state(), script),
                    _play(viewer, viewer.initial_state(), script)):
        for ms in (0.37, 16.6, 2500.0):
            assert viewer.hud(b, ms) == jviewer.hud(a, ms)


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    axis = rng.normal(size=3).astype(np.float32)
    for ang in (math.radians(4.0), -math.radians(4.0), 1.3):
        got = tgeo.rotate_vector(ang, torch.from_numpy(v),
                                 torch.from_numpy(axis)).numpy()
        ref = np.asarray(jgeo.rotate_vector(ang, v, axis))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tgeo.rotate_vector(0.5, torch.from_numpy(v)).numpy(),
        tgeo.rotate_vector(0.5, torch.from_numpy(v),
                           torch.tensor([0.0, 1.0, 0.0])).numpy())
    a, b = v[:3], v[3:]
    np.testing.assert_array_equal(
        tgeo.distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jgeo.distance(a, b)))
    np.testing.assert_array_equal(tgeo.IDENTITY_AXES, jgeo.IDENTITY_AXES)

    axes = np.asarray(jgeo.gram_schmidt(rng.normal(size=(3, 3)).astype(
        np.float32)))
    jt = jgeo.make_transform((1.0, 2.0, 3.0), axes)
    tt = convert.transform(jax.tree.map(np.asarray, jt), device="cpu")
    assert isinstance(tt, tgeo.Transform)
    made = tgeo.make_transform((1.0, 2.0, 3.0), axes, device="cpu")
    for f in ("pos", "axes"):
        np.testing.assert_array_equal(getattr(made, f).numpy(),
                                      np.asarray(getattr(jt, f)))
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    np.testing.assert_array_equal(
        tgeo.make_transform(device="cpu").axes.numpy(), np.eye(3))
    for name in ("right", "up", "forward"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    for name in ("with_forward_from_right_up", "with_right_from_up_forward",
                 "with_up_from_forward_right"):
        np.testing.assert_allclose(getattr(tt, name)().axes.numpy(),
                                   np.asarray(getattr(jt, name)().axes),
                                   rtol=0, atol=1e-6)
    import schwarzschild_tpu_torch as sp

    assert sp.Transform is tgeo.Transform
    assert sp.make_transform is tgeo.make_transform


def test_physics_helpers_match_jax():
    rng = np.random.default_rng(6)
    origin = rng.normal(size=(9, 3)).astype(np.float32) * 8.0
    direction = rng.normal(size=(9, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    o, d = torch.from_numpy(origin), torch.from_numpy(direction)
    jn, jt = jphys.orbital_plane(origin, direction)
    tn, tt = tphys.orbital_plane(o, d)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    ju, jdu = jphys.initial_conditions(origin, direction, jn, jt)
    tu, tdu = tphys.initial_conditions(o, d, tn, tt)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6)
    np.testing.assert_allclose(tdu.numpy(), np.asarray(jdu), rtol=1e-5,
                               atol=1e-6)
    phi = rng.uniform(0.0, 6.0, 9).astype(np.float32)
    np.testing.assert_allclose(
        tphys.step_size(torch.from_numpy(phi), 3, 4 * math.pi, 100).numpy(),
        np.asarray(jphys.step_size(phi, 3, 4 * math.pi, 100)), rtol=1e-6)
    np.testing.assert_allclose(
        tphys.reconstruct_position(torch.from_numpy(phi), tu, tn, tt).numpy(),
        np.asarray(jphys.reconstruct_position(phi, ju, jn, jt)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,shape,tile", [(0, (13, 7), (4, 3)),
                                             (5, (40, 300), (16, 128)),
                                             (2 ** 32 + 9, (3, 129), (1, 128))])
def test_numpy_hashes_match_jax(seed, shape, tile):
    """The numpy twins of the hash fields: bit-equal to the JAX package's
    numpy twins and to the port's torch fields."""
    from schwarzschild_tpu_torch import noise

    jrender = importlib.import_module("schwarzschild_tpu.render")
    h, w = shape
    got = noise.pixel_hash_rand_np(w, h, seed)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, jrender.pixel_hash_rand_np(w, h, seed))
    np.testing.assert_array_equal(
        got, noise.pixel_hash_rand(w, h, seed, device="cpu").numpy())
    got = noise.tile_hash_rand_np(w, h, seed, tile)
    np.testing.assert_array_equal(
        got, jrender.tile_hash_rand_np(w, h, seed, tile))
    np.testing.assert_array_equal(
        got, noise.tile_hash_rand(w, h, seed, tile, device="cpu").numpy())
