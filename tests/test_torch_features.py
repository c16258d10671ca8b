"""The debug test ray held against the JAX package on the CPU:
``features.calculate_test_ray`` bit for bit, its tube rows in the scene
march's cylinder table, ``march_scene_torch`` with those rows against the
Pallas ``march_scene`` in interpret mode, and the dense ``render(test_ray=)``
and ``render_fast(test_ray=)`` against the JAX package's dense frame and
against each other."""

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
from schwarzschild_tpu import features as jfeatures
from schwarzschild_tpu import geometry as jgeo
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu.scene import empty_scene as jempty_scene
from schwarzschild_tpu_torch import camera as tcam
from schwarzschild_tpu_torch import configs as tconfigs
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import features as tfeatures
from schwarzschild_tpu_torch import kernel_scene as tks

# Both packages export a function named ``render`` that hides the module.
jtrender = importlib.import_module("schwarzschild_tpu.render")
trender = importlib.import_module("schwarzschild_tpu_torch.render")

DEMO_POS = (0.0, 2.0, 15.0)
# Aim points of cameras at the demo position, with the polyline length the
# JAX function gives: the first and second fall through the horizon, the
# third escapes.
AIMS = {(1.5, 0.0, 0.0): 13, (2.5, 0.0, 0.0): 34, (4.0, 0.0, 0.0): 31}
# A camera that sees the tubes from the side (from the demo position they
# run along the view).
SIDE = dict(pos=(6.0, 3.0, 6.0), look=(1.2, 0.4, 3.0), fov=30.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_camera(aim):
    if aim is None:
        return jconfigs.demo_camera()
    return jcam.look_at(jcam.make_camera(DEMO_POS), aim)


def _side_cameras():
    j = jcam.look_at(jcam.make_camera(SIDE["pos"], fov=SIDE["fov"]),
                     SIDE["look"])
    return j, convert.camera(_np(j), device="cpu")


@pytest.mark.parametrize("aim", [None] + list(AIMS),
                         ids=["demo_radial"] + [str(a[0]) for a in AIMS])
def test_calculate_test_ray_bit_equal(aim):
    """The port's host integration against the JAX package's: every field
    equal bit for bit, from the same camera (the demo camera's ray is
    radial: two points)."""
    jc = _jax_camera(aim)
    ref = jfeatures.calculate_test_ray(jc)
    got = tfeatures.calculate_test_ray(convert.camera(_np(jc), device="cpu"),
                                       device="cpu")
    assert int(got.num_points) == int(ref.num_points) == (
        2 if aim is None else AIMS[aim])
    assert got.num_points.dtype == torch.int32
    for a, b in zip(got, convert.test_ray(_np(ref), device="cpu")):
        assert torch.equal(a, b)


def test_tube_rows_match_jax():
    """The tube rows appended to the cylinder table equal the JAX
    package's (kernel_scene._test_ray_cylinder_rows) within 1e-6: the flat
    tube 1000 long, 12 active segments, inactive rows of height -1 with
    the identity frame; all opaque.  (The integration stops before a point
    inside the horizon, so at the same r_s no segment is extended.)"""
    jc = _jax_camera((1.5, 0.0, 0.0))
    jtr = jfeatures.calculate_test_ray(jc)
    ttr = convert.test_ray(_np(jtr), device="cpu")
    ref = np.asarray(jks._test_ray_cylinder_rows(jtr, 1.0))
    got = tks._test_ray_cylinder_rows(ttr, 1.0)
    assert got.shape == ref.shape == (101, 14)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got[0, 12] == 1000.0 and (got[1:13, 12] > 0).all()
    assert (got[13:, 12] == -1.0).all()
    assert (got[13:, 3:12] == np.eye(3).T.reshape(-1)).all()
    sc = tconfigs.demo_scene(device="cpu")
    tables = tks._pack_scene_smem(sc, None, ttr, 1.0)
    n_scene = sc.cylinders.mat_idx.shape[0]
    assert tables["cylinders"].shape == (n_scene + 101, 15)
    np.testing.assert_array_equal(tables["cylinders"][n_scene:, :14], got)
    assert (tables["cylinders"][n_scene:, 14] == 1.0).all()
    assert (tables["cylinders"][:n_scene, 14] == 0.0).all()
    # The cull's bounds of every row, inactive ones too, are finite: no
    # NaN or negative radius reaches the kernel's shared tables.
    bounds = np.array(tks._row_bounds(tables, 6 * sc.boxes.mat_idx.shape[0])
                      ["rows"]["cylinders"])
    assert np.isfinite(bounds).all() and (bounds[:, 3] > 0).all()


W, H = 24, 16
MARCH_CFG = st.RenderConfig(width=W, height=H, max_steps=20,
                            percent_black=-1.0)


@pytest.fixture(scope="module")
def tube_march():
    """The Pallas scene march (interpret mode) of the side camera's rays on
    the empty scene with the (1.5, 0, 0) camera's test ray as tube rows,
    events on.  Capacity 16 keeps the kernel's unrolled table small (the
    ray has 13 points: 12 active segments, 3 inactive rows, the flat
    tube)."""
    jc, _ = _side_cameras()
    jtr = jfeatures.calculate_test_ray(_jax_camera((1.5, 0.0, 0.0)),
                                       capacity=16)
    u, v = jcam.pixel_grid(W, H)
    o, d = jcam.generate_rays(jc, u, v, W, H)
    active = ~jphys.is_radial(d, jgeo.safe_normalize(o))

    def march(o, d):
        return jks.march_scene(o, d, active, 1.0, jempty_scene(), MARCH_CFG,
                               n_slots=4, interpret=True, test_ray=jtr,
                               events=True)

    ref = jax.jit(march).lower(o, d).compile(
        compiler_options={"xla_backend_optimization_level": 0})(o, d)
    return dict(tr=jtr, o=np.array(o), d=np.array(d),
                active=np.array(active), ref=_np(ref))


def test_march_scene_with_tubes_matches_pallas(tube_march):
    """march_scene_torch with the tube rows against the Pallas kernel:
    status, hit count and event planes equal on every lane, the float
    planes within 2e-3 relative to 1 + |value|; some rays stop on a tube
    (status 4, the tubes being opaque rows)."""
    c = tube_march
    got = tks.march_scene_torch(
        torch.from_numpy(c["o"]), torch.from_numpy(c["d"]),
        torch.from_numpy(c["active"]), 1.0, sp.empty_scene(device="cpu"),
        convert.render_config(MARCH_CFG), 4, None, events=True,
        test_ray=convert.test_ray(c["tr"], device="cpu"))
    ref = c["ref"]
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    np.testing.assert_array_equal(got[4].numpy(), ref[4])
    assert (ref[2] == tks.STATUS_HIT_OPAQUE).sum() > 0
    np.testing.assert_array_equal(got[5]["t_end"].numpy(), ref[5]["t_end"])
    for a, b in zip(got[5]["ssteps"], ref[5]["ssteps"]):
        np.testing.assert_array_equal(a.numpy(), b)
    floats = [(got[0], ref[0]), (got[1], ref[1])] + [
        (x, y) for gs, rs in zip(got[3], ref[3]) for x, y in zip(gs, rs)]
    for a, b in floats:
        assert (np.abs(a.numpy() - b) <= 2e-3 * (1.0 + np.abs(b))).all()


@pytest.fixture(scope="module")
def demo():
    return dict(scene=tconfigs.demo_scene(device="cpu"),
                bg=tconfigs.background_texture(device="cpu"),
                tex=tconfigs.demo_texture_stack(device="cpu"))


TUBE_AIMS = {"13_points": (1.5, 0.0, 0.0), "34_points": (2.5, 0.0, 0.0)}
TUBE_CFG = st.RenderConfig(width=32, height=24, max_steps=40,
                           percent_black=-1.0)


@pytest.fixture(scope="module")
def tube_frames():
    """The demo scene from the side camera at 32x24 with each TUBE_AIMS
    test ray: the JAX package's dense frame (one compile), and the port's
    dense frame, render_fast(test_ray=, n_slots=6) and render_fast without
    the ray, all from the same numpy inputs."""
    jc, cam = _side_cameras()
    j = dict(scene=jconfigs.demo_scene(), bg=jconfigs.background_texture(),
             tex=jconfigs.demo_texture_stack())
    jframe = jax.jit(lambda tr: jtrender.render(
        j["scene"], jc, TUBE_CFG, j["bg"], j["tex"], 1.0, tr))
    args = (convert.scene(_np(j["scene"]), device="cpu"), cam,
            convert.render_config(TUBE_CFG),
            convert.texture(_np(j["bg"]), device="cpu"),
            convert.texture_stack(_np(j["tex"]), device="cpu"), 1.0)
    out = dict(no_tubes=tks.render_fast(*args, n_slots=6))
    for name, aim in TUBE_AIMS.items():
        jtr = jfeatures.calculate_test_ray(_jax_camera(aim))
        tr = convert.test_ray(_np(jtr), device="cpu")
        out[name] = dict(jax=np.array(jframe(jtr)),
                         dense=trender.render(*args, test_ray=tr),
                         fast=tks.render_fast(*args, n_slots=6,
                                              test_ray=tr))
    return out


def _tube_pixels(img):
    """(red, green) pixel counts: the curved and the flat tube's colours."""
    img = torch.as_tensor(img)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    red = (r > 0.99) & (g < 0.01) & (b < 0.01)
    green = (g > 0.99) & (r < 0.01) & (b < 0.01)
    return int(red.sum()), int(green.sum())


@pytest.mark.parametrize("name", list(TUBE_AIMS))
def test_render_test_ray_matches_jax(tube_frames, name):
    """The port's dense render(test_ray=) against the JAX package's: at
    least 99.5% of pixels within 2e-3, a median difference under 5e-4 and
    the same red and green tube pixel counts (both tubes visible); and
    render_fast(test_ray=) against the JAX frame: at least 99% within 2e-3
    (tests/test_kernel_scene.py's test-ray rule), the same tube pixels."""
    f = tube_frames[name]
    ref = f["jax"]
    assert ref.shape == (24, 32, 4)
    red, green = _tube_pixels(ref)
    assert red > 0 and green > 0, (red, green)
    d = np.abs(f["dense"].numpy() - ref).max(-1)
    assert (d < 2e-3).mean() >= 0.995, (d < 2e-3).mean()
    assert np.median(d) < 5e-4, np.median(d)
    assert _tube_pixels(f["dense"]) == (red, green)
    d = np.abs(f["fast"].numpy() - ref).max(-1)
    assert (d < 2e-3).mean() >= 0.99, (d < 2e-3).mean()
    assert _tube_pixels(f["fast"]) == (red, green)


@pytest.mark.parametrize("name", list(TUBE_AIMS))
def test_render_fast_test_ray_matches_dense(tube_frames, name):
    """render_fast(test_ray=, n_slots=6) against the dense render(test_ray=)
    on the demo scene from the side camera at 32x24: at least 99% of pixels
    within 2e-3 (tests/test_kernel_scene.py's test-ray rule), with both
    tubes' colours present."""
    f = tube_frames[name]
    fast, dense = f["fast"], f["dense"]
    d = (fast - dense).abs().amax(-1)
    assert (d < 2e-3).float().mean().item() >= 0.99
    red, green = _tube_pixels(dense)
    assert red > 0 and green > 0, (red, green)
    assert _tube_pixels(fast) == (red, green)
    assert not torch.equal(fast, tube_frames["no_tubes"])


def test_render_fast_test_ray_gradient_is_finite(demo):
    """A gradient frame with tubes: r_s, cam.pos and the background texels
    get finite gradients (inactive chain rows carry the identity frame, so
    no NaN reaches the masked candidates' backward)."""
    _, cam = _side_cameras()
    tr = tfeatures.calculate_test_ray(
        tcam.look_at(tcam.make_camera(DEMO_POS, device="cpu"),
                     torch.tensor((2.5, 0.0, 0.0))), device="cpu")
    cfg = sp.RenderConfig(width=16, height=12, max_steps=30,
                          percent_black=-1.0)
    r_s = torch.tensor(1.0, requires_grad=True)
    pos = cam.pos.clone().requires_grad_(True)
    bg = demo["bg"].data.clone().requires_grad_(True)
    img = tks.render_fast(demo["scene"], cam._replace(pos=pos),
                          dataclasses.replace(cfg), sp.Texture(bg),
                          demo["tex"], r_s, n_slots=6, overflow="ignore",
                          differentiable=True, test_ray=tr)
    grads = torch.autograd.grad(img.sum(), [r_s, pos, bg])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0]) != 0.0
