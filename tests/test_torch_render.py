"""The port's dense differentiable renderer (``render.render``) held against
the JAX package's on the CPU: frames of the demo scene in six
configurations (curved; split screen with the crosshair and hash noise;
the other split with a soft horizon and tile noise; GLSL noise; trilinear
mips; jax.random's "prng" noise), strips
(``rows=``) and chunked marches (``checkpoint_every``) equal to the whole
frame, and autograd gradients against ``jax.grad``.  Each JAX reference is
one compile per module fixture."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu_torch import convert

# The packages' __init__ rebinds ``render`` to the function.
jrender = importlib.import_module("schwarzschild_tpu.render")
trender = importlib.import_module("schwarzschild_tpu_torch.render")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


CFG = st.RenderConfig(width=24, height=16, max_steps=30, percent_black=-1.0,
                      checkpoint_every=10)
VARIANTS = {
    "curved": {},
    "half_width_crosshair_hash": dict(
        raytrace_type=st.HALF_WIDTH, crosshair=True, percent_black=0.5,
        noise_mode="hash"),
    "half_height_soft_tile": dict(
        raytrace_type=st.HALF_HEIGHT, horizon_softness=0.05,
        percent_black=0.5, noise_mode="tile", noise_tile=(4, 8)),
    "glsl": dict(percent_black=0.5, noise_mode="glsl"),
    "trilinear": dict(texture_filter="trilinear"),
    "prng": dict(percent_black=0.5, noise_mode="prng", noise_seed=3),
}


def _cfg(name, **extra):
    return dataclasses.replace(CFG, **VARIANTS[name], **extra)


def _port_cfg(cfg):
    return convert.render_config(cfg)


@pytest.fixture(scope="module")
def demo():
    j = dict(scene=jconfigs.demo_scene(), cam=jconfigs.demo_camera(),
             bg=jconfigs.background_texture(),
             tex=jconfigs.demo_texture_stack())
    t = dict(scene=convert.scene(_np(j["scene"]), device="cpu"),
             cam=convert.camera(_np(j["cam"]), device="cpu"),
             bg=convert.texture(_np(j["bg"]), device="cpu"),
             tex=convert.texture_stack(_np(j["tex"]), device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def jax_frames(demo):
    """The JAX dense frame of every variant, from one jitted function."""
    j, _ = demo

    def frames(cam):
        return [jrender.render(j["scene"], cam, _cfg(name), j["bg"], j["tex"],
                               1.0) for name in VARIANTS]

    out = jax.jit(frames)(j["cam"])
    return dict(zip(VARIANTS, (np.asarray(x) for x in out)))


def _port_frame(t, cfg, **kw):
    return trender.render(t["scene"], t["cam"], _port_cfg(cfg), t["bg"],
                          t["tex"], 1.0, **kw)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_render_matches_jax(demo, jax_frames, name):
    """At least 99.5% of pixels within 2e-3 of the JAX frame and a median
    difference under 5e-4 (tests/test_kernel_scene.py's frame rule); "prng" skips half the
    pixels by jax.random's own field, "trilinear" samples the mips.
    GLSL's hash is not portable (its 43758 amplification turns 1-ulp
    differences of sin, or a fused multiply-add, into other masks; the JAX
    package documents it): that variant is held on the pixels that both
    frames skip or both render (a skipped pixel is exactly 0), which must
    be at least 90% of them."""
    _, t = demo
    got = _port_frame(t, _cfg(name)).numpy()
    ref = jax_frames[name]
    assert got.shape == ref.shape == (16, 24, 4)
    d = np.abs(got - ref).max(-1)
    if name == "glsl":
        same = (got == 0).all(-1) == (ref == 0).all(-1)
        assert same.mean() >= 0.9 and (ref == 0).all(-1).any(), same.mean()
        d = d[same]
    assert (d < 2e-3).mean() >= 0.995, (d < 2e-3).mean()
    assert np.median(d) < 5e-4, np.median(d)


@pytest.mark.parametrize("name", ["curved", "half_width_crosshair_hash",
                                  "glsl"])
def test_rows_equal_the_sliced_frame(demo, name):
    """rows=(r0, r1) renders exactly render(...)[r0:r1]: the noise field and
    the NDC grid are built at full size and sliced."""
    _, t = demo
    cfg = _cfg(name)
    full = _port_frame(t, cfg)
    for r0, r1 in ((0, 5), (5, 16), (7, 8)):
        strip = _port_frame(t, cfg, rows=(r0, r1))
        assert torch.equal(strip, full[r0:r1]), (r0, r1)


def test_checkpointed_march_is_bit_equal(demo):
    """checkpoint_every (chunks under torch.utils.checkpoint) changes no bit
    of the image against the plain loop (checkpoint_every >= max_steps),
    with and without a graph."""
    _, t = demo
    plain = _port_frame(t, dataclasses.replace(CFG, checkpoint_every=30))
    for ck in (5, 10, 15):
        assert torch.equal(_port_frame(
            t, dataclasses.replace(CFG, checkpoint_every=ck)), plain), ck
    r_s = torch.tensor(1.0, requires_grad=True)
    img = trender.render(t["scene"], t["cam"], _port_cfg(CFG), t["bg"],
                         t["tex"], r_s)
    assert torch.equal(img.detach(), plain)
    with pytest.raises(ValueError, match="must divide"):
        _port_frame(t, dataclasses.replace(CFG, checkpoint_every=7))


def test_render_options_refused(demo):
    """An unknown texture filter raises ValueError.  ("prng" noise and
    "trilinear" filtering, once refused here, are held to the JAX frame by
    test_render_matches_jax.)"""
    _, t = demo
    with pytest.raises(ValueError, match="texture_filter"):
        _port_frame(t, dataclasses.replace(CFG, texture_filter="nearest"))


# ---------------------------------------------------------------------------
# Gradients: config 5's scene (the planets, the textured hollow disk) at
# CFG's size, through the chunked march.
# ---------------------------------------------------------------------------

GRAD_CFG = dataclasses.replace(CFG, max_steps=20)
GRAD_NAMES = ("r_s", "cam.pos", "cam.fov", "background", "outer_radius")


@pytest.fixture(scope="module")
def grad_case():
    j = jconfigs.config5_inverse()
    w = np.random.default_rng(5).random((16, 24, 4)).astype(np.float32)
    sc = j["scene"]

    def loss(r_s, pos, fov, bg_data, outer):
        s2 = sc._replace(hollow_disks=sc.hollow_disks._replace(
            outer_radius=outer))
        img = jrender.render(s2, j["camera"]._replace(pos=pos, fov=fov),
                             GRAD_CFG, j["background"]._replace(data=bg_data),
                             j["tex"], r_s)
        return jnp.sum(img * w)

    args = (jnp.float32(1.0), j["camera"].pos, j["camera"].fov,
            j["background"].data, sc.hollow_disks.outer_radius)
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=range(5)))(*args)
    return dict(j=j, w=w, value=float(value),
                grads=[np.asarray(g) for g in grads])


def test_render_gradients_match_jax(grad_case):
    """Autograd through the dense renderer against jax.grad, rtol 2e-2 and
    atol 1e-3 (tests/test_kernel_scene.py's gradient rule), for r_s, the
    camera's position and fov, the background texels and the hollow disk's
    outer radius.  The disk's radius is held to JAX's value whatever it is
    (0.0 here; the JAX suite's own scene-geometry gradient test reports a
    0.0 gradient too: the disk's checker texture is piecewise constant;
    tests/test_torch_geometry_grad.py holds a nonzero one with a smooth
    texture)."""
    c = grad_case
    j = c["j"]
    sc = convert.scene(_np(j["scene"]), device="cpu")
    cam = convert.camera(_np(j["camera"]), device="cpu")
    leaves = [torch.tensor(1.0), cam.pos.clone(), cam.fov.clone(),
              torch.from_numpy(np.array(j["background"].data)),
              sc.hollow_disks.outer_radius.clone()]
    for x in leaves:
        x.requires_grad_(True)
    r_s, pos, fov, bg_data, outer = leaves
    img = trender.render(
        sc._replace(hollow_disks=sc.hollow_disks._replace(
            outer_radius=outer)),
        cam._replace(pos=pos, fov=fov), _port_cfg(GRAD_CFG),
        sp.Texture(bg_data), convert.texture_stack(_np(j["tex"]),
                                                   device="cpu"), r_s)
    value = torch.sum(img * torch.from_numpy(c["w"]))
    np.testing.assert_allclose(value.item(), c["value"], rtol=1e-4)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    for name, g, ref in zip(GRAD_NAMES, grads, c["grads"]):
        g = np.zeros_like(ref) if g is None else g.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, ref, rtol=2e-2, atol=1e-3,
                                   err_msg=name)
    assert all((g != 0).any() for g in c["grads"][:4])
