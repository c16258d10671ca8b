"""Trilinear frames and "prng" noise of the port held against the JAX
package on the CPU: ``render_horizon_sky`` (the JAX march in interpret
mode), a strip of the dense ``render`` (``rows=``), and the gradient of a
trilinear ``render_fast(differentiable=True)`` in r_s and the texels
against ``jax.grad``.  The whole dense trilinear frame and ``render_fast``'s
trilinear frame are in tests/test_torch_render.py and
tests/test_torch_kernel_scene.py.  Each JAX reference is compiled once per
module, at XLA's backend optimization level 0."""

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
from schwarzschild_tpu import kernel as jkernel
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import kernel as tkernel
from schwarzschild_tpu_torch import kernel_scene as tks

jrender = importlib.import_module("schwarzschild_tpu.render")
trender = importlib.import_module("schwarzschild_tpu_torch.render")

FAST = {"xla_backend_optimization_level": 0}
SKY = st.RenderConfig(width=32, height=24, percent_black=-1.0,
                      texture_filter="trilinear")
SKY_PRNG = dataclasses.replace(SKY, percent_black=0.75, noise_mode="prng",
                               noise_seed=11)
STRIP_CFG = st.RenderConfig(width=24, height=16, max_steps=30,
                            percent_black=-1.0, texture_filter="trilinear",
                            checkpoint_every=10)
STRIP = (5, 11)
GRAD_CFG = STRIP_CFG


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def frame_close(ref, got, frac=0.995):
    """tests/test_kernel_scene.py's frame rule."""
    d = np.abs(np.asarray(ref) - np.asarray(got)).max(-1)
    ok = (d < 2e-3).mean()
    assert ok >= frac, f"only {ok:.4f} within tol, max {d.max():.3g}"


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
    """The trilinear and prng horizon frames and the trilinear dense strip,
    from one compiled JAX function."""
    j, _ = demo

    def frames(cam):
        return (jkernel.render_horizon_sky(cam, SKY, j["bg"], 1.0,
                                           interpret=True),
                jkernel.render_horizon_sky(cam, SKY_PRNG, j["bg"], 1.0,
                                           interpret=True),
                jrender.render(j["scene"], cam, STRIP_CFG, j["bg"], j["tex"],
                               1.0, rows=STRIP))

    f = jax.jit(frames).lower(j["cam"]).compile(compiler_options=FAST)
    return [np.asarray(x) for x in f(j["cam"])]


def test_render_horizon_sky_trilinear_matches_jax(demo, jax_frames):
    _, t = demo
    got = tkernel.render_horizon_sky(t["cam"], convert.render_config(SKY),
                                     t["bg"], 1.0)
    assert torch.isfinite(got).all()
    frame_close(jax_frames[0], got.numpy())
    # The mips are engaged: the bilinear frame differs.
    bil = tkernel.render_horizon_sky(t["cam"], convert.render_config(
        dataclasses.replace(SKY, texture_filter="bilinear")), t["bg"], 1.0)
    assert ((bil - got).abs() > 1e-3).any()
    # A background that carries its mips renders the same frame.
    again = tkernel.render_horizon_sky(
        t["cam"], convert.render_config(SKY), sp.with_mips(t["bg"]), 1.0)
    assert torch.equal(again, got)


def test_prng_frame_matches_jax(demo, jax_frames):
    """A "prng" frame skips exactly the JAX frame's pixels (a skipped pixel
    is 0 on every channel) and matches it by the frame rule."""
    _, t = demo
    got = tkernel.render_horizon_sky(t["cam"], convert.render_config(
        SKY_PRNG), t["bg"], 1.0).numpy()
    ref = jax_frames[1]
    skipped = (ref == 0).all(-1)
    assert 0.5 < skipped.mean() < 0.95
    np.testing.assert_array_equal((got == 0).all(-1), skipped)
    frame_close(ref, got)


def test_dense_trilinear_strip_matches_jax(demo, jax_frames):
    """rows= with trilinear: the LOD's neighbours are the strip's own, with
    torch.roll's wrap at its first and last rows, as the JAX package's
    jnp.roll; so the strip equals the JAX strip, and may differ from the
    whole frame's rows only on its edge rows."""
    _, t = demo
    cfg = convert.render_config(STRIP_CFG)
    strip = trender.render(t["scene"], t["cam"], cfg, t["bg"], t["tex"], 1.0,
                           rows=STRIP)
    assert strip.shape == (STRIP[1] - STRIP[0], 24, 4)
    frame_close(jax_frames[2], strip.numpy())
    full = trender.render(t["scene"], t["cam"], cfg, t["bg"], t["tex"],
                          1.0)[STRIP[0]:STRIP[1]]
    inner = slice(1, -1)
    assert torch.equal(strip[inner], full[inner])


@pytest.fixture(scope="module")
def grad_case(demo):
    """jax.grad of sum(render_fast(differentiable=True) * w), trilinear,
    in r_s, the texture stack's texels and the background's."""
    j, _ = demo
    w = np.random.default_rng(12).random((16, 24, 4)).astype(np.float32)

    def loss(r_s, tex_data, bg_data):
        img = jks.render_fast(j["scene"], j["cam"], GRAD_CFG,
                              j["bg"]._replace(data=bg_data),
                              j["tex"]._replace(data=tex_data), r_s,
                              interpret=True, overflow="ignore",
                              differentiable=True)
        return jnp.sum(img * w)

    args = (jnp.float32(1.0), j["tex"].data, j["bg"].data)
    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2))).lower(
        *args).compile(compiler_options=FAST)
    value, grads = f(*args)
    return dict(w=w, value=float(value), grads=[np.asarray(g) for g in grads])


def test_render_fast_trilinear_gradients_match_jax(demo, grad_case):
    """The texels' gradient flows through build_mips; rtol 2e-2, atol 1e-3
    (tests/test_kernel_scene.py's gradient rule)."""
    _, t = demo
    r_s = torch.tensor(1.0, requires_grad=True)
    tex_data = t["tex"].data.clone().requires_grad_(True)
    bg_data = t["bg"].data.clone().requires_grad_(True)
    img = tks.render_fast(t["scene"], t["cam"],
                          convert.render_config(GRAD_CFG),
                          sp.Texture(bg_data),
                          t["tex"]._replace(data=tex_data), r_s,
                          overflow="ignore", differentiable=True)
    value = (img * torch.from_numpy(grad_case["w"])).sum()
    np.testing.assert_allclose(value.item(), grad_case["value"], rtol=1e-4)
    grads = torch.autograd.grad(value, [r_s, tex_data, bg_data])
    for name, g, ref in zip(("r_s", "texels", "background"), grads,
                            grad_case["grads"]):
        assert torch.isfinite(g).all() and (g != 0).any(), name
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-2, atol=1e-3,
                                   err_msg=name)
