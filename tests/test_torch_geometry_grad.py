"""The scene-geometry gradient of the port's dense renderer: the hollow
disk's ``outer_radius`` in config 5's scene, with the disk's texture layer
made smooth (the same numpy array through ``from_array`` in both packages)
so that the radius reaches the image through the texture coordinate
(r - inner) / (outer - inner).  The procedural checker the layer holds
otherwise is piecewise constant, and both packages then read 0.0.

The gradient must be connected (``torch.autograd.grad`` without
``allow_unused``), nonzero, equal to ``jax.grad`` of the same loss at
rtol 2e-2, atol 1e-3, and equal to a central finite difference of the loss
restricted to the pixels that the disk's edge does not cross
(benchmarks/tpu_grads_r04.py's masked check): those whose hit objects are
the same at outer + h and outer - h.  A pixel the edge crosses jumps, which
a hard-mask renderer's autograd rightly does not see."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import textures as jtex
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import kernel as tkernel
from schwarzschild_tpu_torch import kernel_scene as tks
from schwarzschild_tpu_torch.intersect import intersect_scene

jrender = importlib.import_module("schwarzschild_tpu.render")
trender = importlib.import_module("schwarzschild_tpu_torch.render")

CFG = st.RenderConfig(width=24, height=16, max_steps=20, percent_black=-1.0,
                      checkpoint_every=10)
DISK_SLOT = 5  # the hollow disk's material's texture layer in config 5
H_FD = 0.02


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ramp(h, w):
    """A smooth RGB field of the texture's u, periodic so that the REPEAT
    wrap adds no step; alpha 1."""
    u = (np.arange(w) + 0.5) / w
    rgb = np.stack([0.5 - 0.4 * np.cos(2 * np.pi * u),
                    0.5 + 0.3 * np.sin(2 * np.pi * u),
                    0.5 - 0.2 * np.cos(4 * np.pi * u)], -1)
    return np.broadcast_to(rgb[None], (h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    j = jconfigs.config5_inverse()
    ramp = _ramp(*j["tex"].data.shape[1:3])
    jstack = j["tex"]._replace(data=j["tex"].data.at[DISK_SLOT].set(
        jtex.from_array(ramp).data))
    w = np.random.default_rng(7).random((16, 24, 4)).astype(np.float32)
    sc = j["scene"]

    def loss(outer):
        s2 = sc._replace(hollow_disks=sc.hollow_disks._replace(
            outer_radius=outer))
        return jnp.sum(jrender.render(s2, j["camera"], CFG, j["background"],
                                      jstack, 1.0) * w)

    outer = sc.hollow_disks.outer_radius
    value, grad = jax.jit(jax.value_and_grad(loss)).lower(outer).compile(
        compiler_options={"xla_backend_optimization_level": 0})(outer)
    stack = convert.texture_stack(_np(j["tex"]), device="cpu")
    layer = sp.from_array(ramp, device="cpu").data
    stack = stack._replace(data=torch.cat(
        [stack.data[:DISK_SLOT], layer[None], stack.data[DISK_SLOT + 1:]]))
    np.testing.assert_array_equal(stack.data.numpy(), np.asarray(jstack.data))
    return dict(scene=convert.scene(_np(sc), device="cpu"),
                cam=convert.camera(_np(j["camera"]), device="cpu"),
                bg=convert.texture(_np(j["background"]), device="cpu"),
                tex=stack, w=torch.from_numpy(w), value=float(value),
                grad=np.asarray(grad))


def _with_outer(c, outer):
    sc = c["scene"]
    return sc._replace(hollow_disks=sc.hollow_disks._replace(
        outer_radius=outer))


def _image(c, outer):
    return trender.render(_with_outer(c, outer), c["cam"],
                          convert.render_config(CFG), c["bg"], c["tex"], 1.0)


def _hit_keys(c, outer):
    """Per pixel: the march's status and, for each recorded slot and the
    far-field ray, obj_type * 65536 + mat_idx of what it hits (-1 for
    nothing), from the scene march's plain version."""
    sc, cfg, r_s = _with_outer(c, outer), convert.render_config(CFG), 1.0
    px = tkernel.pixel_setup(c["cam"], cfg, "cpu")
    fdir, fpos, status, slots, _ = tks.march_scene_torch(
        px["origin"], px["direction"], px["march_px"], r_s, sc, cfg,
        n_slots=4)
    unit_x = torch.tensor([1.0, 0.0, 0.0])

    def key(start, direction, window, take):
        hit = intersect_scene(start, direction, window, sc,
                              torch.tensor(r_s))
        return torch.where(take & hit.valid,
                           hit.obj_type * 65536 + hit.mat_idx, -1)

    keys = [status.to(torch.int64)]
    for start, sdir, slen in slots:
        rec = slen > 0.0
        keys.append(key(start, torch.where(rec[..., None], sdir, unit_x),
                        torch.where(rec, slen * 1.0001 + 1e-5, 1.0), rec))
    flat = px["flat_px"]
    far = flat | (px["march_px"] & (status == tks.STATUS_FLAT_FINISH))
    keys.append(key(torch.where(flat[..., None], px["origin"], fpos),
                    torch.where(flat[..., None], px["direction"], fdir),
                    torch.full(status.shape, -1.0), far))
    return torch.stack([k.to(torch.int64) for k in keys], -1)


def test_outer_radius_gradient_is_connected_and_matches_jax(case):
    c = case
    outer = c["scene"].hollow_disks.outer_radius.clone().requires_grad_(True)
    value = (_image(c, outer) * c["w"]).sum()
    np.testing.assert_allclose(value.item(), c["value"], rtol=1e-4)
    (grad,) = torch.autograd.grad(value, [outer])  # no allow_unused
    assert bool((grad != 0).all()) and bool((c["grad"] != 0).all())
    np.testing.assert_allclose(grad.numpy(), c["grad"], rtol=2e-2,
                               atol=1e-3)


def test_outer_radius_gradient_matches_masked_finite_difference(case):
    c = case
    outer0 = c["scene"].hollow_disks.outer_radius.clone()
    same = (_hit_keys(c, outer0 + H_FD) == _hit_keys(c, outer0 - H_FD)).all(
        -1)
    assert 0.9 < same.float().mean().item() < 1.0  # the edge crosses some
    w = c["w"] * same[..., None]
    outer = outer0.clone().requires_grad_(True)
    (ad,) = torch.autograd.grad((_image(c, outer) * w).sum(), [outer])
    with torch.no_grad():
        fd = ((_image(c, outer0 + H_FD) * w).sum()
              - (_image(c, outer0 - H_FD) * w).sum()) / (2 * H_FD)
    assert ad.item() != 0.0
    np.testing.assert_allclose(ad.item(), fd.item(), rtol=2e-2, atol=1e-3)
