"""The port's mip pyramids, trilinear samplers and screen-space LOD held
against the JAX package's on the CPU (rtol 1e-6), with the JAX suite's own
cases (tests/test_textures.py): level 0 equals bilinear, a deep level gives
the mean, gradients reach the base texels.  Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import textures as jtex
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import textures as ttex

RTOL, ATOL = 1e-6, 1e-7


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(8, 16, 4), (7, 5, 4), (1, 6, 4),
                                   (3, 9, 9, 4)])
def test_downsample2_and_build_mips_match_jax(shape):
    data = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    _close(ttex.downsample2(_t(data)), jtex.downsample2(jnp.asarray(data)))
    got = ttex.build_mips(_t(data))
    ref = jtex.build_mips(jnp.asarray(data))
    assert [tuple(m.shape) for m in got] == [m.shape for m in ref]
    for g, r in zip(got, ref):
        _close(g, r)


def test_build_mips_chain_and_box_filter():
    mips = ttex.build_mips(torch.ones(8, 16, 4))
    assert [tuple(m.shape) for m in mips] == [(4, 8, 4), (2, 4, 4),
                                              (1, 2, 4), (1, 1, 4)]
    assert all(bool((m == 1.0).all()) for m in mips)
    checker = torch.zeros(4, 4, 4)
    checker[::2, ::2] = 1.0
    checker[1::2, 1::2] = 1.0
    assert bool((ttex.downsample2(checker) == 0.5).all())


def _lookups(n, seed):
    rng = np.random.default_rng(seed)
    u, v = (rng.uniform(-2.5, 2.5, (n, 7)).astype(np.float32)
            for _ in range(2))
    lod = rng.uniform(-1.0, 12.0, (n, 7)).astype(np.float32)
    return u, v, lod


def test_sample_texture_trilinear_matches_jax():
    data = np.random.default_rng(4).random((24, 40, 4)).astype(np.float32)
    jt = jtex.with_mips(jtex.Texture(data=jnp.asarray(data)))
    tt = ttex.with_mips(sp.Texture(_t(data)))
    u, v, lod = _lookups(60, 5)
    _close(ttex.sample_texture_trilinear(tt, _t(u), _t(v), _t(lod)),
           jtex.sample_texture_trilinear(jt, u, v, lod))


def test_sample_stack_trilinear_matches_jax():
    rng = np.random.default_rng(6)
    imgs = [(rng.random(s) * 255).astype(np.uint8)
            for s in ((16, 16, 3), (8, 12, 4), (5, 3, 3))]
    js = jtex.stack_with_mips(jtex.stack_textures(imgs))
    ts = ttex.stack_with_mips(ttex.stack_textures(imgs, device="cpu"))
    u, v, lod = _lookups(40, 7)
    idx = rng.integers(-1, 4, u.shape).astype(np.int32)
    _close(ttex.sample_stack_trilinear(ts, _t(idx), _t(u), _t(v), _t(lod)),
           jtex.sample_stack_trilinear(js, idx, u, v, lod))


def test_trilinear_lod0_equals_bilinear_and_deep_lod_is_mean():
    rng = np.random.default_rng(8)
    tt = ttex.with_mips(sp.Texture(_t(rng.random((16, 16, 4)).astype(
        np.float32))))
    u, v = (_t(rng.random((5, 7)).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(
        ttex.sample_texture_trilinear(tt, u, v, torch.zeros(5, 7)),
        ttex.sample_texture(tt, u, v), rtol=0, atol=1e-6)
    deep = ttex.sample_texture_trilinear(tt, torch.tensor([[0.3]]),
                                         torch.tensor([[0.7]]),
                                         torch.full((1, 1), 10.0))
    torch.testing.assert_close(deep[0, 0], tt.data.mean((0, 1)), rtol=0,
                               atol=1e-5)
    imgs = [(rng.random((8, 8, 3)) * 255).astype(np.uint8),
            (rng.random((4, 6, 3)) * 255).astype(np.uint8)]
    ts = ttex.stack_with_mips(ttex.stack_textures(imgs, device="cpu"))
    idx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    u, v = (_t(rng.random((2, 2)).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(
        ttex.sample_stack_trilinear(ts, idx, u, v, torch.zeros(2, 2)),
        ttex.sample_stack(ts, idx, u, v), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masks", ["none", "valid", "valid_key"])
def test_screen_space_lod_matches_jax(masks):
    rng = np.random.default_rng(9)
    H, W = 12, 10
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    tx = (x * 3.0 + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    ty = (y * 0.5 + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    valid = rng.random((H, W)) > 0.3 if masks != "none" else None
    key = (rng.integers(0, 3, (H, W)).astype(np.int32)
           if masks == "valid_key" else None)
    ref = jtex.screen_space_lod(
        tx, ty, None if valid is None else jnp.asarray(valid),
        None if key is None else jnp.asarray(key))
    got = ttex.screen_space_lod(
        _t(tx), _t(ty), None if valid is None else _t(valid),
        None if key is None else _t(key))
    _close(got, ref)
    # A uv field advancing 4 texels a pixel has lod 2; 0.25, lod 0.
    lod = ttex.screen_space_lod(_t(x * 4.0), _t(y * 4.0))
    torch.testing.assert_close(lod, torch.full((H, W), 2.0))
    assert bool((ttex.screen_space_lod(_t(x * 0.25), _t(y * 0.25))
                 == 0.0).all())


def test_trilinear_gradients_match_jax():
    """Gradients reach the base texels through build_mips and a trilinear
    sample (the lod's too), as jax.grad's."""
    rng = np.random.default_rng(10)
    data = rng.random((8, 12, 4)).astype(np.float32)
    u, v = (rng.uniform(-1, 2, (6, 6)).astype(np.float32) for _ in range(2))
    lod = rng.uniform(0.0, 3.0, (6, 6)).astype(np.float32)
    w = rng.random((6, 6, 4)).astype(np.float32)

    def jloss(d, lod):
        t = jtex.Texture(data=d, mips=jtex.build_mips(d))
        return jnp.sum(jtex.sample_texture_trilinear(t, u, v, lod) * w)

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(data),
                                          jnp.asarray(lod))
    d, lt = _t(data).requires_grad_(True), _t(lod).requires_grad_(True)
    out = ttex.sample_texture_trilinear(
        sp.Texture(d, ttex.build_mips(d)), _t(u), _t(v), lt)
    got = torch.autograd.grad((out * _t(w)).sum(), [d, lt])
    for g, r in zip(got, ref):
        assert bool((g != 0).any())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_texture_exports_match_jax(tmp_path):
    """solid_color_texture and load_texture_array build what the JAX
    package's do; convert carries a JAX texture's mips across."""
    rgba = (0.25, 0.5, 0.75, 1.0)
    _close(sp.solid_color_texture(rgba, size=3, device="cpu").data,
           jtex.solid_color_texture(rgba, size=3).data)
    rng = np.random.default_rng(11)
    paths = []
    for i, shape in enumerate(((6, 4, 3), (3, 5, 3))):
        path = tmp_path / f"t{i}.png"
        path.write_bytes(sp.encode_png(
            (rng.random(shape) * 255).astype(np.uint8)))
        paths.append(str(path))
    got = sp.load_texture_array(paths, device="cpu")
    ref = jtex.load_texture_array(paths)
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r)
    jt = jtex.stack_with_mips(ref)
    tt = convert.texture_stack(jax.tree.map(np.asarray, jt), device="cpu")
    assert len(tt.mips) == len(jt.mips)
    for g, r in zip(tt.mips, jt.mips):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
