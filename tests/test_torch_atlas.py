"""The port's fetch atlas, compacted samplers and bfloat16 texel storage held
against the JAX package on the CPU (``schwarzschild_tpu.textures``), and
against the port's own samplers by tests/test_textures.py's rules: the
atlas's storage bit for bit, its fetch bit-equal to ``sample_texture`` /
``sample_stack``, gradients within rtol 1e-5 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import textures as jtx
from schwarzschild_tpu_torch import configs, convert
from schwarzschild_tpu_torch import textures as tx


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _odd_sources(seed=1):
    """A background 6 x 10 and a stack of a 5 x 13 and a 7 x 9 image:
    padded width 13 and background width 10, neither a multiple of 8."""
    r = np.random.default_rng(seed)
    bg = r.random((6, 10, 4)).astype(np.float32)
    imgs = [(r.random((5, 13, 4)) * 255).astype(np.uint8),
            (r.random((7, 9, 3)) * 255).astype(np.uint8)]
    return ((jtx.Texture(data=jnp.asarray(bg)), jtx.stack_textures(imgs)),
            (tx.Texture(data=torch.from_numpy(bg)),
             tx.stack_textures(imgs, device="cpu")))


@pytest.fixture(scope="module")
def demo_sources():
    j = (jconfigs.background_texture(), jconfigs.demo_texture_stack())
    t = (convert.texture(_np(j[0]), device="cpu"),
         convert.texture_stack(_np(j[1]), device="cpu"))
    return j, t


def _assert_atlas_equal(got, ref):
    for name in tx.FetchAtlas._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if a.dtype == torch.bfloat16:
            a = a.to(torch.float32)
            b = np.asarray(b, np.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("case", ["demo", "odd_width", "odd_width_bf16"])
def test_atlas_bit_equal_to_jax(case, demo_sources):
    """build_atlas's storage equals the JAX package's bit for bit (data,
    wrap, base, gpr) and so does atlas_nbytes; convert.fetch_atlas copies
    JAX's atlas into the same tensors."""
    if case == "demo":
        (jbg, jst), (tbg, tst) = demo_sources
    else:
        (jbg, jst), (tbg, tst) = _odd_sources()
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if case.endswith("bf16")
                else (jnp.float32, torch.float32))
    ref = jtx.build_atlas(jbg, jst, dtype=jdt)
    got = tx.build_atlas(tbg, tst, dtype=tdt)
    _assert_atlas_equal(got, ref)
    assert got.data.dtype == tdt
    assert tx.atlas_nbytes(tbg, tst, tdt) == jtx.atlas_nbytes(jbg, jst, jdt)
    assert tx.atlas_nbytes(tbg, tst, tdt) == (got.data.numel()
                                              * got.data.element_size())
    _assert_atlas_equal(convert.fetch_atlas(_np(ref), device="cpu"), ref)
    if case == "demo":
        assert tx.atlas_nbytes(tbg, tst) == 79_634_432  # 79.6 MB in f32


def _uv(r, shape, lo=-0.5, span=2.0):
    """Coordinates beyond [0, 1] on both sides: the REPEAT wraps."""
    return [torch.from_numpy((r.random(shape) * span + lo).astype(np.float32))
            for _ in range(2)]


def test_atlas_fetch_equals_samplers(rng):
    """Layer 0 is sample_texture and layer i + 1 sample_stack index i, bit
    for bit, mixed in one batch (tests/test_textures.py:394-446)."""
    _, (bg, stack) = _odd_sources()
    atlas = tx.build_atlas(bg, stack)
    shape = (7, 9)
    u, v = _uv(rng, shape)
    layer = torch.from_numpy(rng.integers(0, 3, shape))
    got = tx.atlas_fetch(atlas, layer, u, v)
    ref_bg = tx.sample_texture(bg, u, v)
    ref_st = tx.sample_stack(stack, layer - 1, u, v)
    ref = torch.where((layer == 0)[..., None], ref_bg, ref_st)
    assert torch.equal(got, ref)
    assert (layer == 0).any() and (layer == 2).any()


def test_atlas_fetch_matches_jax(rng):
    """Within 1e-6 of JAX's atlas_fetch, mixed layers in one batch; the
    frozen fetch gives the same values."""
    (jbg, jst), (bg, stack) = _odd_sources()
    shape = (6, 11)
    u, v = _uv(rng, shape)
    layer = rng.integers(0, 3, shape)
    ref = np.asarray(jtx.atlas_fetch(jtx.build_atlas(jbg, jst),
                                     jnp.asarray(layer, jnp.int32),
                                     jnp.asarray(u.numpy()),
                                     jnp.asarray(v.numpy())))
    atlas = tx.build_atlas(bg, stack)
    got = tx.atlas_fetch(atlas, torch.from_numpy(layer), u, v)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert torch.equal(tx.atlas_fetch_frozen(atlas, torch.from_numpy(layer),
                                             u, v), got)


def test_atlas_fetch_frozen_vjp_matches_jax(rng):
    """The frozen fetch's gradient to (u, v) against JAX's custom VJP
    (atlas_fetch_frozen), rtol 1e-5; no gradient reaches the texels."""
    (jbg, jst), (bg, stack) = _odd_sources()
    shape = (5, 8)
    u, v = _uv(rng, shape, lo=0.0, span=1.0)
    layer = rng.integers(0, 3, shape)
    ct = rng.standard_normal(shape + (4,)).astype(np.float32)
    jatlas = jtx.build_atlas(jbg, jst)
    _, vjp = jax.vjp(lambda a, b: jtx.atlas_fetch_frozen(
        jatlas, jnp.asarray(layer, jnp.int32), a, b),
        jnp.asarray(u.numpy()), jnp.asarray(v.numpy()))
    ref_u, ref_v = vjp(jnp.asarray(ct))
    data = bg.data.clone().requires_grad_(True)
    atlas = tx.build_atlas(tx.Texture(data), stack)
    uu, vv = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
    out = tx.atlas_fetch_frozen(atlas, torch.from_numpy(layer), uu, vv)
    g_u, g_v, g_d = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                        [uu, vv, data], allow_unused=True)
    for got, ref in ((g_u, ref_u), (g_v, ref_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    assert g_d is None


def test_atlas_texel_gradients_match_jax(rng):
    """Gradients to the background's and the stack's texels through build
    and fetch against jax.grad (tests/test_textures.py:465's analog), rtol
    1e-5."""
    (jbg, jst), (bg, stack) = _odd_sources()
    shape = (9, 7)
    u, v = _uv(rng, shape)
    layer = rng.integers(0, 3, shape)
    w = rng.standard_normal(shape + (4,)).astype(np.float32)

    def jloss(bg_d, st_d):
        a = jtx.build_atlas(jtx.Texture(data=bg_d), jst._replace(data=st_d))
        out = jtx.atlas_fetch(a, jnp.asarray(layer, jnp.int32),
                              jnp.asarray(u.numpy()), jnp.asarray(v.numpy()))
        return jnp.sum(out * w)

    ref = jax.grad(jloss, argnums=(0, 1))(jbg.data, jst.data)
    bg_d = bg.data.clone().requires_grad_(True)
    st_d = stack.data.clone().requires_grad_(True)
    atlas = tx.build_atlas(tx.Texture(bg_d), stack._replace(data=st_d))
    assert atlas.data.requires_grad
    out = tx.atlas_fetch(atlas, torch.from_numpy(layer), u, v)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [bg_d, st_d])
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_build_atlas_cached_follows_writes():
    """The cache returns the same atlas for the same tensors, a new one
    after an in-place write to a source (its version moved), and bypasses
    itself for sources that require grad."""
    _, (bg, stack) = _odd_sources(seed=5)
    a = tx.build_atlas_cached(bg, stack)
    assert tx.build_atlas_cached(bg, stack) is a
    assert tx.build_atlas_cached(bg, stack, dtype=torch.bfloat16) is not a
    before = a.data.clone()
    bg.data.mul_(0.5)
    b = tx.build_atlas_cached(bg, stack)
    assert b is not a
    assert torch.equal(b.data, tx.build_atlas(bg, stack).data)
    assert not torch.equal(b.data, before)
    stack.data[0, 0, 0] = 1.0
    c = tx.build_atlas_cached(bg, stack)
    assert c is not b and torch.equal(c.data, tx.build_atlas(bg, stack).data)
    d = tx.build_atlas_cached(tx.Texture(bg.data.clone().requires_grad_(True)),
                              stack)
    assert d.data.requires_grad and not c.data.requires_grad


def test_atlas_byte_limit(monkeypatch):
    """Past ATLAS_MAX_BYTES the build raises (SCHW_ATLAS_MAX_BYTES sets it
    at import), with the JAX package's message."""
    _, (bg, stack) = _odd_sources()
    n = tx.atlas_nbytes(bg, stack)
    monkeypatch.setattr(tx, "ATLAS_MAX_BYTES", n - 1)
    with pytest.raises(ValueError, match="fetch atlas would be"):
        tx.build_atlas(bg, stack)
    with pytest.raises(ValueError, match="SCHW_ATLAS_MAX_BYTES"):
        tx.build_atlas_cached(tx.Texture(bg.data.clone()), stack)
    tx.build_atlas(bg, stack, dtype=torch.bfloat16)  # half the bytes: fits


# ---------------------------------------------------------------------------
# Compacted samplers (tests/test_textures.py:314-387's rules).
# ---------------------------------------------------------------------------


def _compact_case(rng, shape, p_want):
    imgs = [(rng.random((8, 8, 4)) * 255).astype(np.uint8) for _ in range(3)]
    stack = tx.stack_textures(imgs, device="cpu")
    bg = tx.Texture(torch.from_numpy(rng.random((6, 10, 4)).astype(
        np.float32)))
    u, v = _uv(rng, shape)
    idx = torch.from_numpy(rng.integers(0, 3, shape))
    want = torch.from_numpy(rng.random(shape) < p_want)
    return bg, stack, idx, u, v, want


def _samplers(bg, stack, idx, u, v):
    """(full-batch sampler, compacted sampler(want, cap)) of each kind."""
    atlas = tx.build_atlas(bg, stack)
    return {
        "stack": (lambda: tx.sample_stack(stack, idx, u, v),
                  lambda w, c: tx.sample_stack_compact(stack, idx, u, v, w,
                                                       c)),
        "texture": (lambda: tx.sample_texture(bg, u, v),
                    lambda w, c: tx.sample_texture_compact(bg, u, v, w, c)),
        "atlas": (lambda: tx.atlas_fetch(atlas, idx, u, v),
                  lambda w, c: tx.atlas_fetch_compact(atlas, idx, u, v, w,
                                                      c)),
    }


@pytest.mark.parametrize("kind", ["stack", "texture", "atlas"])
def test_compact_sampler_bit_equal(kind, rng):
    """Wanted lanes bit-equal to the full batch, zeros elsewhere; a
    capacity below the wanted count takes the full-batch fallback for the
    dropped lanes, so every lane is still bit-equal."""
    bg, stack, idx, u, v, want = _compact_case(rng, (6, 10), 0.3)
    full_fn, comp_fn = _samplers(bg, stack, idx, u, v)[kind]
    full = full_fn()
    comp = comp_fn(want, 32)
    assert torch.equal(comp[want], full[want])
    assert (comp[~want] == 0.0).all()
    n_want = int(want.sum())
    assert 4 < n_want < 32
    small = comp_fn(want, n_want - 3)  # three lanes past the capacity
    assert torch.equal(small[want], full[want])
    assert (small[~want] == 0.0).all()
    every = comp_fn(torch.ones_like(want), 8)  # 60 lanes over 8 rows
    assert torch.equal(every, full)


@pytest.mark.parametrize("kind", ["stack", "atlas"])
def test_compact_sampler_texel_gradients(kind, rng):
    """Texel gradients through the compacted sampler equal the full
    batch's on the wanted lanes (the scatter's backward is a gather), with
    and without the fallback; tests/test_textures.py's tolerance (the
    gradients sum the same terms in another order)."""
    bg, stack, idx, u, v, want = _compact_case(rng, (4, 6), 0.5)

    def grads(cap):
        data = stack.data.clone().requires_grad_(True)
        st = stack._replace(data=data)
        full_fn, comp_fn = _samplers(bg, st, idx, u, v)[kind]
        out = (torch.where(want[..., None], full_fn(), 0.0) if cap is None
               else comp_fn(want, cap))
        return torch.autograd.grad((out ** 2).sum(), data)[0]

    ref = grads(None)
    assert (ref != 0).any()
    for cap in (16, int(want.sum()) - 2):
        np.testing.assert_allclose(grads(cap).numpy(), ref.numpy(),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# bfloat16 texel storage (tests/test_textures.py:258's rule).
# ---------------------------------------------------------------------------


def test_bf16_textures_close_and_opaque_exact(rng):
    """with_dtype/stack_with_dtype: bfloat16 texels (mips too) sample in
    float32 within 5e-3 of float32 texels, an alpha of exactly 1 stays
    exactly 1, and the demo frame stays within a display count on 98% of
    pixels."""
    bg = configs.background_texture(device="cpu")
    tex = configs.demo_texture_stack(device="cpu")
    bg16 = sp.with_dtype(tx.with_mips(bg))
    tex16 = sp.stack_with_dtype(tex)
    assert bg16.data.dtype == torch.bfloat16
    assert all(m.dtype == torch.bfloat16 for m in bg16.mips)
    assert tex16.data.dtype == torch.bfloat16
    assert tex16.sizes.dtype == torch.float32
    u, v = _uv(rng, (64,), lo=0.0, span=1.0)
    a = tx.sample_texture(bg, u, v)
    b = tx.sample_texture(bg16, u, v)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-3)
    lod = torch.from_numpy(rng.random(64).astype(np.float32) * 3)
    np.testing.assert_allclose(
        tx.sample_texture_trilinear(bg16, u, v, lod).numpy(),
        tx.sample_texture_trilinear(tx.with_mips(bg), u, v, lod).numpy(),
        atol=5e-3)
    idx = torch.zeros(64, dtype=torch.int64)
    a = tx.sample_stack(tex, idx, u, v)
    b = tx.sample_stack(tex16, idx, u, v)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-3)
    assert bool((a[:, 3] == 1.0).all()) and bool((b[:, 3] == 1.0).all())

    sc = configs.demo_scene(device="cpu")
    cam = configs.demo_camera(device="cpu")
    cfg = sp.RenderConfig(width=48, height=32, percent_black=-1.0)
    f = sp.render_fast(sc, cam, cfg, bg, tex, overflow="ignore")
    g = sp.render_fast(sc, cam, cfg, bg16, tex16, overflow="ignore")
    d = (f - g).abs()
    assert (d < 1 / 255).float().mean() > 0.98, d.max()
