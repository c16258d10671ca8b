"""The port's composition and sparse-frame paths held against the JAX package
on the CPU: ``compose.compose_atlas`` fed the same march records in both
packages, compacted levels against full-frame ones, the lane- and
tile-sparse frames against the full frame, the compacted marches, the
``backward="replay"`` march, ``compile_cache``, and the public names and
keywords of the modules this slice completes.  One JAX interpret-mode
frame (the lane-sparse 128x512 frame) holds the slice as a whole."""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import compose as jcompose
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu import textures as jtx
from schwarzschild_tpu_torch import _ext, compile_cache, compose, convert
from schwarzschild_tpu_torch import camera as tcam
from schwarzschild_tpu_torch import kernel as tkernel
from schwarzschild_tpu_torch import kernel_scene as tks
from schwarzschild_tpu_torch import noise, physics
from schwarzschild_tpu_torch import geometry as geo
from schwarzschild_tpu_torch import textures as tx

LANE_SPARSE = dict(width=512, height=128, percent_black=0.6,
                   noise_mode="hash", noise_seed=3)
TILE_SPARSE = dict(width=256, height=64, percent_black=0.5, noise_mode="tile",
                   noise_tile=(8, 128), noise_seed=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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


def _march(t, cfg, opaque_stop=True):
    """The port's pixel masks and plain march records of cfg's frame."""
    px = tkernel.pixel_masks(tkernel.grid_planes(t["cam"], cfg, "cpu"), cfg)
    out = tks.march_scene_torch(px["origin"], px["direction"],
                                px["march_px"], 1.0, t["scene"], cfg, 4,
                                tex=t["tex"] if opaque_stop else None)
    return px, out[:4]


def _inputs(px, march, cfg):
    return tks._composition_inputs(px, *march, torch.tensor(1.0), cfg)


def _jnp(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, (list, tuple)):
        return type(x)(_jnp(y) for y in x)
    return x


@pytest.fixture(scope="module")
def translucent(demo):
    """The demo scene with every material's and texel's alpha halved: rays
    cross several hits, so composition runs past level 0."""
    j, _ = demo
    m = j["scene"].materials
    scene = j["scene"]._replace(materials=m._replace(
        color=m.color.at[:, 3].set(0.5)))
    stack = j["tex"]._replace(data=j["tex"].data.at[..., 3].multiply(0.5))
    j = dict(j, scene=scene, tex=stack)
    t = dict(demo[1], scene=convert.scene(_np(scene), device="cpu"),
             tex=convert.texture_stack(_np(stack), device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def records_32x128(translucent):
    """The translucent demo at 32x128 (4 tiles of 8 x 128): pixel masks
    and records."""
    _, t = translucent
    cfg = sp.RenderConfig(width=128, height=32, percent_black=-1.0)
    return _march(t, cfg)


@pytest.mark.parametrize("compact", [True, False], ids=["tiles", "full"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_compose_atlas_matches_jax(translucent, records_32x128, soft,
                                   compact):
    """compose_atlas on the same records (the port's march of the
    translucent demo at 32x128, passed to JAX as jnp arrays), hard and
    soft horizon, tile compaction on and off: colour within 1e-5, open and
    captured equal.  JAX runs with jit disabled (its levels' conds run the
    branch they pick)."""
    j, t = translucent
    cfg = sp.RenderConfig(width=128, height=32, percent_black=-1.0,
                          horizon_softness=0.05 if soft else 0.0)
    inputs = _inputs(*records_32x128, cfg)
    got = compose.compose_atlas(
        t["scene"], t["tex"], tx.build_atlas(t["bg"], t["tex"]),
        torch.tensor(1.0), compact_tiles=compact, return_pend=True, **inputs)
    with jax.disable_jit():
        ref = jcompose.compose_atlas(
            j["scene"], j["tex"], jtx.build_atlas(j["bg"], j["tex"]),
            jnp.float32(1.0), compact_tiles=compact,
            **{k: _jnp(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2].any()
    if compact:  # levels 1-2 ran on their pending tiles (capacity 4 of 4)
        n_pend, caps = got[3].tolist(), got[4]
        assert caps == (4,) * 5 and 0 < n_pend[0] <= 4 and 0 < n_pend[1]
    else:
        assert got[4] == ()


def test_compacted_levels_bit_equal(translucent):
    """Tile-compacted levels equal full-frame levels bit for bit on the
    translucent demo at 64x256 (16 tiles, capacity 4 a level), hard and
    soft: some levels ran on their pending tiles and some on the whole
    frame (more than 4 pending tiles); render_fast's frames with "auto",
    per-pass capacities and None equal."""
    _, t = translucent
    atlas = tx.build_atlas_cached(t["bg"], t["tex"])
    cfg = sp.RenderConfig(width=256, height=64, percent_black=-1.0)
    px, march = _march(t, cfg)
    fired = set()
    for soft in (0.0, 0.05):
        inputs = _inputs(px, march, sp.RenderConfig(
            width=256, height=64, percent_black=-1.0,
            horizon_softness=soft))
        args = (t["scene"], t["tex"], atlas, torch.tensor(1.0))
        full = compose.compose_atlas(*args, compact_tiles=False, **inputs)
        comp = compose.compose_atlas(*args, return_pend=True, **inputs)
        for a, b in zip(full, comp[:3]):
            assert torch.equal(a, b)
        fired |= {("tiles" if 0 < n <= c else "frame" if n > c else "none")
                  for n, c in zip(comp[3].tolist(), comp[4])}
    assert {"tiles", "frame"} <= fired, fired
    kw = dict(overflow="ignore")
    ref = sp.render_fast(t["scene"], t["cam"], cfg, t["bg"], t["tex"],
                         compact_slots=None, **kw)
    for value in ("auto", (None, 16, 16, 16)):
        assert torch.equal(sp.render_fast(t["scene"], t["cam"], cfg, t["bg"],
                                          t["tex"], compact_slots=value,
                                          **kw), ref)


def test_compacted_gradients_match(translucent):
    """Gradients through compacted levels (r_s, cam.pos through the frozen
    fetch; the background's texels through a differentiable atlas) equal
    the full-frame levels' within rtol 1e-5 (translucent demo, 32x128)."""
    _, t = translucent
    cfg = sp.RenderConfig(width=128, height=32, percent_black=-1.0)

    def grads(compact):
        r_s = torch.tensor(1.0, requires_grad=True)
        pos = t["cam"].pos.clone().requires_grad_(True)
        bg_d = t["bg"].data.clone().requires_grad_(True)
        img = sp.render_fast(t["scene"], t["cam"]._replace(pos=pos), cfg,
                             tx.Texture(bg_d), t["tex"], r_s,
                             overflow="ignore", differentiable=True,
                             compact_slots=compact)
        return torch.autograd.grad(img[..., :3].mean(), [r_s, pos, bg_d])

    for a, b in zip(grads("auto"), grads(None)):
        assert torch.isfinite(a).all() and (b != 0).any()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())


@pytest.fixture(scope="module")
def sparse_frames():
    """The port's sparse frames, each rendered once for the module."""
    return {}


def _frame(t, cache, name, cfg, **kw):
    if name not in cache:
        cache[name] = sp.render_fast(t["scene"], t["cam"], cfg, t["bg"],
                                     t["tex"], **kw)
    return cache[name]


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tks, name)

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(tks, name, spy)
    return calls


@pytest.mark.parametrize("case", ["lane", "tile"])
@pytest.mark.parametrize("crosshair", [False, True],
                         ids=["plain", "crosshair"])
def test_sparse_frame_matches_full(demo, sparse_frames, monkeypatch, case,
                                   crosshair):
    """The lane-sparse frame (128x512, hash noise 0.6, seed 3) and the
    tile-sparse frame (64x256, tile noise (8, 128)) within 1e-6 of the
    compact_slots=None frame on every pixel, through their branches.
    Without the crosshair every hit is recorded in one slot, so some rays
    overflow: overflow="return" passes the full frame's count through."""
    _, t = demo
    cfg = sp.RenderConfig(crosshair=crosshair,
                          **(LANE_SPARSE if case == "lane" else TILE_SPARSE))
    kw = (dict(overflow="ignore") if crosshair else
          dict(overflow="return", n_slots=1, opaque_stop=False))
    calls = _spy(monkeypatch, "_render_fast_lane_sparse" if case == "lane"
                 else "_render_fast_tile_sparse")
    got = _frame(t, sparse_frames, (case, crosshair), cfg, **kw)
    assert calls
    ref = sp.render_fast(t["scene"], t["cam"], cfg, t["bg"], t["tex"],
                         compact_slots=None, **kw)
    if not crosshair:
        (got, n_got), (ref, n_ref) = got, ref
        assert n_got == n_ref > 0
    assert got.shape == (cfg.height, cfg.width, 4)
    assert (got - ref).abs().max() <= 1e-6
    assert (got[..., 3] == 0).any() and (got[..., 3] > 0).any()


def test_lane_sparse_radial_slack():
    """A noise-dropped radial pixel still renders flat (the reference tests
    radiality before the noise skip, frag:866-881) through the lane-sparse
    frame's slack tiles (tests/test_kernel_scene.py's case, as it is)."""
    W, H = 512, 128
    # The camera sits at 20 d, so the (y0, x0) pixel's ray is exactly
    # radial, pointing away from the hole (pure sky).
    y0, x0 = 37, 200
    fov = 90.0
    fl = 1.0 / np.tan(fov / 360.0 * np.pi)
    u0 = 2.0 * (x0 + 0.5) / W - 1.0
    v0 = (1.0 - 2.0 * (y0 + 0.5) / H) * (H / W)
    d = np.array([u0, v0, fl], np.float32)
    d /= np.linalg.norm(d)
    cam = sp.Camera(pos=torch.from_numpy(20.0 * d),
                    axes=torch.eye(3), fov=torch.tensor(fov))
    sc = sp.build_scene([], [sp.Light()], device="cpu")
    bg = tx.solid_color_texture((0.2, 0.4, 0.6, 1.0), device="cpu")
    seed = next(s for s in range(50)
                if noise.pixel_hash_rand_np(W, H, s)[y0, x0] <= 0.9)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=0.9,
                          noise_mode="hash", noise_seed=seed)
    img = sp.render_fast(sc, cam, cfg, bg, None, 1.0)
    assert img[y0, x0, :3].max() > 0.1, img[y0, x0]
    assert torch.equal(img, sp.render_fast(sc, cam, cfg, bg, None, 1.0,
                                           compact_slots=None))


@pytest.fixture(scope="module")
def jax_lane_sparse(demo):
    """JAX's lane-sparse frame (its _render_fast_lane_sparse branch),
    interpret mode, compiled at XLA's optimization level 0 (the port's
    test files' practice: the compile is most of its minute)."""
    j, _ = demo
    cfg = st.RenderConfig(crosshair=True, **LANE_SPARSE)

    def frame(cam):
        return jks.render_fast(j["scene"], cam, cfg, j["bg"], j["tex"], 1.0,
                               interpret=True, overflow="ignore")

    run = jax.jit(frame).lower(j["cam"]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return np.asarray(run(j["cam"]))


def test_lane_sparse_frame_matches_jax(demo, sparse_frames, jax_lane_sparse):
    """The slice as a whole: the port's lane-sparse frame against JAX's,
    by the frame rule (>= 99.5% of pixels within 2e-3)."""
    _, t = demo
    cfg = sp.RenderConfig(crosshair=True, **LANE_SPARSE)
    got = _frame(t, sparse_frames, ("lane", True), cfg, overflow="ignore")
    d = np.abs(got.numpy() - jax_lane_sparse).max(-1)
    assert (d < 2e-3).mean() >= 0.995, d.max()


@pytest.mark.parametrize("march", ["march_bh", "march_scene"])
def test_compact_march_bit_equal(demo, march):
    """compact=True equals the unpacked march bit for bit on every active
    ray (tests/test_kernel_scene.py:187's case: 32x24, hash noise 0.75);
    events and count_steps refuse compact."""
    _, t = demo
    W, H = 32, 24
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    u, v = tcam.pixel_grid(W, H, device="cpu")
    o, d = tcam.generate_rays(t["cam"], u, v, W, H)
    active = noise.pixel_hash_rand(W, H, 0, device="cpu") > 0.75
    fn = getattr(tkernel if march == "march_bh" else tks, march)
    args = ((o, d, active, 1.0, cfg) if march == "march_bh"
            else (o, d, active, 1.0, t["scene"], cfg))
    a = jax.tree.leaves(fn(*args))
    b = jax.tree.leaves(fn(*args, compact=True))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        mask = active if x.dim() == 2 else active[..., None].expand(x.shape)
        assert torch.equal(x[mask], y[mask])
    for option in ("events", "count_steps"):
        with pytest.raises(ValueError):
            fn(*args, compact=True, **{option: True})


def test_diff_marches_compact_and_replay(demo):
    """march_scene_diff and march_bh_diff with compact=True give the
    unpacked marches' gradients (rtol 1e-5: r_s sums its lanes in another
    order), and backward="replay" (autograd through the plain march) the
    adjoint's within rtol 1e-4."""
    _, t = demo
    W, H = 32, 24
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0,
                          max_steps=40)
    u, v = tcam.pixel_grid(W, H, device="cpu")
    o, d = tcam.generate_rays(t["cam"], u, v, W, H)
    active = (~physics.is_radial(d, geo.safe_normalize(o))
              & (noise.pixel_hash_rand(W, H, 1, device="cpu") > 0.5))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((H, W, 3), generator=gen)

    def grads(scene_march, **kw):
        leaves = [o.clone().requires_grad_(True),
                  d.clone().requires_grad_(True),
                  torch.tensor(1.0, requires_grad=True)]
        if scene_march:
            fdir, fpos, _, slots, _ = tks.march_scene_diff(
                leaves[0], leaves[1], active, leaves[2], t["scene"], cfg,
                **kw)
            loss = ((fdir + fpos) * w).sum() + sum(
                (s * w).sum() + l.sum() for s, _, l in slots)
        else:
            fdir, _ = tkernel.march_bh_diff(leaves[0], leaves[1], active,
                                            leaves[2], cfg, **kw)
            loss = (fdir * w).sum()
        return torch.autograd.grad(loss, leaves)

    def close(a, b, rtol):
        for x, y in zip(a, b):
            assert torch.isfinite(x).all()
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                       atol=rtol * y.abs().max().item())

    for scene_march in (False, True):
        ref = grads(scene_march)
        close(grads(scene_march, compact=True), ref, 1e-5)
    close(grads(True, backward="replay"), grads(True), 1e-4)
    with pytest.raises(ValueError):
        tks.march_scene_diff(o, d, active, 1.0, t["scene"], cfg,
                             backward="nope")


def test_compile_cache_on_cpu(demo, tmp_path, monkeypatch):
    """aot_compile runs the function once and reports; with no card it
    builds nothing.  enable_persistent_cache moves the build directory."""
    _, t = demo
    monkeypatch.setattr(_ext, "BUILD_DIR", _ext.BUILD_DIR)
    path = compile_cache.enable_persistent_cache(str(tmp_path / "cache"))
    assert path.is_dir() and _ext.BUILD_DIR == path
    assert compile_cache.enable_persistent_cache() == _ext.DEFAULT_BUILD_DIR
    cfg = sp.RenderConfig(width=16, height=8, percent_black=-1.0)
    fn, stats = compile_cache.aot_compile(
        sp.render_fast, t["scene"], t["cam"], cfg, t["bg"], t["tex"],
        overflow="ignore")
    assert fn is sp.render_fast
    assert stats["first_call_seconds"] > 0.0
    if not torch.cuda.is_available():
        assert stats["build_seconds"] == 0.0 and stats["peak_bytes"] is None


MODULES = ["textures", "compose", "kernel", "kernel_scene", "inverse",
           "compile_cache", None]


@pytest.mark.parametrize("module", MODULES,
                         ids=[m or "package" for m in MODULES])
def test_public_names_exist_in_port(module):
    """Every public function, class and constant of the JAX module (every
    public name of the package) has a counterpart of the same name."""
    jname = "schwarzschild_tpu" + (f".{module}" if module else "")
    jmod = importlib.import_module(jname)
    tmod = importlib.import_module(jname.replace("schwarzschild_tpu",
                                                 "schwarzschild_tpu_torch"))
    names = [n for n, obj in vars(jmod).items() if not n.startswith("_")
             and not inspect.ismodule(obj)
             and (module is None or n.isupper()
                  or getattr(obj, "__module__", None) == jname)]
    assert names
    assert [n for n in names if not hasattr(tmod, n)] == []


# The TPU launch knobs: Pallas's interpreter switch and block shapes.
TPU_KNOBS = {"interpret", "block_h", "block_w"}


@pytest.mark.parametrize("name", ["kernel.march_bh", "kernel.march_bh_diff",
                                  "kernel_scene.march_scene",
                                  "kernel_scene.march_scene_diff",
                                  "kernel_scene.render_fast",
                                  "compose.compose_atlas"])
def test_keywords_match_jax(name):
    """The JAX function's parameters, less the TPU launch knobs, exist in
    the port's with the same defaults."""
    module, fn = name.split(".")
    jsig = inspect.signature(getattr(importlib.import_module(
        f"schwarzschild_tpu.{module}"), fn)).parameters
    tsig = inspect.signature(getattr(importlib.import_module(
        f"schwarzschild_tpu_torch.{module}"), fn)).parameters
    assert TPU_KNOBS & set(jsig) or fn == "compose_atlas"
    for key, param in jsig.items():
        if key in TPU_KNOBS:
            continue
        assert key in tsig, key
        assert tsig[key].default == param.default, key
