"""The port's full-scene march and frame held against the JAX package on the
CPU: ``march_scene_torch`` (the plain version of the CUDA kernel) against
the Pallas ``march_scene`` in interpret mode, and ``render_fast`` against
its JAX twin on the demo scene.  Each JAX reference runs once per module:
an interpret-mode frame costs tens of seconds."""

import jax
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import camera as jcam
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import geometry as jgeo
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import kernel_scene as tks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def frac_close(a, b, name, tol=1e-4, frac=0.995):
    """tests/test_kernel_scene.py's rule (test_march_twin_matches_kernel)."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.abs(a - b) < tol * (1.0 + np.abs(b))
    while ok.ndim > 2:
        ok = ok.all(-1)
    assert ok.mean() > frac, f"{name}: only {ok.mean():.4f} lanes within {tol}"


def frame_close(ref, got, frac=0.995):
    """tests/test_kernel_scene.py's _check rule for frames."""
    d = np.abs(np.asarray(ref) - np.asarray(got)).max(-1)
    ok = (d < 2e-3).mean()
    assert ok > frac, f"only {ok:.4f} within tol, max {d.max():.3g}"


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


def test_scene_tables_match(demo):
    j, t = demo
    ref = jks._pack_scene_smem(j["scene"], tex=j["tex"])
    got = tks._pack_scene_smem(t["scene"], t["tex"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    # The box becomes six rectangle rows after the demo's one rectangle.
    assert got["rects"].shape == (7, 15)


@pytest.fixture(scope="module", params=["opaque_stop", "record_all"])
def march_case(demo, request):
    """32x24 demo rays, a quarter of the lanes inactive, marched once by
    the JAX kernel in interpret mode: with the texture stack (the march
    stops at provably opaque hits) and without (every hit is recorded)."""
    j, _ = demo
    tex = j["tex"] if request.param == "opaque_stop" else None
    W, H = 32, 24
    cfg = st.RenderConfig(width=W, height=H, percent_black=-1.0)
    u, v = jcam.pixel_grid(W, H)
    o, d = jcam.generate_rays(j["cam"], u, v, W, H)
    active = (~jphys.is_radial(d, jgeo.safe_normalize(o))
              & (jax.numpy.asarray(np.random.default_rng(1).random((H, W)))
                 > 0.25))
    out = jks.march_scene(o, d, active, 1.0, j["scene"], cfg, n_slots=4,
                          interpret=True, tex=tex)
    return dict(cfg=cfg, o=np.asarray(o), d=np.asarray(d),
                active=np.asarray(active), ref=_np(out),
                opaque_stop=tex is not None)


def test_march_scene_torch_matches_pallas(demo, march_case):
    _, t = demo
    c = march_case
    fdir, fpos, status, slots, nhits = tks.march_scene_torch(
        _t(c["o"]), _t(c["d"]), _t(c["active"]), 1.0, t["scene"],
        convert.render_config(c["cfg"]), n_slots=4,
        tex=t["tex"] if c["opaque_stop"] else None)
    r = c["ref"]
    frac_close(fdir.numpy(), r[0], "fdir")
    frac_close(fpos.numpy(), r[1], "fpos", tol=1e-2)
    frac_close(status.numpy(), r[2], "status")
    frac_close(nhits.numpy(), r[4], "nhits")
    assert len(slots) == 4
    for i, ((s0, d0, l0), (s1, d1, l1)) in enumerate(zip(slots, r[3])):
        frac_close(s0.numpy(), s1, f"slot{i}.start", tol=1e-2)
        frac_close(d0.numpy(), d1, f"slot{i}.dir")
        frac_close(l0.numpy(), l1, f"slot{i}.len", tol=1e-2)
    s = status.numpy()
    assert (s == 1.0).any() and (s == 2.0).any()
    if c["opaque_stop"]:
        # Every demo texture is opaque: rays stop at their first object.
        assert (s == 4.0).any() and nhits.numpy().max() == 1
    else:
        assert not (s == 4.0).any() and (nhits.numpy() >= 2).any()


def test_march_scene_wrapper_runs_plain_version_on_cpu(demo, march_case):
    _, t = demo
    c = march_case
    args = (_t(c["o"]), _t(c["d"]), _t(c["active"]), 1.0, t["scene"],
            convert.render_config(c["cfg"]))
    before = tks.march_scene.launches
    a = tks.march_scene(*args, n_slots=2)
    b = tks.march_scene_torch(*args, n_slots=2)
    assert tks.march_scene.launches == before
    for x, y in zip(a[:3] + (a[4],), b[:3] + (b[4],)):
        assert torch.equal(x, y)
    for sa, sb in zip(a[3], b[3]):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.fixture(scope="module")
def frames(demo):
    """JAX render_fast frames (interpret mode), each rendered once: the demo
    scene at 48x32, and a 32x32 split screen with hash noise at 0.75, the
    crosshair, a soft horizon and r_s = 0.7.  (Each interpret-mode frame
    costs ~20 s whatever its size, so the options share one frame.)"""
    j, _ = demo
    cases = {
        "demo": (st.RenderConfig(width=48, height=32, percent_black=-1.0),
                 1.0),
        "split_noise_crosshair_soft": (st.RenderConfig(
            width=32, height=32, raytrace_type=st.HALF_WIDTH,
            percent_black=0.75, noise_mode="hash", crosshair=True,
            horizon_softness=0.05), 0.7),
    }
    return {name: (cfg, r_s, np.asarray(jks.render_fast(
        j["scene"], j["cam"], cfg, j["bg"], j["tex"], r_s, interpret=True)))
        for name, (cfg, r_s) in cases.items()}


@pytest.mark.parametrize("name", ["demo", "split_noise_crosshair_soft"])
def test_render_fast_matches_pallas(demo, frames, name):
    """The default frame (bilinear: the fetch-atlas levels, compacted
    where the frame has the tiles for it) against JAX's default frame."""
    _, t = demo
    cfg, r_s, ref = frames[name]
    got = tks.render_fast(t["scene"], t["cam"], convert.render_config(cfg),
                          t["bg"], t["tex"], r_s)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    frame_close(ref, got.numpy())


def test_render_fast_overflow_modes(demo):
    _, t = demo
    cfg = sp.RenderConfig(width=24, height=16, percent_black=-1.0)
    args = (t["scene"], t["cam"], cfg, t["bg"], t["tex"], 1.0)
    # Without the opaque stop every crossing is recorded, and one slot
    # cannot hold a ray that crosses the accretion disk twice.
    kw = dict(opaque_stop=False)
    img, n_over = tks.render_fast(*args, n_slots=1, overflow="return", **kw)
    assert n_over > 0
    with pytest.warns(UserWarning, match="exceeded n_slots=1"):
        tks.render_fast(*args, n_slots=1, **kw)
    assert torch.equal(
        tks.render_fast(*args, n_slots=1, overflow="ignore", **kw), img)
    img_auto, n = tks.render_fast_auto(*args, start_slots=1, max_slots=8,
                                       **kw)
    assert n > 1
    _, n_left = tks.render_fast(*args, n_slots=n, overflow="return", **kw)
    assert n_left == 0
    assert torch.equal(img_auto, tks.render_fast(*args, n_slots=n,
                                                 overflow="ignore", **kw))
    with pytest.raises(ValueError):
        tks.render_fast(*args, overflow="loud")


@pytest.mark.parametrize("option", ["test_ray", "mesh", "differentiable",
                                    "precomputed", "compact_slots", "atlas"])
def test_render_fast_rejects_unported_options(demo, option, tmp_path):
    _, t = demo
    cfg = sp.RenderConfig(width=8, height=8, percent_black=-1.0)
    args = (t["scene"], t["cam"], cfg, t["bg"], t["tex"])
    if option == "precomputed":
        # Ported since: the frame's own grid quantities give the frame,
        # and a tile of them (rows 2-5, columns 1-6) the frame's tile.
        from schwarzschild_tpu_torch import kernel

        planes = kernel.grid_planes(t["cam"], cfg, "cpu")
        img = tks.render_fast(*args)
        assert torch.equal(tks.render_fast(t["scene"], None, *args[2:],
                                           precomputed=planes), img)
        part = kernel.take_pixels(planes, (2, 5), (1, 6))
        assert torch.equal(tks.render_fast(t["scene"], None, *args[2:],
                                           precomputed=part), img[2:5, 1:6])
        return
    if option == "mesh":
        # Ported since: a one-rank gloo group's mesh gives the same frame
        # (tests/test_torch_sharding.py holds it on four ranks).
        import torch.distributed as dist

        from schwarzschild_tpu_torch import sharding

        dist.init_process_group("gloo",
                                init_method=f"file://{tmp_path}/store",
                                world_size=1, rank=0)
        try:
            img = tks.render_fast(*args, mesh=sharding.make_mesh())
        finally:
            dist.destroy_process_group()
        assert torch.equal(img, tks.render_fast(*args))
        return
    if option == "differentiable":
        # Ported since: the same frame, now with a graph.
        assert torch.equal(tks.render_fast(*args, differentiable=True),
                           tks.render_fast(*args))
        return
    if option == "test_ray":
        # Ported since: the frame with the demo camera's (radial) test ray,
        # against the dense renderer's.
        from schwarzschild_tpu_torch import features

        tr = features.calculate_test_ray(t["cam"], device="cpu")
        img = tks.render_fast(*args, test_ray=tr)
        dense = sp.render(*args, test_ray=tr)
        assert ((img - dense).abs().amax(-1) < 2e-3).float().mean() >= 0.99
        return
    if option == "compact_slots":
        # Ported since: compacted levels ("auto", the default, or per-pass
        # capacities) give the full-frame levels' frame bit for bit.
        full = tks.render_fast(*args, compact_slots=None)
        for value in ("auto", (None, 16, 16, 16)):
            assert torch.equal(tks.render_fast(*args, compact_slots=value),
                               full)
        return
    # atlas: ported since; a prebuilt atlas gives the frame that the one
    # render_fast builds gives.
    from schwarzschild_tpu_torch import textures

    atlas = textures.build_atlas(t["bg"], t["tex"])
    assert torch.equal(tks.render_fast(*args, atlas=atlas),
                       tks.render_fast(*args))


def test_trilinear_filter_matches_pallas(demo):
    """texture_filter="trilinear" against the JAX frame (interpret mode) at
    24x16, by the frame rule; an unknown filter raises ValueError.  The JAX
    frame is evaluated op by op, as the port's is: under jax.jit XLA's
    fusion moves a few background pixels' LOD between two mip levels (JAX
    against itself; tests/test_torch_trilinear.py)."""
    j, t = demo
    cfg = st.RenderConfig(width=24, height=16, percent_black=-1.0,
                          texture_filter="trilinear")
    ref = np.asarray(jks.render_fast(j["scene"], j["cam"], cfg, j["bg"],
                                     j["tex"], 1.0, interpret=True,
                                     overflow="ignore"))
    got = tks.render_fast(t["scene"], t["cam"], convert.render_config(cfg),
                          t["bg"], t["tex"], 1.0, overflow="ignore")
    assert torch.isfinite(got).all()
    frame_close(ref, got.numpy())
    with pytest.raises(ValueError, match="texture_filter"):
        tks.render_fast(t["scene"], t["cam"], sp.RenderConfig(
            width=8, height=8, texture_filter="nearest"), t["bg"], t["tex"])
