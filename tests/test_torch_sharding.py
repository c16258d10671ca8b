"""The port's tile sharding (``schwarzschild_tpu_torch.sharding``) on a
4-rank gloo world of CPU processes.

One world is started for the module and runs every check; the tests read
its results.  A sharded frame must equal the unsharded frame exactly, on
meshes (4, 1) and (2, 2) with 30 rows (an uneven split over 4), for
renderer "fast" (bilinear; trilinear on a 32-row frame, since it needs a
dividing mesh) and "jnp" (bilinear, and trilinear with its halo), and
``march_bh(mesh=)``, ``march_scene(mesh=)`` and
``render_horizon_sky(mesh=)`` must equal their unmeshed planes.  Gradients
in r_s and cam.pos through ``render_fast(mesh=, differentiable=True)``,
the tile-local differentiable "fast" frame and the sharded "jnp" frame
(also of a 3-row frame, whose last rank's tile is empty) must match the unsharded ones within rtol 1e-3, atol 1e-6 (the JAX
suite's test_sharded_gradient_psum rule: the sum over tiles is taken in
another order).  The ranks' processes never import jax: the one test that
compares with the JAX package imports it itself.
"""

import dataclasses
import hashlib
import multiprocessing
import pickle
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
MESHES = [(4, 1), (2, 2)]
H, W = 30, 12  # 30 rows over 4: an uneven split
JOIN_SECONDS = 240

FRAME_CASES = ["fast_bilinear", "fast_trilinear", "jnp_bilinear",
               "jnp_trilinear", "march_bh", "march_scene",
               "render_horizon_sky"]
GRAD_CASES = ["render_fast_mesh", "fast_tiles", "jnp", "jnp_empty_tile"]


def _frame_cases(sp, configs, kernel, kernel_scene, sharding):
    """{name: (sharded(mesh), unsharded())}: each returns a list of
    tensors that must be equal."""
    d = "cpu"
    sc, cam = configs.demo_scene(device=d), configs.demo_camera(device=d)
    bg = configs.background_texture(device=d)
    tex = configs.demo_texture_stack(device=d)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0,
                          max_steps=20, checkpoint_every=10)
    tri = dataclasses.replace(cfg, texture_filter="trilinear")
    tri32 = dataclasses.replace(tri, height=32)
    from schwarzschild_tpu_torch import camera as cam_mod
    from schwarzschild_tpu_torch import geometry as geo
    from schwarzschild_tpu_torch import physics

    u, v = cam_mod.pixel_grid(W, H, device=d)
    o, dr = cam_mod.generate_rays(cam, u, v, W, H)
    act = ~physics.is_radial(dr, geo.safe_normalize(o)) & (
        torch.arange(H * W).reshape(H, W) % 5 != 0)

    def frame(c, renderer):
        return (lambda m: [sharding.make_sharded_render(m, c, renderer)(
                    sc, cam, bg, tex)],
                lambda: [sp.render_fast(sc, cam, c, bg, tex, 1.0,
                                        overflow="ignore")
                         if renderer == "fast"
                         else sp.render(sc, cam, c, bg, tex, 1.0)])

    def bh(m=None):
        fdir, status, ev = kernel.march_bh(o, dr, act, 1.0, cfg, events=True,
                                           mesh=m)
        return [fdir, status, ev["t_end"], ev["died_moving"]]

    def scene(m=None):
        out = kernel_scene.march_scene(o, dr, act, 1.0, sc, cfg, 3, tex,
                                       events=True, mesh=m)
        fdir, fpos, status, slots, nhits, ev = out
        return [fdir, fpos, status, nhits, ev["t_end"], *ev["ssteps"],
                *(x for slot in slots for x in slot)]

    def sky(m=None):
        return [sp.render_horizon_sky(cam, cfg, bg, 1.0, mesh=m)]

    return {
        "fast_bilinear": frame(cfg, "fast"),
        "fast_trilinear": frame(tri32, "fast"),
        "jnp_bilinear": frame(cfg, "jnp"),
        "jnp_trilinear": frame(tri, "jnp"),
        "march_bh": (bh, bh),
        "march_scene": (scene, scene),
        "render_horizon_sky": (sky, sky),
    }, (sc, cam, bg, tex, cfg)


def _grads(render, cam, w):
    """d sum(render(cam, r_s) * w) / d (r_s, cam.pos)."""
    pos = cam.pos.clone().requires_grad_(True)
    r_s = torch.tensor(1.0, requires_grad=True)
    img = render(cam._replace(pos=pos), r_s)
    g = torch.autograd.grad((img * w).sum(), [r_s, pos])
    return [x.numpy() for x in g]


def _checks(rank):
    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs, kernel, kernel_scene, sharding

    import sys

    res = {"jax_imported": "jax" in sys.modules}
    mesh = sharding.make_mesh()
    res["default_mesh_shape"] = tuple(mesh.shape)
    try:
        sharding.make_mesh(shape=(3, 1))
        res["bad_shape_raises"] = False
    except ValueError:
        res["bad_shape_raises"] = True
    meshes = {(4, 1): mesh, (2, 2): sharding.make_mesh(shape=(2, 2))}
    cases, (sc, cam, bg, tex, cfg) = _frame_cases(
        sp, configs, kernel, kernel_scene, sharding)
    try:
        sharding.make_sharded_render(
            mesh, dataclasses.replace(cfg, texture_filter="trilinear"),
            "fast")
        res["trilinear_uneven_raises"] = False
    except ValueError:
        res["trilinear_uneven_raises"] = True

    for name, (sharded, unsharded) in cases.items():
        ref = unsharded() if rank == 0 else None
        for shape, m in meshes.items():
            got = sharded(m)
            if rank == 0:
                res[(name, shape)] = all(
                    torch.equal(a, b) for a, b in zip(got, ref))
            if name == "jnp_bilinear":
                img = sharding.gather_image(got[0])
                res[("gather_sha", shape)] = hashlib.sha256(
                    img.tobytes()).hexdigest()

    w = torch.from_numpy(np.random.default_rng(3).random(
        (H, W, 4)).astype(np.float32))
    gcfg = cfg
    renders = {
        "render_fast_mesh": lambda m: lambda c, r: sp.render_fast(
            sc, c, gcfg, bg, tex, r, overflow="ignore", differentiable=True,
            mesh=m),
        "fast_tiles": lambda m: lambda c, r: sharding.make_sharded_render(
            m, gcfg, "fast", differentiable=True)(sc, c, bg, tex, r),
        "jnp": lambda m: lambda c, r: sharding.make_sharded_render(
            m, gcfg, "jnp")(sc, c, bg, tex, r),
    }
    unsharded = (
        lambda c, r: sp.render_fast(sc, c, gcfg, bg, tex, r,
                                    overflow="ignore", differentiable=True),
        lambda c, r: sp.render(sc, c, gcfg, bg, tex, r))
    for name, make in renders.items():
        res[("grad", name)] = _grads(make(mesh), cam, w)
        if rank == 0:
            res[("grad_ref", name)] = _grads(unsharded[name == "jnp"], cam,
                                             w)
    # 3 rows over 4 ranks: rank 3's tile is empty and depends on nothing,
    # yet its backward must join the others' sum over the ranks.
    thin = dataclasses.replace(gcfg, height=3)
    res[("grad", "jnp_empty_tile")] = _grads(
        lambda c, r: sharding.make_sharded_render(mesh, thin, "jnp")(
            sc, c, bg, tex, r), cam, w[:3])
    if rank == 0:
        res[("grad_ref", "jnp_empty_tile")] = _grads(
            lambda c, r: sp.render(sc, c, thin, bg, tex, r), cam, w[:3])

    small = dataclasses.replace(cfg, width=16, height=16)
    res["jnp_16x16"] = sharding.gather_image(
        sharding.make_sharded_render(mesh, small, "jnp")(sc, cam, bg, tex))
    return res


def _rank_main(rank, store, out_path):
    """One rank of the world: join, run the checks, pickle the results
    (or the traceback)."""
    torch.set_num_threads(1)
    from schwarzschild_tpu_torch import sharding

    try:
        sharding.initialize_distributed(f"file://{store}", WORLD, rank,
                                        device="cpu")
        try:
            res = _checks(rank)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001  (reported by the parent test)
        res = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4-rank gloo world once; its ranks' results.  The ranks
    come from a fork server: one fresh interpreter (no JAX, no threads)
    imports torch once and forks them, where four spawned interpreters
    would import it four times (about 2 s each on one core)."""
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "schwarzschild_tpu_torch.sharding"])
    outs = [tmp / f"rank{r}.pkl" for r in range(WORLD)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), str(outs[r])))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_SECONDS)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks still running after {JOIN_SECONDS} s: {hung}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res["error"]
        results.append(res)
    return results


def test_make_mesh_shapes(world):
    res = world[0]
    assert not any(r["jax_imported"] for r in world)
    assert res["default_mesh_shape"] == (4, 1)
    assert res["bad_shape_raises"]
    assert res["trilinear_uneven_raises"]


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", FRAME_CASES)
def test_sharded_equals_unsharded(world, name, shape):
    assert world[0][(name, shape)]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_sharded_gradients_match(world, name):
    ref = world[0][("grad_ref", name)]
    for res in world:  # every rank holds the whole gradient
        for a, b in zip(res[("grad", name)], ref):
            assert np.all(np.isfinite(a))
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_gather_image_same_on_every_rank(world, shape):
    shas = {res[("gather_sha", shape)] for res in world}
    assert len(shas) == 1


def test_sharded_jnp_frame_matches_jax(world):
    """The port's sharded "jnp" frame at 16x16 on a (4, 1) mesh against the
    JAX package's make_sharded_render on 4 CPU devices, by
    tests/test_torch_render.py's dense-frame rule."""
    import jax

    import schwarzschild_tpu as st
    from schwarzschild_tpu import configs as jconfigs
    from schwarzschild_tpu.sharding import (gather_image, make_mesh,
                                            make_sharded_render)

    cfg = st.RenderConfig(width=16, height=16, percent_black=-1.0,
                          max_steps=20, checkpoint_every=10)
    mesh = make_mesh(jax.devices()[:4], (4, 1))
    ref = gather_image(make_sharded_render(mesh, cfg)(
        jconfigs.demo_scene(), jconfigs.demo_camera(),
        jconfigs.background_texture(), jconfigs.demo_texture_stack()))
    got = world[0]["jnp_16x16"]
    assert got.shape == ref.shape == (16, 16, 4)
    d = np.abs(got - ref).max(-1)
    assert (d < 2e-3).mean() >= 0.995, (d < 2e-3).mean()
    assert np.median(d) < 5e-4, np.median(d)
