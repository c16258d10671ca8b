"""The CUDA march kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu_torch import camera as cam_mod
from schwarzschild_tpu_torch import configs
from schwarzschild_tpu_torch import geometry as geo
from schwarzschild_tpu_torch import kernel, kernel_scene, physics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _rays(dev, W, H, drop=0.0):
    cam = configs.demo_camera(device=dev)
    u, v = cam_mod.pixel_grid(W, H, device=dev)
    o, d = cam_mod.generate_rays(cam, u, v, W, H)
    active = ~physics.is_radial(d, geo.safe_normalize(o))
    if drop:
        g = torch.Generator(device="cpu").manual_seed(0)
        active &= (torch.rand((H, W), generator=g) >= drop).to(dev)
    return o, d, active


def _agree(a, b, frac=0.999):
    ok = a == b
    assert ok.float().mean().item() >= frac, ok.float().mean().item()


# 77 x 43 = 3311 rays: not a multiple of the 128-thread block.
@pytest.mark.parametrize("size,drop", [((77, 43), 0.3), ((256, 256), 0.0)])
def test_march_bh_kernel_matches_plain(dev, size, drop):
    o, d, active = _rays(dev, *size, drop=drop)
    cfg = sp.RenderConfig(width=size[0], height=size[1], percent_black=-1.0)
    before = kernel.march_bh.launches
    fdir, status = kernel.march_bh(o, d, active, 1.0, cfg)
    torch.cuda.synchronize()
    assert kernel.march_bh.launches == before + 1
    pfdir, pstatus = kernel.march_bh_torch(o, d, active, 1.0, cfg)
    _agree(status, pstatus)
    same = status == pstatus
    assert torch.allclose(fdir[same], pfdir[same], rtol=0, atol=1e-3)
    assert (status[~active] == kernel.STATUS_ESCAPED).all()
    assert torch.equal(fdir[~active], d[~active])


# The tile-mapped horizon kernel computes its plain version's function bit
# for bit: every plane equal on every lane, with and without the event
# record.  512 x 512 is config 2's frame; 3 x 40 has fewer rows than a
# warp tile; 37 x 53 is not a whole number of 4 x 8 tiles; "flat" marches
# 37 x 53 rays as one row (a 1-D batch).
@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("size", [(512, 512), (3, 40), (37, 53), "flat"])
def test_march_bh_kernel_equals_plain_on_every_lane(dev, size, events):
    H, W = (37, 53) if size == "flat" else size
    o, d, active = _rays(dev, W, H, drop=0.1)
    if size == "flat":
        o, d, active = o.reshape(-1, 3), d.reshape(-1, 3), active.reshape(-1)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    got = kernel.march_bh(o, d, active, 1.0, cfg, events=events)
    ref = kernel.march_bh_torch(o, d, active, 1.0, cfg, events=events)
    for a, b in zip(got[:2], ref[:2]):
        assert torch.equal(a, b)
    if events:
        for key in ("t_end", "died_moving"):
            assert torch.equal(got[2][key], ref[2][key]), key
    assert (ref[1] == kernel.STATUS_CAPTURED).any()


@pytest.mark.parametrize("n_slots,opaque", [(4, True), (3, False)])
def test_march_scene_kernel_matches_plain(dev, n_slots, opaque):
    o, d, active = _rays(dev, 160, 90, drop=0.2)
    cfg = sp.RenderConfig(width=160, height=90, percent_black=-1.0)
    sc = configs.demo_scene(device=dev)
    tex = configs.demo_texture_stack(device=dev) if opaque else None
    before = kernel_scene.march_scene.launches
    out = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, n_slots, tex)
    torch.cuda.synchronize()
    assert kernel_scene.march_scene.launches == before + 1
    ref = kernel_scene.march_scene_torch(o, d, active, 1.0, sc, cfg, n_slots,
                                         tex)
    _agree(out[2], ref[2])
    _agree(out[4], ref[4])
    same = (out[2] == ref[2]) & (out[4] == ref[4])
    for a, b in [(out[0], ref[0]), (out[1], ref[1])] + [
            (x, y) for s0, s1 in zip(out[3], ref[3]) for x, y in zip(s0, s1)]:
        assert torch.allclose(a[same], b[same], rtol=1e-3, atol=1e-3)
    if not opaque:
        assert (out[4] >= 2).any()  # rays record more than one crossing


def test_empty_and_inactive_inputs(dev):
    cfg = sp.RenderConfig(width=4, height=0, percent_black=-1.0)
    empty = torch.zeros((0, 4, 3), device=dev)
    fdir, status = kernel.march_bh(empty, empty, torch.zeros(
        (0, 4), dtype=torch.bool, device=dev), 1.0, cfg)
    assert fdir.shape == (0, 4, 3) and status.shape == (0, 4)
    o, d, active = _rays(dev, 16, 8)
    out = kernel_scene.march_scene(o, d, torch.zeros_like(active), 1.0,
                                   configs.demo_scene(device=dev),
                                   dataclasses.replace(cfg, height=8,
                                                       width=16))
    assert (out[2] == kernel_scene.STATUS_ESCAPED).all()
    assert (out[4] == 0).all() and all((s[2] == 0).all() for s in out[3])


def test_wrappers_refuse_non_contiguous_input(dev):
    o, d, active = _rays(dev, 16, 8)
    cfg = sp.RenderConfig(width=16, height=8)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.march_bh(o.transpose(0, 1), d.transpose(0, 1), active.T,
                        1.0, cfg)


@pytest.mark.parametrize("raytrace_type", [sp.CURVED, sp.HALF_WIDTH])
def test_render_fast_on_card_matches_cpu(dev, raytrace_type):
    cfg = sp.RenderConfig(width=64, height=36, percent_black=0.5,
                          raytrace_type=raytrace_type, crosshair=True)
    args = [configs.demo_scene(device="cpu"), configs.demo_camera(device="cpu"),
            cfg, configs.background_texture(device="cpu"),
            configs.demo_texture_stack(device="cpu")]
    cpu = sp.render_fast(*args)
    gpu = sp.render_fast(*[sp.to_device(a, dev) for a in args]).cpu()
    ok = ((gpu - cpu).abs().amax(-1) < 2e-3).float().mean().item()
    assert ok >= 0.995, ok


def _bwd_inputs(dev, W, H, n_slots, seed=0):
    """Demo rays marched by the forward kernel with its event planes, and
    random cotangents for every differentiable output."""
    o, d, active = _rays(dev, W, H, drop=0.1)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    out = kernel_scene.march_scene(o, d, active, 1.0,
                                   configs.demo_scene(device=dev), cfg,
                                   n_slots, configs.demo_texture_stack(
                                       device=dev), events=True)
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    cts = (rnd(H, W, 3), rnd(H, W, 3),
           [(rnd(H, W, 3), rnd(H, W, 3), rnd(H, W)) for _ in range(n_slots)])
    return o, d, cfg, out, cts


def _assert_adjoint_close(got, ref):
    """tests/test_adjoint.py's rule: per output max |diff| <= 2e-3 of the
    plain version's max |value|; g_r_s within 2e-3 relative."""
    for a, b in zip(got[:2], ref[:2]):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max().item() <= 2e-3 * b.abs().max().item()
    assert abs(got[2].item() - ref[2].item()) <= 2e-3 * abs(ref[2].item())


@pytest.mark.parametrize("n_slots", [4, 0])
def test_march_scene_bwd_kernel_matches_plain(dev, n_slots):
    o, d, cfg, out, cts = _bwd_inputs(dev, 160, 90, n_slots)
    before = kernel_scene.march_scene_bwd.launches
    got = kernel_scene.march_scene_bwd(o, d, 1.0, cfg, cts, out[2], out[5],
                                       n_slots)
    torch.cuda.synchronize()
    assert kernel_scene.march_scene_bwd.launches == before + 1
    ref = kernel_scene.march_scene_bwd_torch(o, d, 1.0, cfg, cts, out[2],
                                             out[5], n_slots)
    _assert_adjoint_close(got, ref)


def test_march_bh_events_and_adjoint_match_plain(dev):
    o, d, active = _rays(dev, 128, 96, drop=0.1)
    cfg = sp.RenderConfig(width=128, height=96, percent_black=-1.0)
    fdir, status, ev, steps = kernel.march_bh(o, d, active, 1.0, cfg,
                                              events=True, count_steps=True)
    pf, ps, pev = kernel.march_bh_torch(o, d, active, 1.0, cfg, events=True)
    same = status == ps
    _agree(status, ps)
    assert torch.equal(ev["t_end"][same], pev["t_end"][same])
    assert torch.equal(ev["died_moving"][same], pev["died_moving"][same])
    assert int(steps) == int(kernel.steps_of(ev["t_end"], cfg.max_steps))
    ct = torch.randn(o.shape, generator=torch.Generator().manual_seed(0)
                     ).to(dev)
    args = (o, d, 1.0, cfg, (ct, torch.zeros_like(o), []), None,
            dict(t_end=ev["t_end"], ssteps=[], died_moving=ev["died_moving"]))
    _assert_adjoint_close(kernel_scene.march_scene_bwd(*args, n_slots=0),
                          kernel_scene.march_scene_bwd_torch(*args,
                                                             n_slots=0))


def test_march_scene_events_match_plain(dev):
    o, d, active = _rays(dev, 160, 90, drop=0.2)
    cfg = sp.RenderConfig(width=160, height=90, percent_black=-1.0)
    sc = configs.demo_scene(device=dev)
    got = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, 3,
                                   events=True, count_steps=True)
    ref = kernel_scene.march_scene_torch(o, d, active, 1.0, sc, cfg, 3,
                                         events=True)
    same = (got[2] == ref[2]) & (got[4] == ref[4])
    assert same.float().mean().item() >= 0.999
    assert torch.equal(got[5]["t_end"][same], ref[5]["t_end"][same])
    for a, b in zip(got[5]["ssteps"], ref[5]["ssteps"]):
        assert torch.equal(a[same], b[same])
    assert int(got[6]) == int(kernel.steps_of(got[5]["t_end"], cfg.max_steps))


def test_gradient_frame_launches_adjoint_and_matches_cpu(dev):
    cfg = sp.RenderConfig(width=48, height=32, percent_black=-1.0)
    w = torch.rand((32, 48, 4), generator=torch.Generator().manual_seed(0))

    def grads(device):
        cam = configs.demo_camera(device=device)
        pos = cam.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=device, requires_grad=True)
        img = sp.render_fast(configs.demo_scene(device=device),
                             cam._replace(pos=pos), cfg,
                             configs.background_texture(device=device),
                             configs.demo_texture_stack(device=device), r_s,
                             overflow="ignore", differentiable=True)
        return torch.autograd.grad((img * w.to(device)).sum(), [r_s, pos])

    before = kernel_scene.march_scene_bwd.launches
    gpu = grads(dev)
    torch.cuda.synchronize()
    assert kernel_scene.march_scene_bwd.launches == before + 1
    cpu = grads("cpu")
    for a, b in zip(gpu, cpu):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.cpu(), b, rtol=2e-2, atol=1e-3)


def _scene_of(name, dev):
    if name == "demo":
        return (configs.demo_scene(device=dev),
                configs.demo_texture_stack(device=dev))
    return (configs._orbiting_planets_scene(device=dev),
            configs.planet_texture_stack(device=dev))


def _assert_every_lane_equal(got, ref):
    for a, b in [(got[0], ref[0]), (got[1], ref[1]), (got[2], ref[2]),
                 (got[4], ref[4]), (got[5]["t_end"], ref[5]["t_end"])] + [
            (x, y) for s0, s1 in zip(got[3], ref[3]) for x, y in zip(s0, s1)
    ] + list(zip(got[5]["ssteps"], ref[5]["ssteps"])):
        assert torch.equal(a, b)
    assert (ref[4] >= 1).any()  # rays hit the scene


# The culled, tile-mapped kernel computes the unculled plain version's
# function bit for bit: every plane equal on every lane.  77 x 43 is not a
# whole number of 4 x 8 warp tiles; "flat" marches the same rays as one row
# (a 1-D batch: one row per warp).  "device" reads the tables from device
# memory, the route of a scene too large for a block's shared copy.
@pytest.mark.parametrize("tables", ["shared", "device"])
@pytest.mark.parametrize("scene", ["demo", "config3"])
@pytest.mark.parametrize("size", [(77, 43), (256, 144), "flat"])
def test_march_scene_kernel_equals_plain_on_every_lane(dev, scene, size,
                                                       tables, monkeypatch):
    if tables == "device":
        monkeypatch.setattr(kernel_scene, "SHARED_TABLE_WORDS", 0)
    W, H = (77, 43) if size == "flat" else size
    o, d, active = _rays(dev, W, H, drop=0.1)
    if size == "flat":
        o, d, active = o.reshape(-1, 3), d.reshape(-1, 3), active.reshape(-1)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    sc, tex = _scene_of(scene, dev)
    got = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, 4, tex,
                                   events=True)
    ref = kernel_scene.march_scene_torch(o, d, active, 1.0, sc, cfg, 4, tex,
                                         events=True)
    _assert_every_lane_equal(got, ref)


# A scene whose tables exceed a block's shared copy: 500 small spheres on a
# shell about the hole, and a cylinder along the world's y axis.
def test_march_scene_kernel_tables_past_shared_memory(dev):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(500, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(
        4, 12, (500, 1))
    objects = [sp.Sphere(pos=tuple(map(float, p)), radius=0.4) for p in pos]
    objects.append(sp.LateralCylinder(pos=(3.0, -4.0, 0.0), height=8.0,
                                      radius=0.5))
    sc = sp.build_scene(objects, device=dev)
    words = kernel_scene._kernel_buffer(kernel_scene._pack_scene_smem(sc),
                                        0)[0].size
    assert words > kernel_scene.SHARED_TABLE_WORDS
    W, H = 24, 16
    o, d, active = _rays(dev, W, H)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0,
                          max_steps=30)
    got = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, 4,
                                   events=True)
    ref = kernel_scene.march_scene_torch(o, d, active, 1.0, sc, cfg, 4,
                                         events=True)
    _assert_every_lane_equal(got, ref)


# The debug test ray's tubes ride the cylinder table (101 rows: the flat
# tube, the chain, the inactive rows of height -1): every plane equal on
# every lane through both table routes, for the demo camera's radial ray
# and a ray that bends into the horizon (34 points), seen from the demo
# camera and from the side.
@pytest.mark.parametrize("tables", ["shared", "device"])
@pytest.mark.parametrize("aim", [None, (2.5, 0.0, 0.0)])
@pytest.mark.parametrize("view", ["demo", "side"])
def test_march_scene_tube_rows_equal_plain_on_every_lane(dev, tables, aim,
                                                         view, monkeypatch):
    from schwarzschild_tpu_torch import features

    if tables == "device":
        monkeypatch.setattr(kernel_scene, "SHARED_TABLE_WORDS", 0)
    demo = configs.demo_camera(device=dev)
    src = demo if aim is None else cam_mod.look_at(
        demo, torch.tensor(aim, device=dev))
    tr = features.calculate_test_ray(src, device=dev)
    cam = demo if view == "demo" else cam_mod.look_at(
        cam_mod.make_camera((6.0, 3.0, 6.0), fov=30.0, device=dev),
        torch.tensor((1.2, 0.4, 3.0), device=dev))
    W, H = 96, 64
    u, v = cam_mod.pixel_grid(W, H, device=dev)
    o, d = cam_mod.generate_rays(cam, u, v, W, H)
    active = ~physics.is_radial(d, geo.safe_normalize(o))
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    sc, tex = _scene_of("demo", dev)
    got = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, 6, tex,
                                   events=True, test_ray=tr)
    ref = kernel_scene.march_scene_torch(o, d, active, 1.0, sc, cfg, 6, tex,
                                         events=True, test_ray=tr)
    _assert_every_lane_equal(got, ref)


# The dense renderer is plain torch: on the card it matches the CPU frame,
# with the test ray, and render_fast with tubes matches it.
def test_dense_render_on_card_matches_cpu(dev):
    from schwarzschild_tpu_torch import features

    cfg = sp.RenderConfig(width=48, height=32, max_steps=60,
                          percent_black=-1.0)
    frames = []
    for device in (dev, torch.device("cpu")):
        tr = features.calculate_test_ray(configs.demo_camera(device=device),
                                         device=device)
        args = (configs.demo_scene(device=device),
                configs.demo_camera(device=device), cfg,
                configs.background_texture(device=device),
                configs.demo_texture_stack(device=device), 1.0)
        frames.append((sp.render(*args, test_ray=tr),
                       sp.render_fast(*args, n_slots=6, test_ray=tr)))
    (dense, fast), (cpu_dense, _) = frames
    for a, b in ((dense.cpu(), cpu_dense), (fast, dense)):
        share = ((a - b).abs().amax(-1) < 2e-3).float().mean().item()
        assert share >= 0.99, share


# The checkpointed adjoint: 37 steps is not a whole number of checkpoint
# intervals; u_f = 0.1 puts the far-field sphere at r = 10, inside the
# camera's r = 15.1, so rays re-enter it at their first step; a fifth of
# the lanes never march.
@pytest.mark.parametrize("n_slots", [4, 0])
def test_march_scene_bwd_checkpoints_match_plain(dev, n_slots):
    W, H = 96, 64
    o, d, active = _rays(dev, W, H, drop=0.2)
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0,
                          max_steps=37, u_f=0.1)
    assert cfg.max_steps % kernel_scene.BWD_CHECKPOINT_EVERY
    sc, tex = _scene_of("demo", dev)
    out = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, n_slots, tex,
                                   events=True)
    t_end = out[5]["t_end"]
    assert ((t_end >= 1) & (out[2] != kernel_scene.STATUS_FLAT_FINISH)
            ).any()  # re-entered at step 0, then marched on
    assert (t_end == -1).any() and (t_end >= 8).any()
    g = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    cts = (rnd(H, W, 3), rnd(H, W, 3),
           [(rnd(H, W, 3), rnd(H, W, 3), rnd(H, W)) for _ in range(n_slots)])
    args = (o, d, 1.0, cfg, cts, out[2], out[5], n_slots)
    got = kernel_scene.march_scene_bwd(*args)
    ref = kernel_scene.march_scene_bwd_torch(*args)
    _assert_adjoint_close(got, ref)
    assert torch.equal(got[0][~active], ref[0][~active])


# The flyby on the card: one march_scene launch a rendered frame,
# none for a frame whose file exists; the frames equal direct renders.
def test_render_trajectory_launches_once_per_rendered_frame(dev, tmp_path):
    from schwarzschild_tpu_torch import animation

    c4 = configs.config4_animation(n_frames=4, device=dev)
    cfg = dataclasses.replace(c4["cfg"], width=96, height=54)

    def run(**kw):
        before = kernel_scene.march_scene.launches
        out = animation.render_trajectory(
            c4["scene"], cfg, c4["background"], c4["tex"], times=c4["times"],
            all_frames_local=True, renderer="fast", **c4["trajectory"],
            **kw)
        torch.cuda.synchronize()
        return out, kernel_scene.march_scene.launches - before

    frames, launches = run()
    assert launches == 4
    cam = cam_mod.hyperbolic_trajectory(
        cam_mod.make_camera((0.0, 2.0, 15.0), device=dev),
        time=c4["times"][2], **c4["trajectory"])
    direct = sp.render_fast(c4["scene"], cam, cfg, c4["background"],
                            c4["tex"], overflow="ignore")
    assert torch.equal(frames[2][1], direct.cpu())
    _, launches = run(out_dir=tmp_path, prefetch=2, encode_workers=2)
    assert launches == 4
    (tmp_path / "frame_00002.png").unlink()
    again, launches = run(out_dir=tmp_path, prefetch=2, encode_workers=2)
    assert launches == 1
    assert [i for i, _ in again] == [0, 1, 2, 3]


@pytest.mark.parametrize("frame", ["render_fast", "render_horizon_sky",
                                   "render_fast_gradient"])
def test_trilinear_frames_on_card_match_cpu(dev, frame):
    """texture_filter="trilinear" on the card against the CPU: frames by
    the frame rule, one march launch a frame; the gradient frame's r_s and
    texel gradients (through the mips) by the gradient rule."""
    cfg = sp.RenderConfig(width=64, height=36, percent_black=-1.0,
                          texture_filter="trilinear")
    host = [configs.demo_scene(device="cpu"),
            configs.demo_camera(device="cpu"),
            configs.background_texture(device="cpu"),
            configs.demo_texture_stack(device="cpu")]

    def run(sc, cam, bg, tex):
        if frame == "render_horizon_sky":
            return sp.render_horizon_sky(cam, cfg, bg, 1.0)
        if frame == "render_fast":
            return sp.render_fast(sc, cam, cfg, bg, tex, 1.0)
        r_s = torch.tensor(1.0, device=bg.data.device, requires_grad=True)
        data = tex.data.clone().requires_grad_(True)
        img = sp.render_fast(sc, cam, cfg, bg, tex._replace(data=data), r_s,
                             overflow="ignore", differentiable=True)
        return torch.autograd.grad(img.sum(), [r_s, data])

    wrapper = (kernel.march_bh if frame == "render_horizon_sky"
               else kernel_scene.march_scene)
    before = wrapper.launches
    gpu = run(*[sp.to_device(a, dev) for a in host])
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    cpu = run(*host)
    if frame == "render_fast_gradient":
        for g, c in zip(gpu, cpu):
            assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
            torch.testing.assert_close(g.cpu(), c, rtol=2e-2, atol=1e-3)
        return
    ok = ((gpu.cpu() - cpu).abs().amax(-1) < 2e-3).float().mean().item()
    assert ok >= 0.995, ok


@pytest.mark.parametrize("seed,shape", [(0, (720, 1280)), (7, (37, 53))])
def test_prng_field_on_card_equals_cpu(dev, seed, shape):
    """The threefry field is integer arithmetic: bit-equal on the card."""
    from schwarzschild_tpu_torch import noise

    gpu = noise.prng_uniform(seed, shape, device=dev).cpu()
    cpu = noise.prng_uniform(seed, shape, device="cpu")
    assert torch.equal(gpu.view(torch.int32), cpu.view(torch.int32))


@pytest.mark.parametrize("renderer,shape", [("fast", (3, 2)), ("jnp", (2, 1))])
def test_tiles_on_card_assemble_the_frame(dev, renderer, shape):
    """The tile function at every coordinate of a mesh on the card: the
    assembled frame equals the card's unsharded frame bit for bit, one
    march_scene launch a "fast" tile (61 rows: uneven over 3 and 2)."""
    from schwarzschild_tpu_torch import sharding

    cfg = sp.RenderConfig(width=45, height=61, percent_black=-1.0,
                          max_steps=60, checkpoint_every=10)
    args = (configs.demo_scene(device=dev), configs.demo_camera(device=dev),
            configs.background_texture(device=dev),
            configs.demo_texture_stack(device=dev))
    ref = (sp.render_fast(*args[:2], cfg, *args[2:], 1.0, overflow="ignore")
           if renderer == "fast" else sp.render(*args[:2], cfg, *args[2:]))
    tile = sharding.make_tile_render(cfg, renderer, 4, shape)
    before = kernel_scene.march_scene.launches
    tiles = [tile((i, j), *args) for i in range(shape[0])
             for j in range(shape[1])]
    torch.cuda.synchronize()
    if renderer == "fast":
        assert kernel_scene.march_scene.launches == before + len(tiles)
    assert torch.equal(sharding.assemble(tiles, 61, 45, shape), ref)


def test_march_tiles_on_card_equal_planes(dev):
    """march_scene tiles on a (2, 3) mesh with events: every assembled
    plane equals the unsharded kernel's."""
    import functools

    from schwarzschild_tpu_torch import sharding

    o, d, active = _rays(dev, 50, 33, drop=0.2)
    cfg = sp.RenderConfig(width=50, height=33, percent_black=-1.0)
    sc = configs.demo_scene(device=dev)
    march = functools.partial(kernel_scene.march_scene, sc=sc, cfg=cfg,
                              n_slots=3, events=True)
    whole = march(o, d, active, 1.0)
    parts = [sharding.march_tile(march, (2, 3), (i, j), o, d, active, 1.0)
             for i in range(2) for j in range(3)]
    flat = [torch.utils._pytree.tree_flatten(p)[0] for p in parts]
    for k, plane in enumerate(torch.utils._pytree.tree_flatten(whole)[0]):
        got = sharding.assemble([f[k] for f in flat], 33, 50, (2, 3))
        assert torch.equal(got, plane), k


def test_viewer_frame_on_card_matches_cpu(dev):
    """examples/live_viewer_torch.py's frame function on the card against
    the CPU's, for a turned camera in every raytrace mode: uint8 frames
    within 1 count on at least 99.5% of pixels."""
    import importlib.util
    from pathlib import Path

    from schwarzschild_tpu_torch import viewer

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "live_viewer_torch.py"
    spec = importlib.util.spec_from_file_location("live_viewer_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)

    def conf(device):
        return dict(scene=configs.demo_scene(device=device),
                    background=configs.background_texture(device=device),
                    tex=configs.demo_texture_stack(device=device))

    card = ex.make_renderer(conf(dev), 96, 48, dev)
    host = ex.make_renderer(conf("cpu"), 96, 48, "cpu")
    s = viewer.apply_key(viewer.initial_state(), "left")
    for key in ("1", "2", "3", "4"):
        state = viewer.apply_key(s, key)
        a, b = card(state), host(state)
        assert a.dtype == np.uint8 and a.shape == (48, 96, 3)
        diff = np.abs(a.astype(np.int16) - b).max(-1)
        assert (diff <= 1).mean() >= 0.995, key


def test_atlas_fetch_on_card_equals_cpu(dev):
    """atlas_fetch on the card, mixed layers, equals the CPU's fetch bit for
    bit and the card's own samplers; so does its compacted form."""
    from schwarzschild_tpu_torch import textures

    bg, tex = configs.background_texture(device="cpu"), \
        configs.demo_texture_stack(device="cpu")
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 5000
    u, v = torch.rand(n, generator=g) * 2 - 0.5, torch.rand(n, generator=g)
    layer = torch.randint(0, tex.data.shape[0] + 1, (n,), generator=g)
    want = torch.rand(n, generator=g) < 0.3
    ref = textures.atlas_fetch(textures.build_atlas(bg, tex), layer, u, v)
    cbg, ctex = sp.Texture(bg.data.to(dev)), tex._replace(
        data=tex.data.to(dev), sizes=tex.sizes.to(dev),
        max_size=tex.max_size.to(dev))
    atlas = textures.build_atlas(cbg, ctex)
    got = textures.atlas_fetch(atlas, layer.to(dev), u.to(dev), v.to(dev))
    assert torch.equal(got.cpu(), ref)
    plain = torch.where((layer == 0)[:, None].to(dev),
                        textures.sample_texture(cbg, u.to(dev), v.to(dev)),
                        textures.sample_stack(ctex, (layer - 1).to(dev),
                                              u.to(dev), v.to(dev)))
    assert torch.equal(got, plain)
    comp = textures.atlas_fetch_compact(atlas, layer.to(dev), u.to(dev),
                                        v.to(dev), want.to(dev), 1024)
    assert torch.equal(comp.cpu()[want], ref[want])
    assert (comp.cpu()[~want] == 0).all()


@pytest.mark.parametrize("noise", ["hash", "tile"])
def test_sparse_frame_on_card_matches_cpu(dev, noise):
    """The lane-sparse (hash noise) and tile-sparse (tile noise) frames on
    the card: within 1e-6 of the card's full frame, one march launch, and
    within the frame rule of the CPU's frame."""
    kw = (dict(noise_mode="hash") if noise == "hash"
          else dict(noise_mode="tile", noise_tile=(16, 128)))
    cfg = sp.RenderConfig(width=512, height=128, percent_black=0.75,
                          crosshair=True, **kw)

    def frame(device, **extra):
        return sp.render_fast(configs.demo_scene(device=device),
                              configs.demo_camera(device=device), cfg,
                              configs.background_texture(device=device),
                              configs.demo_texture_stack(device=device), 1.0,
                              **extra)

    before = kernel_scene.march_scene.launches
    img = frame(dev)
    torch.cuda.synchronize()
    assert kernel_scene.march_scene.launches == before + 1
    assert (img - frame(dev, compact_slots=None)).abs().max() <= 1e-6
    diff = (img.cpu() - frame("cpu")).abs().amax(-1)
    assert (diff < 2e-3).float().mean() >= 0.995


@pytest.mark.parametrize("march", ["march_bh", "march_scene"])
def test_compact_march_on_card_equals_cpu(dev, march):
    """compact=True on the card: one launch, every active ray's planes
    equal to the unpacked kernel's; against the CPU's compacted march,
    status (and hit count) agree on 99.9% of lanes and the agreeing
    lanes' planes within 1e-3 (the card's and the CPU's arithmetic differ
    by ulps)."""
    o, d, active = _rays(dev, 96, 64, drop=0.75)
    cfg = sp.RenderConfig(width=96, height=64, percent_black=-1.0)

    def run(device, compact):
        args = (o.to(device), d.to(device), active.to(device), 1.0)
        if march == "march_bh":
            return kernel.march_bh(*args, cfg, compact=compact)
        return kernel_scene.march_scene(
            *args, configs.demo_scene(device=device), cfg, 4,
            configs.demo_texture_stack(device=device), compact=compact)

    before = getattr(kernel if march == "march_bh" else kernel_scene,
                     march).launches
    got = torch.utils._pytree.tree_flatten(run(dev, True))[0]
    assert getattr(kernel if march == "march_bh" else kernel_scene,
                   march).launches == before + 1
    full = torch.utils._pytree.tree_flatten(run(dev, False))[0]
    cpu = torch.utils._pytree.tree_flatten(run("cpu", True))[0]
    for a, b in zip(got, full):
        assert torch.equal(a[active], b[active])
    # status, and for the scene march the hit count (its last plane)
    keys = [1] if march == "march_bh" else [2, -1]
    same = active.cpu()
    for k in keys:
        _agree(got[k].cpu(), cpu[k])
        same = same & (got[k].cpu() == cpu[k])
    for a, c in zip(got, cpu):
        assert torch.allclose(a.cpu()[same], c[same], rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The composition kernel (csrc/compose.cu) against its plain version,
# compose._compose_atlas_torch, both on the card: the same march records in,
# every lane's colour, open and captured equal, whichever tiles the plain
# version's schedule runs its later levels on.
# ---------------------------------------------------------------------------


def _halved_alphas(sc, tex):
    """Every material's and texel's alpha halved: rays cross several hits,
    so composition runs levels past 0."""
    m = sc.materials
    color = m.color.clone()
    color[:, 3] = 0.5
    data = tex.data.clone()
    data[..., 3] *= 0.5
    return sc._replace(materials=m._replace(color=color)), \
        tex._replace(data=data)


def _shapes_scene(dev):
    """Every primitive type: a plane (tiled texture window, no repeat), a
    disk, a hollow disk, a cylinder, a rectangle, a box and a sphere, some
    materials translucent, swapped or inverted uvs, one light."""
    checker = sp.Material(texture_index=0, swap_uvs=True)
    glass = sp.Material(color=(0.2, 0.6, 0.9, 0.5), specular=0.9)
    inv = sp.Material(texture_index=1, invert_uv_x=True, invert_uv_y=True,
                      double_sided_normals=False)
    flip = sp.Material(texture_index=0, flip_normals=True)
    objects = [
        sp.Plane(pos=(0.0, -3.0, 0.0), material=checker,
                 texture_offset=(0.1, 0.2), texture_size=(0.5, 0.5),
                 repeat_texture=False),
        sp.Disk(pos=(-4.0, 1.0, 2.0), radius=1.5, material=glass,
                axes=geo.IDENTITY_AXES),
        sp.HollowDisk(inner_radius=2.5, outer_radius=5.0, material=inv),
        sp.LateralCylinder(pos=(3.0, -2.0, 1.0), height=3.0, radius=0.7,
                           material=flip),
        sp.Rectangle(pos=(-2.0, -1.0, -4.0), width=3.0, height=2.0,
                     material=glass),
        sp.Box(pos=(1.5, 1.0, 3.0), width=1.0, depth=1.2, height=0.8,
               material=sp.Material(texture_index=1)),
        sp.Sphere(pos=(-5.0, 2.0, -3.0), radius=1.0, material=glass),
    ]
    return sp.build_scene(objects, [sp.Light(pos=(5.0, 8.0, 6.0))],
                          device=dev)


def _compose_case(dev, case):
    """(scene, stack, background, camera, cfg, test ray) of a named case."""
    from schwarzschild_tpu_torch import features

    bg = configs.background_texture(device=dev)
    cam = configs.demo_camera(device=dev)
    sc, tex = _scene_of("config3" if case == "config3" else "demo", dev)
    soft, test_ray = 0.0, None
    if case in ("translucent", "soft"):
        sc, tex = _halved_alphas(sc, tex)
        soft = 0.05 if case == "soft" else 0.0
    elif case == "tubes":
        test_ray = features.calculate_test_ray(cam_mod.look_at(
            cam, torch.tensor((2.5, 0.0, 0.0), device=dev)), device=dev)
    elif case == "shapes":
        sc = _shapes_scene(dev)
    elif case == "bf16":
        bg, tex = sp.with_dtype(bg), sp.stack_with_dtype(tex)
    cfg = sp.RenderConfig(width=256, height=64, percent_black=-1.0,
                          horizon_softness=soft)
    return sc, tex, bg, cam, cfg, test_ray


def _compose_both(dev, case, compact=True, size=None, n_slots=4):
    """compose_atlas on the card's march records through the kernel and
    through the plain version (with its tile schedule's pending counts and
    capacities); returns both results and the kernel's launches."""
    from schwarzschild_tpu_torch import compose, textures

    sc, tex, bg, cam, cfg, test_ray = _compose_case(dev, case)
    if size is not None:
        cfg = dataclasses.replace(cfg, width=size[0], height=size[1])
    px = kernel.pixel_masks(kernel.grid_planes(cam, cfg, dev), cfg)
    march = kernel_scene.march_scene(px["origin"], px["direction"],
                                     px["march_px"], 1.0, sc, cfg, n_slots,
                                     tex, test_ray=test_ray)
    r_s = torch.tensor(1.0, device=dev)
    inputs = kernel_scene._composition_inputs(px, *march[:4], r_s, cfg)
    atlas = textures.build_atlas(
        bg, tex, dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    args = (sc, tex, atlas, r_s)
    before = compose.compose_levels.launches
    got = compose.compose_atlas(*args, test_ray=test_ray, **inputs)
    torch.cuda.synchronize()
    launches = compose.compose_levels.launches - before
    ref = compose._compose_atlas_torch(*args, test_ray=test_ray,
                                       compact_tiles=compact,
                                       return_pend=True, **inputs)
    return got, ref, launches


def _assert_compose_equal(got, ref):
    for a, b in zip(got, ref[:3]):
        assert a.shape == b.shape and torch.equal(a, b)
    assert ref[1].dtype == torch.bool and (ref[0] != 0).any()


@pytest.mark.parametrize("case", ["config3", "demo", "translucent", "soft",
                                  "tubes", "shapes", "bf16"])
def test_compose_kernel_equals_plain_on_every_lane(dev, case):
    """Every case at 256 x 64: colour bit-equal, open and captured equal to
    the plain version's tile schedule, from one launch a frame.  "bf16"
    fetches from a bfloat16 atlas of bfloat16 textures."""
    got, ref, launches = _compose_both(dev, case)
    _assert_compose_equal(got, ref)
    assert launches == 1
    if case == "config3":
        # Every lane's contributions end at level 0.
        assert ref[3].tolist() == [0] * 5
    if case in ("translucent", "soft"):
        assert (ref[3] > 0).sum() >= 2  # levels past 0 ran


def test_compose_kernel_equals_every_plain_schedule(dev):
    """The translucent demo, whose plain version runs later levels on their
    pending tiles and on the whole frame (more pending tiles than the
    capacity), and without tiles (compact_tiles=False, and an untiled
    120 x 50 frame): the kernel's one launch equals each; 40 slots (more
    than 32 levels) too."""
    fired = set()
    for soft_case in ("translucent", "soft"):
        got, ref, _ = _compose_both(dev, soft_case)
        _assert_compose_equal(got, ref)
        fired |= {("tiles" if 0 < n <= c else "frame" if n > c else "none")
                  for n, c in zip(ref[3].tolist(), ref[4])}
        full, ref_full, launches = _compose_both(dev, soft_case,
                                                 compact=False)
        _assert_compose_equal(full, ref_full)
        assert launches == 1 and ref_full[4] == ()
        for a, b in zip(got, full):
            assert torch.equal(a, b)
    assert {"tiles", "frame"} <= fired, fired
    odd, ref_odd, _ = _compose_both(dev, "translucent", size=(120, 50))
    _assert_compose_equal(odd, ref_odd)
    deep, ref_deep, launches = _compose_both(dev, "translucent", n_slots=40)
    _assert_compose_equal(deep, ref_deep)
    assert launches == 1 and len(ref_deep[4]) == 41


def test_compose_kernel_bypassed_when_grad_is_asked(dev):
    """A frame whose r_s requires grad composes in torch (no launch) and
    gets its gradient; the same frame under no_grad launches the kernel
    and equals it."""
    from schwarzschild_tpu_torch import compose

    cfg = sp.RenderConfig(width=128, height=32, percent_black=-1.0)
    args = [configs.demo_scene(device=dev), configs.demo_camera(device=dev),
            cfg, configs.background_texture(device=dev),
            configs.demo_texture_stack(device=dev)]
    r_s = torch.tensor(1.0, device=dev, requires_grad=True)
    before = compose.compose_levels.launches
    img = sp.render_fast(*args, r_s, overflow="ignore")
    assert compose.compose_levels.launches == before
    (g,) = torch.autograd.grad(img.sum(), [r_s])
    assert torch.isfinite(g)
    with torch.no_grad():
        fast = sp.render_fast(*args, r_s, overflow="ignore")
    assert compose.compose_levels.launches == before + 1
    assert torch.equal(fast, img.detach())


def test_compose_kernel_never_reads_the_host(dev):
    """The kernel's composition never synchronizes with the host (torch's
    sync debug mode counts every synchronizing call; the plain version's
    schedule reads the host once after each level that runs), and a
    render_fast frame launches it once."""
    import warnings

    from schwarzschild_tpu_torch import compose, textures

    sc, tex, bg, cam, cfg, _ = _compose_case(dev, "config3")
    px = kernel.pixel_masks(kernel.grid_planes(cam, cfg, dev), cfg)
    march = kernel_scene.march_scene(px["origin"], px["direction"],
                                     px["march_px"], 1.0, sc, cfg, 4, tex)
    r_s = torch.tensor(1.0, device=dev)
    inputs = kernel_scene._composition_inputs(px, *march[:4], r_s, cfg)
    atlas = textures.build_atlas(bg, tex)
    compose.compose_atlas(sc, tex, atlas, r_s, **inputs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            compose.compose_atlas(sc, tex, atlas, r_s, **inputs)
            with pytest.raises(ValueError, match="return_pend"):
                compose.compose_atlas(sc, tex, atlas, r_s, return_pend=True,
                                      **inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sum("synchroniz" in str(w.message) for w in caught) == 0
    before = compose.compose_levels.launches
    sp.render_fast(sc, cam, cfg, bg, tex, 1.0, overflow="ignore")
    assert compose.compose_levels.launches == before + 1
