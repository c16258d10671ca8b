"""The composition's level schedule on the CPU, and the composition
kernel's word buffer: the per-tile masks of later pending levels that each
level of the plain version ends with decide the same levels on the same
tiles as ``pending()`` run level by level; running each lane through every
level that finds it pending (the kernel's order) gives the same frame; and
the tables ``compose_levels_kernel`` reads hold the scene's, materials' and
atlas's values at csrc/compose.cu's offsets.  Torch only: the port's own
demo scene, its alphas halved so that lanes cross several hits
(``test_torch_compose.py``'s ``translucent`` fixture, built here from the
port's configs)."""

import numpy as np
import pytest
import torch

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu_torch import compose, configs
from schwarzschild_tpu_torch import kernel as tkernel
from schwarzschild_tpu_torch import kernel_scene as tks
from schwarzschild_tpu_torch import textures as tx


@pytest.fixture(scope="module")
def translucent():
    sc = configs.demo_scene(device="cpu")
    tex = configs.demo_texture_stack(device="cpu")
    m = sc.materials
    color = m.color.clone()
    color[:, 3] = 0.5
    data = tex.data.clone()
    data[..., 3] *= 0.5
    return dict(scene=sc._replace(materials=m._replace(color=color)),
                tex=tex._replace(data=data),
                bg=configs.background_texture(device="cpu"),
                cam=configs.demo_camera(device="cpu"))


def _inputs(t, width, height, soft):
    cfg = sp.RenderConfig(width=width, height=height, percent_black=-1.0,
                          horizon_softness=0.05 if soft else 0.0)
    px = tkernel.pixel_masks(tkernel.grid_planes(t["cam"], cfg, "cpu"), cfg)
    march = tks.march_scene_torch(px["origin"], px["direction"],
                                  px["march_px"], 1.0, t["scene"], cfg, 4,
                                  tex=t["tex"])
    return tks._composition_inputs(px, *march[:4], torch.tensor(1.0), cfg)


def _by_pending(lv, tiles):
    """The levels run as before the masks: before each later level, its
    pending() lanes counted per tile (or over the frame), the level run on
    the whole frame where any is pending.  Returns the state and the
    counts."""
    P = lv.body(lv.P, 0)
    counts = []
    for k in range(1, lv.n_levels):
        pend = lv.pending(P, k)
        if tiles:
            nth, ntw = tiles
            pend = pend.reshape(nth, compose.TILE_H, ntw,
                                compose.TILE_W).any(3).any(1)
        counts.append(int(pend.sum()))
        if counts[-1]:
            P = lv.body(P, k)
    return P, counts


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_tile_masks_give_the_pending_counts_of_each_level(translucent, soft):
    """At 64 x 128 (8 tiles, capacity 4 a level): the schedule's pending
    tile counts equal pending()'s, level by level, and its frame equals
    the level-by-level frame bit for bit."""
    t = translucent
    inputs = _inputs(t, 128, 64, soft)
    args = (t["scene"], t["tex"], tx.build_atlas(t["bg"], t["tex"]),
            torch.tensor(1.0))
    got = compose.compose_atlas(*args, return_pend=True, **inputs)
    tiles = compose._tiling((64, 128), True)
    assert tiles == (8, 1)
    lv = compose._TorchLevels(*args, tiles=tiles, **inputs)
    P, counts = _by_pending(lv, tiles)
    assert got[3].tolist() == counts
    assert sum(1 for n in counts if n) >= 2  # levels past 0 ran
    assert got[4] == (4,) * 5
    for a, key in zip(got[:3], ("color", "open", "captured")):
        assert torch.equal(a, P[key])


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_masks_of_an_untiled_frame_run_the_pending_levels(translucent, soft,
                                                          monkeypatch):
    """A frame of 24 x 40 lanes (no whole tile): the frame's mask runs
    exactly the levels in which pending() finds a lane, with one read of
    the host after each, and the frame equals the level-by-level frame."""
    t = translucent
    inputs = _inputs(t, 40, 24, soft)
    args = (t["scene"], t["tex"], tx.build_atlas(t["bg"], t["tex"]),
            torch.tensor(1.0))
    ran, reads = [], []
    run, read = compose._TorchLevels.run, compose._TorchLevels.read
    monkeypatch.setattr(compose._TorchLevels, "run",
                        lambda self, k, ids: ran.append(k) or run(self, k,
                                                                  ids))
    monkeypatch.setattr(compose._TorchLevels, "read",
                        lambda self: reads.append(1) or read(self))
    got = compose.compose_atlas(*args, return_pend=True, **inputs)
    assert got[3].tolist() == [] and got[4] == ()
    lv = compose._TorchLevels(*args, **inputs)
    P, counts = _by_pending(lv, None)
    assert ran == [0] + [k + 1 for k, n in enumerate(counts) if n]
    assert len(reads) == len(ran) and len(ran) >= 2
    for a, key in zip(got[:3], ("color", "open", "captured")):
        assert torch.equal(a, P[key])


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_levels_lane_by_lane_equal_the_schedule(translucent, soft):
    """compose_levels_kernel's order: each lane through level 0, then
    through each later level that finds it pending (a level's lanes that
    are not pending keep their planes), equals the tiled schedule's frame
    bit for bit at 128 x 64, where later levels run on tiles and on the
    whole frame."""
    t = translucent
    inputs = _inputs(t, 128, 64, soft)
    args = (t["scene"], t["tex"], tx.build_atlas(t["bg"], t["tex"]),
            torch.tensor(1.0))
    got = compose.compose_atlas(*args, return_pend=True, **inputs)
    assert sum(1 for n in got[3].tolist() if n) >= 2
    lv = compose._TorchLevels(*args, **inputs)
    P = lv.body(lv.P, 0)
    for k in range(1, lv.n_levels):
        pend = lv.pending(P, k)
        new = lv.body(P, k)
        P = {key: torch.where(pend.reshape(pend.shape + (1,) * (
            v.dim() - pend.dim())), new[key], v) if key in new else v
            for key, v in P.items()}
    for a, key in zip(got[:3], ("color", "open", "captured")):
        assert torch.equal(a, P[key])


def test_masks_after_a_level_on_tiles(translucent):
    """After a level run on a subset of tiles, every tile's mask bit for a
    later level is whether pending() finds a lane of the tile there."""
    t = translucent
    inputs = _inputs(t, 256, 64, False)
    args = (t["scene"], t["tex"], tx.build_atlas(t["bg"], t["tex"]),
            torch.tensor(1.0))
    tiles = compose._tiling((64, 256), True)
    lv = compose._TorchLevels(*args, tiles=tiles, **inputs)
    lv.run(0, None)
    m = lv.read()
    pend = np.flatnonzero(m[1])
    assert 0 < len(pend)
    ids = np.full(len(pend) + 2, 16, np.int64)  # two fill rows
    ids[:len(pend)] = pend
    lv.run(1, ids)
    m = lv.read()
    for k in range(2, lv.n_levels):
        want = lv.pending(lv.P, k).reshape(8, 8, 2, 128).any(3).any(1)
        assert np.array_equal(m[k], want.reshape(-1).numpy()), k


def _demo_tables(bf16=False):
    sc = configs.demo_scene(device="cpu")
    tex = configs.demo_texture_stack(device="cpu")
    bg = configs.background_texture(device="cpu")
    atlas = tx.build_atlas(bg, tex, dtype=torch.bfloat16 if bf16
                           else torch.float32)
    words, offs = compose._pack_tables(sc, tex, atlas)
    return sc, tex, atlas, words.numpy(), offs


def test_kernel_tables_hold_the_scene_at_the_kernels_offsets():
    """compose_levels_kernel's word buffer (csrc/compose.cu's Tables): each
    table at its offset with its row count, its fields at the kernel's
    words, integers as int32 bit patterns, flags as 0 or 1."""
    sc, tex, atlas, w, o = _demo_tables()
    names = ["spheres", "planes", "disks", "hollow", "cylinders", "rects",
             "boxes"]
    counts = [sc.spheres.radius, sc.planes.mat_idx, sc.disks.mat_idx,
              sc.hollow_disks.mat_idx, sc.cylinders.mat_idx,
              sc.rectangles.mat_idx, sc.boxes.mat_idx]
    for i, (name, x) in enumerate(zip(names, counts)):
        assert o[2 * i + 1] == x.shape[0], name
    assert len(o) == 24 and w.dtype == np.float32

    def row(at, width, i):
        return w[at + width * i: at + width * (i + 1)]

    s = row(o[0], 14, 0)
    assert np.array_equal(s[:3], sc.spheres.pos[0].numpy())
    assert np.array_equal(s[3:12], sc.spheres.axes[0].numpy().reshape(-1))
    assert s[12] == sc.spheres.radius[0].item()
    assert s[13:].view(np.int32)[0] == sc.spheres.mat_idx[0].item()
    h = row(o[6], 15, 0)
    hd = sc.hollow_disks
    assert (h[12], h[13]) == (hd.inner_radius[0].item(),
                              hd.outer_radius[0].item())
    c = row(o[8], 15, 0)
    assert (c[12], c[13]) == (sc.cylinders.height[0].item(),
                              sc.cylinders.radius[0].item())
    b = row(o[12], 85, 0)
    bx = sc.boxes
    for f in range(6):
        assert np.array_equal(b[3 * f:3 * f + 3], bx.face_pos[0, f].numpy())
        assert np.array_equal(b[18 + 9 * f:27 + 9 * f],
                              bx.face_axes[0, f].numpy().reshape(-1))
        assert (b[72 + f], b[78 + f]) == (bx.face_width[0, f].item(),
                                          bx.face_height[0, f].item())
    assert np.array_equal(w[o[14]:o[14] + 12],
                          bx.atlas_offset.numpy().reshape(-1))
    m = sc.materials
    assert o[16] == m.color.shape[0]
    for i in range(o[16]):
        r = row(o[15], 15, i)
        assert np.array_equal(r[:4], m.color[i].numpy())
        assert r[8:10].view(np.int32).tolist() == [
            m.texture_index[i].item(), m.normal_map_index[i].item()]
        assert r[10:].tolist() == [float(x[i]) for x in (
            m.invert_uv_x, m.invert_uv_y, m.swap_uvs,
            m.double_sided_normals, m.flip_normals)]
    lt = row(o[17], 10, 0)
    assert np.array_equal(lt[:3], sc.lights.pos[0].numpy())
    assert lt[9] == sc.lights.attenuation_quadratic[0].item()
    assert np.array_equal(w[o[19]:o[19] + 2 * o[20]],
                          tex.sizes.numpy().reshape(-1))
    assert np.array_equal(w[o[21]:o[21] + 2], tex.max_size.numpy())
    lay = w[o[22]:o[22] + 4 * o[23]].reshape(-1, 4)
    assert np.array_equal(lay[:, :2], atlas.wrap.numpy())
    assert np.array_equal(lay[:, 2].view(np.int32), atlas.base.numpy())
    assert np.array_equal(lay[:, 3].view(np.int32), atlas.gpr.numpy())
    assert o[22] + 4 * o[23] == w.size


def test_kernel_tables_are_packed_once_per_scene():
    """The tables are kept for their sources: a second frame of the same
    scene reuses them; an in-place write to a source packs them anew."""
    sc, tex, atlas, _, _ = _demo_tables()
    first = compose._tables(sc, tex, atlas)
    assert compose._tables(sc, tex, atlas) is first
    sc.spheres.radius.mul_(1.0)  # bumps its version
    again = compose._tables(sc, tex, atlas)
    assert again is not first
    assert torch.equal(again[0].view(torch.int32),  # int words hold NaNs
                       first[0].view(torch.int32)) and again[1] == first[1]


def test_tube_rows_follow_the_test_ray():
    """The test ray's tube rows: the straight tube first (1000 long, active),
    then the chain's segments with intersect.tube_segments' frames,
    lengths and activity."""
    from schwarzschild_tpu_torch import features
    from schwarzschild_tpu_torch.intersect import tube_segments

    tr = features.calculate_test_ray(configs.demo_camera(device="cpu"),
                                     device="cpu")
    rows = compose._tube_rows(tr, 1.0, torch.device("cpu"))
    p0, frames, seg_len, active = tube_segments(tr, torch.tensor(1.0))
    assert rows.shape == (1 + p0.shape[0], 15)
    assert rows[0, 12:].tolist() == [1000.0, np.float32(0.025), 1.0]
    assert torch.equal(rows[1:, :3], p0)
    assert torch.equal(rows[1:, 3:12], frames.reshape(-1, 9))
    assert torch.equal(rows[1:, 12], seg_len)
    assert torch.equal(rows[1:, 14] > 0.5, active)


def test_cpu_frames_never_build_kernel_levels(translucent, monkeypatch):
    """CPU tensors compose with the plain version: the kernel's wrapper is
    never called."""
    def refuse(*a, **k):
        raise AssertionError("compose_levels called for a CPU frame")

    monkeypatch.setattr(compose, "compose_levels", refuse)
    t = translucent
    cfg = sp.RenderConfig(width=128, height=32, percent_black=-1.0)
    img = sp.render_fast(t["scene"], t["cam"], cfg, t["bg"], t["tex"],
                         overflow="ignore")
    assert img.shape == (32, 128, 4)
