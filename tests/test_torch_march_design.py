"""The scene kernel's cull and the adjoint's checkpoint layout, on the CPU.

The scene kernel (csrc/march.cu) skips a table row's exact test where the
segment does not reach the row's bounding sphere, its group's or the
scene's.  That is exact only if the cull is conservative: wherever the
exact test finds a hit, the cull lets the row through.  These tests hold
``segment_cull_torch`` (the kernel's predicate on tensors) to that on random
grazing and edge hits of every bounded primitive and on every segment of
small marches, and walk the kernel's table buffer the way the kernel does.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu_torch import camera as cam_mod
from schwarzschild_tpu_torch import configs
from schwarzschild_tpu_torch import geometry as geo
from schwarzschild_tpu_torch import kernel_scene as ks
from schwarzschild_tpu_torch import physics

REL, ABS = ks.CULL_REL, ks.CULL_ABS


def _margin(c, r):
    return r + REL * (r + float(np.linalg.norm(c))) + ABS


def _assert_bound(got, centre, radius):
    np.testing.assert_allclose(got[:3], centre, rtol=0, atol=1e-5)
    # Rounded up to f32, never down.
    assert _margin(centre, radius) <= got[3] <= _margin(centre, radius) + 1e-5


def test_row_bounds_by_hand():
    eye = np.eye(3, dtype=np.float32)
    rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)  # 90 deg
    tables = {
        "spheres": np.array([[1, 2, 3, 0.5, 0]], np.float32),
        "disks": np.array([[0, 0, -10, 0, 1, 0, 4.0, 1]], np.float32),
        "hollow": np.array([[0, 0, 0, 0, 1, 0, 6.25, 25.0, 0]], np.float32),
        "cylinders": np.concatenate(
            [[[0, 10, 0]], rot.T.reshape(1, 9), [[5.0, 2.0, 0]]],
            1).astype(np.float32),
        "rects": np.concatenate(
            [[[0, 0, 10]], eye.T.reshape(1, 9), [[3.0, 2.0, 1]]],
            1).astype(np.float32),
    }
    b = ks._row_bounds(tables)
    _assert_bound(b["rows"]["spheres"][0], [1, 2, 3], 0.5)
    _assert_bound(b["rows"]["disks"][0], [0, 0, -10], 2.0)
    _assert_bound(b["rows"]["hollow"][0], [0, 0, 0], 5.0)
    # Axis y is the second column of the axes matrix, here (-1, 0, 0).
    _assert_bound(b["rows"]["cylinders"][0], [-2.5, 10, 0], math.hypot(2.5, 2))
    _assert_bound(b["rows"]["rects"][0], [1.5, 0, 11], math.hypot(1.5, 1))
    assert [g[:3] for g in b["groups"]] == [
        ("spheres", 0, 1), ("disks", 0, 1), ("hollow", 0, 1),
        ("cylinders", 0, 1), ("rects", 0, 1)]
    # The scene's bound holds every row's.
    sc = np.array(b["scene"])
    for rows in b["rows"].values():
        for r in rows:
            assert np.linalg.norm(np.array(r[:3]) - sc[:3]) + r[3] <= sc[3]


def test_box_faces_group_and_degenerate_rows():
    sc = configs.demo_scene(device="cpu")
    tables = ks._pack_scene_smem(sc)
    b = ks._row_bounds(tables, 6 * sc.boxes.mat_idx.shape[0])
    name, first, count, bound = b["groups"][-1]
    assert (name, first, count) == ("rects", 1, 6)
    # The demo box: the unit cube at (10, 0, 0); its circumscribed sphere.
    _assert_bound(bound, [10.5, 0.5, 0.5], math.sqrt(3) / 2)
    for j in range(1, 7):  # every face's own bound lies inside
        c, r = np.array(b["rows"]["rects"][j][:3]), b["rows"]["rects"][j][3]
        assert np.linalg.norm(c - np.array(bound[:3])) <= bound[3] + r
    # A singular axes matrix or a non-finite column is never culled.
    bad = tables["rects"][:2].copy()
    bad[0, 3:12] = 0.0
    bad[1, 12] = np.inf
    nb = ks._row_bounds({"rects": bad})
    assert all(r[3] == math.inf for r in nb["rows"]["rects"])
    assert nb["scene"][3] == math.inf


# ---------------------------------------------------------------------------
# Random grazing and edge hits of every bounded primitive.
# ---------------------------------------------------------------------------

def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _random_row(rng, name):
    """One table row of ``name`` (random pose and size) and a function that
    maps (N,) uniform draws to N points on its boundary, in float64."""
    q = _unit(rng.normal(size=4))
    w, x, y, z = q
    axes = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    c0, c1, c2 = axes[:, 0], axes[:, 1], axes[:, 2]
    t = rng.uniform(-1, 1, 3) * 10 ** rng.uniform(-1, 1.5)
    size = lambda: 10 ** rng.uniform(-2, 1)  # noqa: E731

    def ring(u, r):  # points on a circle of radius r in the (c0, c2) plane
        a = 2 * np.pi * u
        r = np.broadcast_to(r, u.shape)[:, None]
        return np.cos(a)[:, None] * c0 * r + np.sin(a)[:, None] * c2 * r

    if name == "spheres":
        r = size()
        row = [*t, r, 0.0]
        return row, lambda u, v: t + r * _unit(np.stack(
            [np.cos(2 * np.pi * u) * np.sqrt(1 - (2 * v - 1) ** 2),
             np.sin(2 * np.pi * u) * np.sqrt(1 - (2 * v - 1) ** 2),
             2 * v - 1], -1))
    if name == "disks":
        r = size()
        row = [*t, *c1, r * r, 0.0]
        return row, lambda u, v: t + ring(u, r * np.where(v < 0.5, 1.0, v))
    if name == "hollow":
        ri = size()
        ro = ri * (1 + 10 ** rng.uniform(-3, 1))
        row = [*t, *c1, ri * ri, ro * ro, 0.0]
        return row, lambda u, v: t + ring(u, np.where(v < 0.5, ri, ro))
    if name == "cylinders":
        h, r = size(), size()
        row = [*t, *c0, *c1, *c2, h, r, 0.0]
        ends = np.array([0.0, h])
        return row, lambda u, v: (t + ring(u, r) + np.where(
            v < 0.6, ends[(v * 10).astype(int) % 2], v * h)[:, None] * c1)
    w, h = size(), size()
    row = [*t, *c0, *c1, *c2, w, h, 0.0]

    def edge(u, v):  # corners, edges and the inside of the rectangle
        a = np.where(u < 0.3, 0.0, np.where(u < 0.6, w, u * w))
        b = np.where(v < 0.3, 0.0, np.where(v < 0.6, h, v * h))
        return t + a[:, None] * c0 + b[:, None] * c2
    return row, edge


def _segments(rng, points, normal, centre, n):
    """Segments through ``points`` as float32 tensors: grazing (almost
    tangent to the surface, ``normal`` its normals), head-on (towards the
    bounding sphere's ``centre``: a segment that ends on the boundary then
    just reaches the bound, so a cull without its margins fails them), and
    random; each starting, ending or passing through its point."""
    d = _unit(rng.normal(size=(n, 3)))
    tang = _unit(d - np.sum(d * normal, -1, keepdims=True) * normal)
    tilt = 10 ** rng.uniform(-7, 0, (n, 1))
    head_on = _unit(centre - points)
    head_on = _unit(head_on + 10 ** rng.uniform(-4, -1, (n, 1)) * normal)
    kind = rng.random(n)[:, None]
    d = np.where(kind < 0.4, _unit(tang + tilt * normal),
                 np.where(kind < 0.7, head_on, d))
    length = 10 ** rng.uniform(-2, 2, n)
    frac = rng.choice([0.0, 1.0, 1.0, 0.5, -1], n)
    frac = np.where(frac < 0, rng.random(n), frac)
    p = points - (frac * length)[:, None] * d
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    seg_len = f(length) * (1 + f(rng.uniform(-1e-6, 1e-6, n)))
    return (*f(p).unbind(-1), *f(d).unbind(-1), seg_len)


def _normal_fn(name, row):
    row = np.asarray(row)
    if name == "spheres":
        return lambda q: _unit(q - row[:3])
    if name in ("disks", "hollow"):
        return lambda q: np.broadcast_to(row[3:6], q.shape)
    if name == "rects":
        return lambda q: np.broadcast_to(row[6:9], q.shape)
    axis = row[6:9]  # the cylinder: radial from its axis
    return lambda q: _unit((q - row[:3]) - np.sum(
        (q - row[:3]) * axis, -1, keepdims=True) * axis)


def _assert_conservative(tables, bounds, seg, live=None):
    """Every finite exact hit of a bounded row passes the cull."""
    cull = ks.segment_cull_torch(tables, bounds, *seg)["rows"]
    hits = 0
    for name, j, cand, _ in ks._row_candidates(tables, *seg):
        if name == "planes":
            continue
        hit = torch.isfinite(cand)
        if live is not None:
            hit &= live
        missed = hit & ~cull[name][j]
        assert not bool(missed.any()), (name, j, int(missed.sum()))
        hits += int(hit.sum())
    return hits


def _along_axis(rng, row, n):
    """Segments of a cylinder ``row`` along its axis, as float32 tensors:
    exactly parallel (an axis-aligned pose makes the exact test's dps 0 and
    its lambda 100 at any distance from the axis: the starts lie 100 below
    a point of the cylinder's height, the lengths reach past 100) or nudged
    off the axis by 1e-13 to 1e-3, from anywhere within 100 of it."""
    t = np.asarray(row, np.float64)
    c0, c1, c2, h = t[3:6], t[6:9], t[9:12], t[12]
    nudge = np.where(rng.random(n) < 0.5, 0.0, 10 ** rng.uniform(-13, -3, n))
    d = np.sign(rng.random(n) - 0.3)[:, None] * c1 + nudge[:, None] * c0
    a = 2 * np.pi * rng.random(n)
    rho = 10 ** rng.uniform(-2, 2, n)
    y0 = np.where(d @ c1 > 0, -100.0, 100.0 + h) + rng.random(n) * h
    p = (t[:3] + (rho * np.cos(a))[:, None] * c0
         + (rho * np.sin(a))[:, None] * c2 + y0[:, None] * c1)
    length = 10 ** rng.uniform(0, 2.5, n)
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return (*f(p).unbind(-1), *f(d).unbind(-1), f(length))


def _aligned(row, rng):
    """``row`` of a cylinder with its axes turned onto the world's axes (a
    signed permutation), so that a segment along its axis is exact in f32."""
    axes = np.eye(3)[rng.permutation(3)] * rng.choice([-1.0, 1.0], (3, 1))
    return [*row[:3], *axes.reshape(-1), *row[12:]]


@settings(max_examples=40, deadline=None, derandomize=True)
@given(name=hst.sampled_from(["spheres", "disks", "hollow", "cylinders",
                              "rects"]),
       seed=hst.integers(0, 2 ** 32 - 1))
def test_cull_passes_every_exact_hit(name, seed):
    rng = np.random.default_rng(seed)
    row, boundary = _random_row(rng, name)
    tables = {name: np.asarray([row], np.float32)}
    n = 512
    points = boundary(rng.random(n), rng.random(n))
    bounds = ks._row_bounds(tables)
    seg = _segments(rng, points, _normal_fn(name, tables[name][0])(points),
                    np.array(bounds["rows"][name][0][:3]), n)
    hits = _assert_conservative(tables, bounds, seg)
    assert hits > 0  # the draws do hit
    if name == "cylinders":  # segments along the axis, of both poses
        for along in (tables, {name: np.asarray([_aligned(row, rng)],
                                                np.float32)}):
            _assert_conservative(along, ks._row_bounds(along),
                                 _along_axis(rng, along[name][0], n))


def test_cull_passes_axis_parallel_cylinder_hits():
    """A segment along a cylinder's axis meets its exact test's guard: it
    "hits" at lambda = 100 (dps = 0) or near 0 (dps ~ 4e-24) however far
    from the axis it runs.  The cull lets it through, so the kernel folds
    the same hits as the unculled plain version."""
    eye = np.eye(3, dtype=np.float32)
    row = np.concatenate([[0, 0, 0], eye.T.reshape(9), [2.0, 1.0, 0]])
    tables = {"cylinders": row[None].astype(np.float32)}
    bounds = ks._row_bounds(tables)
    # (start, direction, length): 200 units off the axis, exactly parallel,
    # 100 below the base; and 50 off, its direction 2e-12 off the axis.
    f = lambda *x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    seg = (f(200.0, 50.0), f(-99.0, 1.0), f(0.0, 0.0), f(0.0, 2e-12),
           f(1.0, 1.0), f(0.0, 0.0), f(150.0, 10.0))
    (_, _, cand, _), = ks._row_candidates(tables, *seg)
    assert torch.isfinite(cand).all()  # off the cylinder by 199 and 49
    assert float(cand[0]) == 100.0
    cull = ks.segment_cull_torch(tables, bounds, *seg)
    assert not cull["scene"].any()  # no bound holds them
    assert cull["parallel"][0].all() and cull["rows"]["cylinders"][0].all()
    buf, *layout = ks._kernel_tables(tables, bounds)
    got = _walk_kernel_tables(buf, *layout, seg)
    for a, b in zip(got, ks._segment_min_dist(tables, *seg)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Every segment of small marches, and the kernel's walk of its buffer.
# ---------------------------------------------------------------------------

def _walk_kernel_tables(buf, n_groups, n_cylinders, planes_at, n_planes,
                        seg):
    """segment_min_dist of csrc/march.cu read off its table buffer: the
    scene, group and row tests (and a cylinder's axis_parallel test), then
    each passing row's exact test."""
    ints = buf.view(np.int32)
    names = dict(enumerate(ks._BOUNDED))
    cols = dict(ks.TABLE_COLUMNS)
    px, py, pz, sdx, sdy, sdz, seg_len = seg
    hl = seg_len * ks.CULL_HALF
    m = (px + hl * sdx, py + hl * sdy, pz + hl * sdz)
    best = torch.full_like(px, math.inf)
    best_opq = best

    def fold(name, row, ok):
        nonlocal best, best_opq
        (_, _, cand, opq), = ks._row_candidates(
            {name: row[None]}, *seg)
        cand = torch.where(ok, cand, math.inf)
        best = torch.minimum(best, cand)
        if opq > 0.5:
            best_opq = torch.minimum(best_opq, cand)

    in_scene = ks._reaches(buf[0:4].tolist(), *m, hl)
    for gi in range(n_groups):
        g = 4 + 8 * gi
        name = names[int(ints[g + 4])]
        assert (name == "cylinders") == (gi < n_cylinders)  # theirs first
        first, rows, stride = (int(x) for x in ints[g + 5:g + 8])
        in_group = in_scene & ks._reaches(buf[g:g + 4].tolist(), *m, hl)
        if name == "cylinders":
            row = buf[first + 4:first + 4 + cols[name]]
            fold(name, row, in_group | ks._parallel(row, *seg[3:6]))
            continue
        for j in range(rows):
            at = first + j * stride
            ok = in_group
            if rows > 1:
                ok = ok & ks._reaches(buf[at:at + 4].tolist(), *m, hl)
            fold(name, buf[at + 4:at + 4 + cols[name]], ok)
    for j in range(n_planes):
        at = planes_at + 7 * j
        fold("planes", buf[at:at + 7], torch.ones_like(px, dtype=torch.bool))
    return best, best_opq


def _march_and_check(sc, tex, W, H):
    cam = configs.demo_camera(device="cpu")
    u, v = cam_mod.pixel_grid(W, H, device="cpu")
    o, d = cam_mod.generate_rays(cam, u, v, W, H)
    active = ~physics.is_radial(d, geo.safe_normalize(o))
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    tables = ks._pack_scene_smem(sc, tex)
    bounds = ks._row_bounds(tables, 6 * sc.boxes.mat_idx.shape[0])
    layout = ks._kernel_tables(tables, bounds)
    seen = dict(segments=0, hits=0)

    def on_segment(live, *seg):
        seen["hits"] += _assert_conservative(tables, bounds, seg, live)
        seen["segments"] += int(live.sum())
        want = ks._segment_min_dist(tables, *seg)
        got = _walk_kernel_tables(*layout, seg)
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    ks._march_scene_planes_torch(o, d, active, 1.0, sc, cfg, 4, tex,
                                 on_segment=on_segment)
    assert seen["segments"] > 0 and seen["hits"] > 0


@pytest.mark.parametrize("scene", ["demo_opaque", "demo_record_all",
                                   "config3"])
def test_cull_on_every_march_segment(scene):
    if scene == "config3":
        sc, tex = configs._orbiting_planets_scene(device="cpu"), None
    else:
        sc = configs.demo_scene(device="cpu")
        tex = (configs.demo_texture_stack(device="cpu")
               if scene == "demo_opaque" else None)
    _march_and_check(sc, tex, 40, 24)


def test_kernel_table_buffer_layout():
    sc = configs.demo_scene(device="cpu")
    tables = ks._pack_scene_smem(sc)
    bounds = ks._row_bounds(tables, 6)
    buf, n_groups, n_cylinders, planes_at, n_planes = ks._kernel_tables(
        tables, bounds)
    ints = buf.view(np.int32)
    assert (n_groups, n_cylinders, n_planes) == (6, 1, 0)
    assert planes_at == buf.size == 4 + 8 * 6 + 11 * 4 + sum(
        t.size for t in tables.values())
    assert ints[4 + 4] == ks._BOUNDED.index("cylinders")  # the first group
    # The box group: six rect rows of 4 + 15 words, its faces' own bounds
    # first in each.
    g = 4 + 8 * 5
    assert tuple(ints[g + 4:g + 8]) == (4, ints[g + 5], 6, 19)
    at = int(ints[g + 5])
    np.testing.assert_array_equal(buf[at:at + 4],
                                  np.float32(bounds["rows"]["rects"][1]))
    np.testing.assert_array_equal(buf[at + 4:at + 19], tables["rects"][1])
    assert buf.size <= ks.SHARED_TABLE_WORDS  # the kernel's shared copy
    # The wrapper's copy is cached on the tables' bytes: equal tables of
    # another scene object get the same buffer, changed ones a new one.
    again = ks._kernel_buffer(ks._pack_scene_smem(
        configs.demo_scene(device="cpu")), 6)
    assert again[0] is ks._kernel_buffer(tables, 6)[0]
    np.testing.assert_array_equal(again[0], buf)
    moved = {**tables, "spheres": tables["spheres"] + np.float32(1.0)}
    assert ks._kernel_buffer(moved, 6)[0] is not again[0]


@pytest.mark.parametrize("steps,saves", [(100, 13), (37, 5), (8, 1)])
def test_bwd_scratch_bytes_is_the_checkpoint_layout(steps, saves):
    cfg = sp.RenderConfig(width=1280, height=720, max_steps=steps)
    n = 1280 * 720
    assert ks.BWD_CHECKPOINT_EVERY == 8
    assert ks.bwd_scratch_bytes(cfg, n) == saves * 15 * n * 4
    if steps == 100:  # at most a quarter of a save at every step
        assert ks.bwd_scratch_bytes(cfg, n) <= steps * 15 * n * 4 / 4
