"""ctypes binding of the native C++ float64 oracle (``native/oracle.cpp``)
for this package's scenes (counterpart of
``schwarzschild_tpu.oracle.native``).

``native/oracle.cpp`` transcribes the reference's fragment shader in
float64 with its real control flow, independently of either renderer,
with the semantics of the pure-Python oracle (``reference.py``) and some
100x its speed.  :func:`render_image` renders a frame with it.  The
library is built with g++ at first use into ``_build/`` of this package
(plain C ABI, ctypes); ctypes releases the GIL during the call, so row
slabs render on a thread pool.

:func:`classify` and :func:`probe` are the parity method of the JAX
package's benchmarks/parity_r05.py: a frame's disagreements with the
oracle, by their distance to the oracle image's discontinuities, and the
marginality probe of the pixels off by more than a display count.
"""

from __future__ import annotations

import ctypes as ct
import functools
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from .._ext import BUILD_DIR
from .reference import CURVED, OracleScene  # noqa: F401  (public here too)

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "oracle.cpp"


def _f64(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class _CScene(ct.Structure):
    _fields_ = [
        ("n_materials", ct.c_int32),
        ("mat_color", ct.POINTER(ct.c_double)),
        ("mat_ambient", ct.POINTER(ct.c_double)),
        ("mat_diffuse", ct.POINTER(ct.c_double)),
        ("mat_specular", ct.POINTER(ct.c_double)),
        ("mat_shininess", ct.POINTER(ct.c_double)),
        ("mat_texture_index", ct.POINTER(ct.c_int32)),
        ("mat_normal_map_index", ct.POINTER(ct.c_int32)),
        ("mat_invert_uv_x", ct.POINTER(ct.c_uint8)),
        ("mat_invert_uv_y", ct.POINTER(ct.c_uint8)),
        ("mat_swap_uvs", ct.POINTER(ct.c_uint8)),
        ("mat_double_sided", ct.POINTER(ct.c_uint8)),
        ("mat_flip_normals", ct.POINTER(ct.c_uint8)),
        ("n_lights", ct.c_int32),
        ("light_pos", ct.POINTER(ct.c_double)),
        ("light_color", ct.POINTER(ct.c_double)),
        ("light_intensity", ct.POINTER(ct.c_double)),
        ("light_att_const", ct.POINTER(ct.c_double)),
        ("light_att_lin", ct.POINTER(ct.c_double)),
        ("light_att_quad", ct.POINTER(ct.c_double)),
        ("n_spheres", ct.c_int32),
        ("sph_pos", ct.POINTER(ct.c_double)),
        ("sph_axes", ct.POINTER(ct.c_double)),
        ("sph_radius", ct.POINTER(ct.c_double)),
        ("sph_mat", ct.POINTER(ct.c_int32)),
        ("n_planes", ct.c_int32),
        ("pln_pos", ct.POINTER(ct.c_double)),
        ("pln_axes", ct.POINTER(ct.c_double)),
        ("pln_tex_offset", ct.POINTER(ct.c_double)),
        ("pln_tex_size", ct.POINTER(ct.c_double)),
        ("pln_repeat", ct.POINTER(ct.c_uint8)),
        ("pln_mat", ct.POINTER(ct.c_int32)),
        ("n_disks", ct.c_int32),
        ("dsk_pos", ct.POINTER(ct.c_double)),
        ("dsk_axes", ct.POINTER(ct.c_double)),
        ("dsk_radius", ct.POINTER(ct.c_double)),
        ("dsk_mat", ct.POINTER(ct.c_int32)),
        ("n_hollow", ct.c_int32),
        ("hd_pos", ct.POINTER(ct.c_double)),
        ("hd_axes", ct.POINTER(ct.c_double)),
        ("hd_inner", ct.POINTER(ct.c_double)),
        ("hd_outer", ct.POINTER(ct.c_double)),
        ("hd_mat", ct.POINTER(ct.c_int32)),
        ("n_cylinders", ct.c_int32),
        ("cyl_pos", ct.POINTER(ct.c_double)),
        ("cyl_axes", ct.POINTER(ct.c_double)),
        ("cyl_height", ct.POINTER(ct.c_double)),
        ("cyl_radius", ct.POINTER(ct.c_double)),
        ("cyl_mat", ct.POINTER(ct.c_int32)),
        ("n_rectangles", ct.c_int32),
        ("rct_pos", ct.POINTER(ct.c_double)),
        ("rct_axes", ct.POINTER(ct.c_double)),
        ("rct_width", ct.POINTER(ct.c_double)),
        ("rct_height", ct.POINTER(ct.c_double)),
        ("rct_mat", ct.POINTER(ct.c_int32)),
        ("n_boxes", ct.c_int32),
        ("box_face_pos", ct.POINTER(ct.c_double)),
        ("box_face_axes", ct.POINTER(ct.c_double)),
        ("box_face_width", ct.POINTER(ct.c_double)),
        ("box_face_height", ct.POINTER(ct.c_double)),
        ("box_mat", ct.POINTER(ct.c_int32)),
        ("n_tex", ct.c_int32),
        ("tex_h", ct.c_int32),
        ("tex_w", ct.c_int32),
        ("tex_data", ct.POINTER(ct.c_double)),
        ("tex_sizes", ct.POINTER(ct.c_double)),
        ("tex_max_w", ct.c_double),
        ("tex_max_h", ct.c_double),
        ("bg_h", ct.c_int32),
        ("bg_w", ct.c_int32),
        ("bg_data", ct.POINTER(ct.c_double)),
        ("r_s", ct.c_double),
    ]


class _RenderParams(ct.Structure):
    _fields_ = [
        ("width", ct.c_int32),
        ("height", ct.c_int32),
        ("max_steps", ct.c_int32),
        ("max_revolutions", ct.c_int32),
        ("u_f", ct.c_double),
        ("percent_black", ct.c_double),
        ("raytrace_type", ct.c_int32),
        ("curved_percentage", ct.c_double),
        ("crosshair", ct.c_int32),
        ("noise_mode", ct.c_int32),
        ("noise_seed", ct.c_uint32),
    ]


_GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def _build() -> Path:
    """g++ the oracle into _build/ unless this exact build (a digest of
    the source and flags) is there.  No -march=native, so a build copied
    to another machine still runs.  Written under a temporary name and
    renamed: a concurrent build never loads half a file."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    lib = BUILD_DIR / f"liboracle_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _get_lib():
    lib = ct.CDLL(str(_build()))
    lib.oracle_render_rows.restype = None
    lib.oracle_render_rows.argtypes = [
        ct.POINTER(_CScene), ct.POINTER(_RenderParams),
        ct.POINTER(ct.c_double), ct.POINTER(ct.c_double), ct.c_double,
        ct.c_int32, ct.c_int32, ct.POINTER(ct.c_double),
    ]
    return lib


def _f64p(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_double))


def _i32p(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int32))


def _u8p(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint8))


def _pack_scene(osc: OracleScene):
    """OracleScene -> (_CScene, keepalive list)."""
    keep = []

    def f64(x):
        a = np.ascontiguousarray(np.asarray(x), np.float64)
        keep.append(a)
        return _f64p(a)

    def i32(x):
        a = np.ascontiguousarray(np.asarray(x), np.int32)
        keep.append(a)
        return _i32p(a)

    def u8(x):
        a = np.ascontiguousarray(np.asarray(x), np.uint8)
        keep.append(a)
        return _u8p(a)

    m, lt = osc.materials, osc.lights
    sp, pl, dk = osc.spheres, osc.planes, osc.disks
    hd, cy, rc, bx = osc.hollow_disks, osc.cylinders, osc.rectangles, osc.boxes

    s = _CScene()
    s.n_materials = len(m["ambient"])
    s.mat_color = f64(m["color"])
    s.mat_ambient = f64(m["ambient"])
    s.mat_diffuse = f64(m["diffuse"])
    s.mat_specular = f64(m["specular"])
    s.mat_shininess = f64(m["shininess"])
    s.mat_texture_index = i32(m["texture_index"])
    s.mat_normal_map_index = i32(m["normal_map_index"])
    s.mat_invert_uv_x = u8(m["invert_uv_x"])
    s.mat_invert_uv_y = u8(m["invert_uv_y"])
    s.mat_swap_uvs = u8(m["swap_uvs"])
    s.mat_double_sided = u8(m["double_sided_normals"])
    s.mat_flip_normals = u8(m["flip_normals"])

    s.n_lights = len(lt["intensity"])
    s.light_pos = f64(lt["pos"])
    s.light_color = f64(lt["color"])
    s.light_intensity = f64(lt["intensity"])
    s.light_att_const = f64(lt["attenuation_constant"])
    s.light_att_lin = f64(lt["attenuation_linear"])
    s.light_att_quad = f64(lt["attenuation_quadratic"])

    s.n_spheres = len(sp["radius"])
    s.sph_pos = f64(sp["pos"])
    s.sph_axes = f64(sp["axes"])
    s.sph_radius = f64(sp["radius"])
    s.sph_mat = i32(sp["mat_idx"])

    s.n_planes = len(pl["mat_idx"])
    s.pln_pos = f64(pl["pos"])
    s.pln_axes = f64(pl["axes"])
    s.pln_tex_offset = f64(pl["texture_offset"])
    s.pln_tex_size = f64(pl["texture_size"])
    s.pln_repeat = u8(pl["repeat_texture"])
    s.pln_mat = i32(pl["mat_idx"])

    s.n_disks = len(dk["mat_idx"])
    s.dsk_pos = f64(dk["pos"])
    s.dsk_axes = f64(dk["axes"])
    s.dsk_radius = f64(dk["radius"])
    s.dsk_mat = i32(dk["mat_idx"])

    s.n_hollow = len(hd["mat_idx"])
    s.hd_pos = f64(hd["pos"])
    s.hd_axes = f64(hd["axes"])
    s.hd_inner = f64(hd["inner_radius"])
    s.hd_outer = f64(hd["outer_radius"])
    s.hd_mat = i32(hd["mat_idx"])

    s.n_cylinders = len(cy["mat_idx"])
    s.cyl_pos = f64(cy["pos"])
    s.cyl_axes = f64(cy["axes"])
    s.cyl_height = f64(cy["height"])
    s.cyl_radius = f64(cy["radius"])
    s.cyl_mat = i32(cy["mat_idx"])

    s.n_rectangles = len(rc["mat_idx"])
    s.rct_pos = f64(rc["pos"])
    s.rct_axes = f64(rc["axes"])
    s.rct_width = f64(rc["width"])
    s.rct_height = f64(rc["height"])
    s.rct_mat = i32(rc["mat_idx"])

    s.n_boxes = len(bx["mat_idx"])
    s.box_face_pos = f64(bx["face_pos"])
    s.box_face_axes = f64(bx["face_axes"])
    s.box_face_width = f64(bx["face_width"])
    s.box_face_height = f64(bx["face_height"])
    s.box_mat = i32(bx["mat_idx"])

    if osc.tex_data is not None:
        td = np.ascontiguousarray(osc.tex_data, np.float64)
        keep.append(td)
        s.n_tex = td.shape[0]
        s.tex_h, s.tex_w = td.shape[1], td.shape[2]
        s.tex_data = _f64p(td)
        s.tex_sizes = f64(osc.tex_sizes)
        s.tex_max_w = float(osc.tex_max_size[0])
        s.tex_max_h = float(osc.tex_max_size[1])
    if osc.background is not None:
        bg = np.ascontiguousarray(osc.background, np.float64)
        keep.append(bg)
        s.bg_h, s.bg_w = bg.shape[0], bg.shape[1]
        s.bg_data = _f64p(bg)
    s.r_s = float(osc.r_s)
    return s, keep


def render_image(osc: OracleScene, cam_pos, cam_axes, fov, width, height,
                 max_steps=100, max_revolutions=2, u_f=0.01,
                 percent_black=-1.0, raytrace_type=CURVED,
                 curved_percentage=0.5, crosshair=False,
                 noise_mode="hash", noise_seed=0,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """(height, width, 4) float64 frame of the native oracle; rows render
    in slabs on ``n_threads`` threads (ctypes releases the GIL).
    ``noise_mode`` "glsl" or "hash" (the oracle has no other); the debug
    test ray is not drawn: a scene with one raises NotImplementedError
    (the Python oracle draws it)."""
    if osc.test_ray_points is not None:
        raise NotImplementedError(
            "the native oracle does not draw the debug test ray; use "
            "oracle.reference")
    if percent_black >= 0.0 and noise_mode not in ("glsl", "hash"):
        raise ValueError(f"the oracle has no noise_mode {noise_mode!r}")
    lib = _get_lib()
    scene, keep = _pack_scene(osc)
    params = _RenderParams(
        width=width, height=height, max_steps=max_steps,
        max_revolutions=max_revolutions, u_f=u_f,
        percent_black=percent_black, raytrace_type=raytrace_type,
        curved_percentage=curved_percentage, crosshair=int(crosshair),
        noise_mode=0 if noise_mode == "glsl" else 1,
        noise_seed=noise_seed & 0xFFFFFFFF,
    )
    cam_pos = np.ascontiguousarray(_f64(cam_pos))
    cam_axes = np.ascontiguousarray(_f64(cam_axes))
    fov = float(_f64(fov))
    out = np.zeros((height, width, 4), np.float64)

    n_threads = n_threads or min(os.cpu_count() or 1, 16)
    rows = np.linspace(0, height, n_threads + 1).astype(int)

    def run(lo, hi):
        if hi <= lo:
            return
        buf = out[lo:hi]
        lib.oracle_render_rows(
            ct.byref(scene), ct.byref(params),
            _f64p(cam_pos), _f64p(cam_axes), fov,
            int(lo), int(hi), _f64p(buf))

    with ThreadPoolExecutor(n_threads) as ex:
        list(ex.map(lambda p: run(*p), zip(rows[:-1], rows[1:])))
    del keep
    return out


# ---------------------------------------------------------------------------
# The parity method (benchmarks/parity_r05.py).
# ---------------------------------------------------------------------------

TOL = 2e-3
CONTRAST = 0.02
DISPLAY_COUNT = 1.0 / 255.0
ULP2 = 2.4e-7  # about 2 f32 ulps, relative


def dilate(mask, r):
    """``mask`` grown by r pixels (4-neighbourhood steps, no wrap)."""
    out = mask.copy()
    for _ in range(r):
        m = out
        for ax in (0, 1):
            for sh in (-1, 1):
                rolled = np.roll(m, sh, axis=ax)
                if ax == 0:
                    rolled[0 if sh == 1 else -1, :] = False
                else:
                    rolled[:, 0 if sh == 1 else -1] = False
                out = out | rolled
        out = out | m
    return out


def boundary(oracle_rgb):
    """Pixels whose 3 x 3 neighbourhood (wrapping, as parity_r05's) spans
    more than CONTRAST on some channel of the oracle image."""
    mx = oracle_rgb.copy()
    mn = oracle_rgb.copy()
    shifts = [(sy, 0) for sy in (-1, 1)] + [(0, sx) for sx in (-1, 1)] + [
        (sy, sx) for sy in (-1, 1) for sx in (-1, 1)]
    for sy, sx in shifts:
        r = np.roll(np.roll(oracle_rgb, sy, 0), sx, 1)
        mx = np.maximum(mx, r)
        mn = np.minimum(mn, r)
    return (mx - mn).max(-1) > CONTRAST


def classify(gold, img):
    """(summary dict, offenders [(y, x, diff)] above a display count off
    the boundary at r0) of ``img`` against ``gold``."""
    d = np.abs(gold - img).max(-1)
    bad = d > TOL
    bound = boundary(gold[..., :3])
    res = {"max_abs_diff": float(d.max()),
           "frac_within_tol": float((~bad).mean()),
           "n_gt_tol": int(bad.sum()),
           "finite": bool(np.isfinite(img).all())}
    for r in range(4):
        grown = dilate(bound, r)
        res[f"nonboundary_gt_tol_r{r}"] = int((bad & ~grown).sum())
        res[f"nonboundary_gt_display_r{r}"] = int(
            ((d > DISPLAY_COUNT) & ~grown).sum())
    off = (d > DISPLAY_COUNT) & ~bound
    return res, [(int(y), int(x), float(d[y, x]))
                 for y, x in zip(*np.nonzero(off))]


PROBES = {"rs_plus": dict(r_s=1.0 + ULP2), "rs_minus": dict(r_s=1.0 - ULP2),
          "cam_fwd": dict(push=ULP2), "cam_back": dict(push=-ULP2),
          "fov_plus": dict(dfov=ULP2), "fov_minus": dict(dfov=-ULP2)}


def probe(render_at, offenders, base):
    """parity_r05's marginality probe of each offender under PROBES."""
    imgs = {name: render_at(**kw) for name, kw in PROBES.items()}
    report = []
    for y, x, diff in offenders:
        moved = {name: float(np.abs(img[y, x] - base[y, x]).max())
                 for name, img in imgs.items()}
        moved = {k: v for k, v in moved.items() if v > DISPLAY_COUNT}
        report.append(dict(y=y, x=x, diff_vs_oracle=diff,
                           marginal=bool(moved), flipped_by=moved))
    return report


def parity(gold, render, cam):
    """A renderer's parity with the oracle frame ``gold``: ``render(cam,
    r_s)`` -> (H, W, 4) numpy renders at r_s 1 and, for the probe, at
    PROBES' perturbations of r_s, the camera's position (pushed along
    itself) and its fov.  Returns (:func:`classify`'s summary with the
    probe's report and its count of non-marginal offenders, the frame)."""

    def render_at(r_s=1.0, push=0.0, dfov=0.0):
        return render(cam._replace(pos=cam.pos * (1.0 + np.float32(push)),
                                   fov=cam.fov * (1.0 + np.float32(dfov))),
                      r_s)

    img = render_at()
    res, offenders = classify(gold, img)
    report = probe(render_at, offenders, img) if offenders else []
    res["offender_probe"] = report
    res["nonboundary_gt_display_r0_nonmarginal"] = sum(
        not r["marginal"] for r in report)
    return res, img
