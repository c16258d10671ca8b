"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises, so the exit code is not
0):
  0. device: the card's name and power limit (nvidia-smi);
  1. build: nvcc compiles schwarzschild_tpu_torch/csrc/*.cu for sm_90a
     (ptxas registers and spills per kernel);
  2. march_bh: the kernel against its plain version on config-2 rays at
     512x512 (status agreement, fdir error, the event record, kernel and
     plain ms, executed steps and the bound);
  3. march_scene: the same on demo-scene rays at 1280x720 with 4 slots
     (status, nhits, fdir, fpos, slot planes; t_end and sstep_k exactly),
     with the kernel's ray mapping and launch shape and the exact row
     tests a step that the cull lets through (counted on the plain run;
     tools/warp_mapping.py compares the ray mappings);
  4. frames: the forward path, render_fast (demo scene, 1280x720, 4 slots)
     and render_horizon_sky (config 2, 512x512) with the launch counters
     reset just before and read just after, then their times, then small
     frames rendered on the card against the same frames on the CPU;
  5. march_scene_bwd: the adjoint kernel against its plain version at
     1280x720, both fed the forward kernel's events and the same random
     cotangents (ms, checkpoint interval, scratch bytes, shared memory a
     block, ptxas registers and spills, the bound);
  6. gradient_frames: the gradient path, the gradient of
     sum(render_fast(differentiable=True) * w) at 1280x720 with respect to
     r_s, cam.pos and the background texels, and the same for
     render_horizon_sky at 512x512, with the counters reset around it;
     forward + backward ms, the split into march forward / adjoint /
     composition, peak memory, device time from torch.profiler; then the
     card's gradients against the CPU's at a small size;
  7. inverse: config 5 at 128x128, inverse.fit(renderer="fast",
     disk_slot=5) for 5 steps from r_s 0.7 against a target rendered at
     r_s 1, with the counters reset around it: losses, ms per step;
  8. flyby: first march_scene against its plain version at the flyby's
     own inputs (the 1920x1080 split-screen rays and mask of the
     trajectory cameras at t = 0 and 0.5); then config 4 (8 frames of the
     hyperbolic flyby, 1920x1080, split screen) through
     animation.render_trajectory(renderer="fast", prefetch=2,
     encode_workers=2) into a temporary directory, with the counters reset
     around it: one march_scene launch a frame; every PNG, decoded here,
     equals to_uint8 of a direct render_fast of its camera; a second call
     into the same directory renders nothing (8 frame_skipped events, no
     launch); a run that keeps the frames in memory, with
     measure_device_ms: every frame finite and equal to the direct
     render; the timings (per-frame seconds, wall time per frame,
     host_fetch_ms, png_ms of the PNG run, device_ms_est), the 1080p frame
     alone (CUDA events) with one profiled frame's device time and idle
     share, and a 192x108 flyby frame on the card against the CPU's.
Then one JSON line of per-kernel results, the card line again, and as the
last line {"ok": true, "device": {...}}.

Tolerances: a forward kernel must agree with its plain version on the
status of at least 99.9% of lanes; among agreeing lanes at least 99.9%
must have every float output within 1e-3 relative to 1 + |plain| (the march
is chaotic near the photon sphere, so a lane can drift without changing its
fate), and the event planes must be equal.  The adjoint kernel must be
within 2e-3 of the plain version's largest |value| per output and its r_s
gradient within 2e-3 relative (tests/test_adjoint.py's rule).  A frame on
the card must match the CPU frame within 2e-3 on at least 99.5% of pixels;
gradients within rtol 2e-2, atol 1e-3 (tests/test_kernel_scene.py's rule).
At the flyby's rays the scene kernel must equal its plain version on every
lane: every plane of both instantiations and every event.
A flyby frame on the card must match the CPU's within 1 uint8 level on at
least 99.5% of pixels (tests/test_aux.py's rule for the JAX animation module).
A kernel's time (``ms``) is its wrapper's whole call, host work included,
and the other times are CUDA-event medians of 10 runs after 2 warm-up
runs (plain versions: 3 after 1); ``device_ms`` is the kernel alone, its
device time from torch.profiler, the median of 20 launches after 3 warm-up
calls, or null where the profiler lost the launches.

Bounds: the least time an H100 SXM could take for a kernel's work, the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its f32 operations over 67 TFLOP/s.  Operations are counted
per step from csrc/ on the common path (no far-field re-entry; sinf and
cosf one each, so the count is low and the bound stays a bound) and
multiplied by the steps these inputs executed (count_steps).  The scene
march's table work is what its culled design needs at these inputs,
counted lane by lane on the plain run (CullCount): the cull's tests and
the exact tests of the rows they let through; the full-table count (every
row's exact test on every step) is printed beside it.
"""

from __future__ import annotations

import json
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations per executed step, counted from csrc/march_common.cuh and
# csrc/march.cu: rk4_segment 91, the far-field test 1, the escape test 1,
# the horizon sphere_entry 24, the capture test 1.
OPS_BH_STEP = 118
# The scene step: the same 118, the window and select 3, the hit logic 4,
# and per table row (segment_min_dist) the exact test and the fold.  The
# cull adds the segment's grown midpoint once a step (7) and 11 a bound
# test (|m - c|^2 <= (R + hl)^2): the scene's on every step, a group's
# where the scene's passed, a row's of a box where its group's passed; and
# 6 a cylinder's axis_parallel test where its group's did not pass (its
# first half: the second runs only on segments within 2e-6 of the axis).
OPS_SCENE_STEP = 125
OPS_ROW = {"spheres": 35, "planes": 26, "disks": 41, "hollow": 42,
           "cylinders": 81, "rects": 49}
OPS_MID = 7
OPS_REACH = 11
OPS_PARALLEL = 6
# The adjoint's work is each step's forward once (diff_step 92: the
# far-field test and rk4_segment) and its reverse once (184, the reverse
# half of diff_step_vjp), plus one compare per slot; per ray, the init 56
# and its reverse 120 (the reverse half of init_core_vjp).  The kernel
# recomputes each step's forward inside diff_step_vjp (164 more) and the
# init inside init_core_vjp rather than saving them: a choice of its design,
# so the bound leaves those out.
OPS_BWD_STEP = 92 + 184
OPS_INIT = 56
OPS_INIT_VJP = 120


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=2, reps=10):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, name, reps=20, tries=3):
    """Median device time (ms) of the kernel whose name holds ``name``, one
    launch per call of ``fn``, from torch.profiler: the kernel alone,
    without the wrapper's host work (which cuda_ms counts where the card
    waits for it).  The profiler can lose a run's kernel events, some or
    all: a run that shows fewer than half the launches is taken again, and
    after ``tries`` such runs the result is None."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name]
        if 2 * len(times) >= reps:
            return statistics.median(times) / 1e3
    return None


def rays(cam, W, H, dev):
    """Origins, directions and the march's active mask of cam's W x H
    pixels on dev, as the frames build them."""
    from schwarzschild_tpu_torch import camera as cam_mod
    from schwarzschild_tpu_torch import geometry as geo
    from schwarzschild_tpu_torch import physics

    u, v = cam_mod.pixel_grid(W, H, device=dev)
    o, d = cam_mod.generate_rays(cam, u, v, W, H)
    return o, d, ~physics.is_radial(d, geo.safe_normalize(o))


def bound(n_bytes, ops):
    """(bound_ms, bound_by) of work that moves n_bytes and does ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agreement(kernel_out, plain_out):
    """(status share, max abs error and in-tolerance share of the float
    outputs over status-agreeing lanes, the agreeing lanes)."""
    same = kernel_out["status"] == plain_out["status"]
    if "nhits" in kernel_out:
        same = same & (kernel_out["nhits"] == plain_out["nhits"])
    share = same.float().mean().item()
    max_err = 0.0
    ok = same.clone()
    for key, a in kernel_out.items():
        if key in ("status", "nhits"):
            continue
        b = plain_out[key]
        diff = (a - b).abs()
        lane_ok = diff <= 1e-3 * (1.0 + b.abs())
        if diff.dim() > same.dim():
            diff = diff.amax(-1)
            lane_ok = lane_ok.all(-1)
        max_err = max(max_err, diff[same].max().item() if same.any() else 0.0)
        ok = ok & lane_ok
    within = (ok.sum() / same.sum().clamp_min(1)).item()
    return share, max_err, within, same


def scene_planes(out):
    """{name: plane} of a march_scene result: fdir, fpos, status, nhits and
    each slot's start, dir and len."""
    fdir, fpos, status, slots, nhits = out[:5]
    res = dict(fdir=fdir, fpos=fpos, status=status, nhits=nhits)
    for i, (s0, d0, l0) in enumerate(slots):
        res.update({f"slot{i}.start": s0, f"slot{i}.dir": d0,
                    f"slot{i}.len": l0})
    return res


class CullCount:
    """An on_segment hook for the plain scene march that counts the table
    work of the culled kernel: f32 operations summed over the lane-steps
    that run table tests (``lane_ops``; ``steps`` counts those lane-steps:
    a step that escapes or finishes flat runs none), and the exact row
    tests the cull let through (``exact``).  ``work`` lists one step's
    tests with the lanes that need each (tools/warp_mapping.py costs them
    per warp)."""

    def __init__(self, tables, bounds):
        from schwarzschild_tpu_torch import kernel_scene

        self.cull = lambda *seg: kernel_scene.segment_cull_torch(
            tables, bounds, *seg)
        self.groups = bounds["groups"]
        self.n_planes = len(tables.get("planes", ()))
        self.steps = self.exact = self.lane_ops = 0

    def work(self, live, *seg):
        """([(lanes, ops)] of one step's plane and cull tests, [(lanes,
        ops)] of its exact tests of bounded rows)."""
        c = self.cull(*seg)
        tests = [(live, OPS_ROW["planes"])] * self.n_planes
        exact = []
        if c["scene"] is None:
            return tests, exact
        tests.append((live, OPS_MID + OPS_REACH))
        for (name, first, count, _), in_group in zip(self.groups,
                                                     c["groups"]):
            tests.append((live & c["scene"], OPS_REACH))
            if name == "cylinders":
                tests.append((live & ~in_group, OPS_PARALLEL))
            elif count > 1:
                tests += [(live & in_group, OPS_REACH)] * count
            exact += [(live & m, OPS_ROW[name])
                      for m in c["rows"][name][first:first + count]]
        return tests, exact

    def __call__(self, live, *seg):
        tests, exact = self.work(live, *seg)
        self.steps += int(live.sum())
        self.exact += sum(int(m.sum()) for m, _ in exact)
        self.lane_ops += sum(int(m.sum()) * ops for m, ops in tests + exact)


def read_png(path):
    """(H, W, 3) uint8 rows of an 8-bit RGB PNG whose rows use filter 0,
    as animation's encoder writes them; raises on anything else."""
    import numpy as np

    data = Path(path).read_bytes()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    at, idat, header = 8, b"", None
    while at < len(data):
        (length,), kind = struct.unpack(">I", data[at:at + 4]), data[at + 4:
                                                                     at + 8]
        chunk = data[at + 8:at + 8 + length]
        require(struct.unpack(">I", data[at + 8 + length:at + 12 + length])[0]
                == zlib.crc32(kind + chunk), f"{path}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat += chunk
        at += 12 + length
    w, h, depth, color = header[:4]
    require((depth, color) == (8, 2), f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    require(bool((rows[:, 0] == 0).all()), f"{path}: a row filter is not 0")
    return rows[:, 1:].reshape(h, w, 3)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def profile_device(fn, top=5):
    """Device time (ms), kernel count and the ``top`` kernels by device
    time of one call of ``fn``, from torch.profiler.  A measurement only:
    a profiler that cannot trace the card gives "not measured", not a
    failure."""
    import torch

    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # noqa: BLE001
        return dict(device_ms=f"not measured: {exc!r}")
    if not seen:
        return dict(device_ms="not measured")
    by_name = {}
    for e in seen:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ms=sum(e.device_time_total for e in seen) / 1e3,
                kernels=len(seen),
                top=[[name[:80], round(us / 1e3, 4)] for name, us in heavy])


def ptxas_report(log_text):
    """{kernel: {"registers": r, "spill_stores": s, "spill_loads": l}}
    from nvcc -Xptxas -v output (empty when the library was not rebuilt);
    a forward kernel's events instantiation is "<name><events>"."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in ("march_scene_bwd_kernel",
                                     "march_scene_kernel", "march_bh_kernel")
                         if k in m.group(1)), m.group(1))
            if "ILb1E" in m.group(1):  # the <true> (events) instantiation
                name += "<events>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def flyby_phase(dev, cpu, reset_launches, read_launches, n_frames=8,
                small=(192, 108)):
    """Phase 8 (see the module's docstring): config 4's flyby of n_frames
    frames through animation.render_trajectory on dev, checked and timed,
    the scene kernel against its plain version at the flyby's rays, and a
    small flyby frame on dev against the same frame on cpu."""
    import dataclasses

    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import animation, configs, kernel
    from schwarzschild_tpu_torch import kernel_scene, metrics
    from schwarzschild_tpu_torch import camera as cam_mod

    c4 = configs.config4_animation(n_frames=n_frames, device=dev)
    cfg4 = c4["cfg"]

    def flyby(out_dir, **kw):
        logger = metrics.MetricsLogger()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = animation.render_trajectory(
            c4["scene"], cfg4, c4["background"], c4["tex"], times=c4["times"],
            out_dir=out_dir, logger=logger, all_frames_local=True,
            renderer="fast", prefetch=2, encode_workers=2,
            **c4["trajectory"], **kw)
        torch.cuda.synchronize()
        return out, logger.records, time.perf_counter() - t0

    def flyby_cam(t, device):
        return cam_mod.hyperbolic_trajectory(
            cam_mod.make_camera((0.0, 2.0, 15.0), device=device),
            time=t, **c4["trajectory"])

    def kernel_vs_plain(t):
        """march_scene against march_scene_torch, both on dev, at the rays
        and mask that render_fast gives the kernel for the trajectory
        camera at time t: every plane of both instantiations and every
        event must be equal."""
        px = kernel.pixel_setup(flyby_cam(t, dev), cfg4, dev)
        args = (px["origin"], px["direction"], px["march_px"], 1.0,
                c4["scene"], cfg4, 4, c4["tex"])
        ref = kernel_scene.march_scene_torch(*args, events=True)
        got = kernel_scene.march_scene(*args, events=True)
        pairs = [(a, b) for out in (kernel_scene.march_scene(*args), got)
                 for a, b in zip(scene_planes(out).values(),
                                 scene_planes(ref).values())]
        pairs += [(got[5]["t_end"], ref[5]["t_end"])] + list(
            zip(got[5]["ssteps"], ref[5]["ssteps"]))
        return dict(time=t, marched_lanes=int(px["march_px"].sum()),
                    every_lane_equal=all(torch.equal(a, b) for a, b in pairs),
                    max_abs_err=max((a.float() - b.float()).abs().max().item()
                                    for a, b in pairs))

    # At the start and at the closest approach (10 from the hole).
    at_flyby_rays = [kernel_vs_plain(t) for t in (0.0, 0.5)]

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        paths, records, wall = flyby(Path(tmp) / "a")
        fly_launches = read_launches()
        reset_launches()
        _, again, _ = flyby(Path(tmp) / "a")
        resume_launches = read_launches()
        pngs = [read_png(path) for _, path in paths]
    in_memory, timed, _ = flyby(None, measure_device_ms=True)
    direct = [sp.render_fast(c4["scene"], flyby_cam(t, dev), cfg4,
                             c4["background"], c4["tex"], 1.0,
                             overflow="ignore") for t in c4["times"]]
    pngs_equal = [bool((png == sp.to_uint8(d).cpu().numpy()).all())
                  for png, d in zip(pngs, direct)]
    driver_frames_equal = [torch.equal(f, d.cpu())
                           for (_, f), d in zip(in_memory, direct)]
    finite = all(bool(torch.isfinite(f).all()) for _, f in in_memory)

    def one_frame():
        return sp.render_fast(c4["scene"], flyby_cam(0.0, dev), cfg4,
                              c4["background"], c4["tex"], 1.0,
                              overflow="ignore")

    frame_1080_ms = cuda_ms(one_frame)
    profiled_frame = profile_device(one_frame)
    if isinstance(profiled_frame.get("device_ms"), float):
        profiled_frame["idle_share"] = (1.0 - profiled_frame["device_ms"]
                                        / frame_1080_ms)

    small4 = dataclasses.replace(cfg4, width=small[0], height=small[1])
    small_frames = []
    for device in (dev, cpu):
        c = configs.config4_animation(n_frames=1, device=device)
        small_frames.append(animation.render_trajectory(
            c["scene"], small4, c["background"], c["tex"], times=[0.5],
            all_frames_local=True, **c["trajectory"])[0][1])
    small_diff = (sp.to_uint8(small_frames[0]).short()
                  - sp.to_uint8(small_frames[1]).short()).abs().amax(-1)
    share_small = (small_diff <= 1).float().mean().item()

    def fields(recs, event, key):
        return [r[key] for r in recs if r["event"] == event]

    log("flyby", shape=[cfg4.height, cfg4.width], frames=len(paths),
        raytrace_type="HALF_WIDTH", march_scene_vs_plain=at_flyby_rays,
        launches=fly_launches, resume_launches=resume_launches,
        resume_skipped=len(fields(again, "frame_skipped", "frame")),
        pngs_equal_direct_render=pngs_equal,
        driver_frames_equal_direct_render=driver_frames_equal,
        finite=finite, wall_s=wall, wall_ms_per_frame=wall / len(paths) * 1e3,
        frame_seconds=fields(records, "frame", "seconds"),
        host_fetch_ms=fields(records, "frame", "host_fetch_ms"),
        png_ms=fields(records, "png", "png_ms"),
        device_ms_est=fields(timed, "device_ms_estimate", "device_ms"),
        frame_1920x1080_cuda_ms=frame_1080_ms,
        profiled_frame=profiled_frame,
        card_vs_cpu_192x108_within_1_level=share_small)
    require(all(r["every_lane_equal"] for r in at_flyby_rays),
            f"march_scene differs from plain at the flyby's rays: "
            f"{at_flyby_rays}")
    require(fly_launches["march_scene"] == len(c4["times"]) == len(paths),
            f"flyby launches {fly_launches} for {len(paths)} frames")
    require(finite, "a flyby frame is not finite")
    require(all(pngs_equal),
            f"flyby PNGs equal to_uint8(render_fast): {pngs_equal}")
    require(len(in_memory) == len(direct) and all(driver_frames_equal),
            f"driver frames equal render_fast: {driver_frames_equal}")
    require(resume_launches["march_scene"] == 0
            and len(fields(again, "frame_skipped", "frame")) == len(paths),
            f"the resumed flyby rendered: {resume_launches}")
    require(share_small >= 0.995, f"flyby frame vs CPU {share_small}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import _ext, configs, inverse
    from schwarzschild_tpu_torch import kernel, kernel_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    counters = (kernel.march_bh, kernel_scene.march_scene,
                kernel_scene.march_scene_bwd)

    def reset_launches():
        for f in counters:
            f.launches = 0

    def read_launches():
        torch.cuda.synchronize()
        return {f.__name__: f.launches for f in counters}

    # 0. device
    card = card_line()
    log("device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # 1. build
    t0 = time.perf_counter()
    built = _ext.build()
    _ext.library()
    ptxas = ptxas_report(built.log)
    log("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(built.seconds, 3), compiled=built.built,
        flags=" ".join(_ext.NVCC_FLAGS), sources="schwarzschild_tpu_torch/csrc",
        library=built.path.name, ptxas=ptxas)

    results = {}

    # 2. march_bh on config-2 rays at 512x512
    c2 = configs.config2_curved(device=dev)
    cfg2 = c2["cfg"]
    o, d, act = rays(c2["camera"], cfg2.width, cfg2.height, dev)
    k = kernel.march_bh(o, d, act, 1.0, cfg2, events=True, count_steps=True)
    p = kernel.march_bh_torch(o, d, act, 1.0, cfg2, events=True)
    torch.cuda.synchronize()
    share, err, within, same = agreement(dict(status=k[1], fdir=k[0]),
                                         dict(status=p[1], fdir=p[0]))
    events_equal = bool(
        torch.equal(k[2]["t_end"][same], p[2]["t_end"][same])
        and torch.equal(k[2]["died_moving"][same], p[2]["died_moving"][same]))
    every_lane_equal = all(torch.equal(a, b) for a, b in [
        (k[1], p[1]), (k[0], p[0]), (k[2]["t_end"], p[2]["t_end"]),
        (k[2]["died_moving"], p[2]["died_moving"])])
    steps = int(k[3])
    ms = cuda_ms(lambda: kernel.march_bh(o, d, act, 1.0, cfg2))
    dev_ms = device_ms(lambda: kernel.march_bh(o, d, act, 1.0, cfg2),
                       "march_bh_kernel")
    plain_ms = cuda_ms(lambda: kernel.march_bh_torch(o, d, act, 1.0, cfg2),
                       warmup=1, reps=3)
    n = act.numel()
    b_ms, b_by = bound(41 * n, OPS_BH_STEP * steps + OPS_INIT * n)
    results["march_bh"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by)
    design = _ext.DESIGN
    log("march_bh", shape=[cfg2.height, cfg2.width], status_agree=share,
        fdir_max_abs_err=err, within_tol=within, events_equal=events_equal,
        every_lane_equal=every_lane_equal,
        launch=dict(threads=design["BH_THREADS"],
                    warp_tile=[design["BH_TILE_ROWS"],
                               32 // design["BH_TILE_ROWS"]],
                    blocks_per_sm=_ext.library().march_bh_blocks_per_sm(0),
                    ptxas={key: val for key, val in ptxas.items()
                           if key.startswith("march_bh")} or "not rebuilt"),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, executed_steps=steps,
        bound_ms=b_ms, bound_by=b_by, captured=int((k[1] == 1.0).sum()))
    require(share >= 0.999, f"march_bh status agreement {share}")
    require(within >= 0.999, f"march_bh fdir agreement {within}")
    require(events_equal, "march_bh event record differs from plain")

    # 3. march_scene on demo-scene rays at 1280x720, 4 slots
    sc = configs.demo_scene(device=dev)
    cam = configs.demo_camera(device=dev)
    bg = configs.background_texture(device=dev)
    tex = configs.demo_texture_stack(device=dev)
    cfg = sp.RenderConfig(width=1280, height=720, percent_black=-1.0)
    o, d, act = rays(cam, cfg.width, cfg.height, dev)

    kout = kernel_scene.march_scene(o, d, act, 1.0, sc, cfg, 4, tex,
                                    events=True, count_steps=True)
    tables = kernel_scene._pack_scene_smem(sc, tex)
    counted = CullCount(tables, kernel_scene._row_bounds(
        tables, 6 * sc.boxes.mat_idx.shape[0]))
    pout = kernel_scene._as_outputs(kernel_scene._march_scene_planes_torch(
        o, d, act, 1.0, sc, cfg, 4, tex, on_segment=counted), True, False,
        cfg)
    torch.cuda.synchronize()
    share, err, within, same = agreement(scene_planes(kout),
                                         scene_planes(pout))
    events_equal = torch.equal(kout[5]["t_end"][same],
                               pout[5]["t_end"][same]) and all(
        torch.equal(a[same], b[same])
        for a, b in zip(kout[5]["ssteps"], pout[5]["ssteps"]))
    steps = int(kout[6])
    ms = cuda_ms(lambda: kernel_scene.march_scene(o, d, act, 1.0, sc, cfg,
                                                  4, tex))
    ms_events = cuda_ms(lambda: kernel_scene.march_scene(
        o, d, act, 1.0, sc, cfg, 4, tex, events=True))
    dev_ms = device_ms(lambda: kernel_scene.march_scene(
        o, d, act, 1.0, sc, cfg, 4, tex), "march_scene_kernel")
    plain_ms = cuda_ms(lambda: kernel_scene.march_scene_torch(
        o, d, act, 1.0, sc, cfg, 4, tex), warmup=1, reps=3)
    n = act.numel()
    full_table_ops = sum(OPS_ROW[name] * len(rows)
                         for name, rows in tables.items())
    ops_step = OPS_SCENE_STEP + counted.lane_ops / steps
    b_ms, b_by = bound((25 + 32 + 28 * 4) * n,
                       OPS_SCENE_STEP * steps + counted.lane_ops
                       + OPS_INIT * n)
    full_ms, _ = bound((25 + 32 + 28 * 4) * n,
                       (OPS_SCENE_STEP + full_table_ops) * steps
                       + OPS_INIT * n)
    results["march_scene"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by)
    counts = {str(c): int((kout[2] == c).sum()) for c in range(5)}
    words = kernel_scene._kernel_buffer(
        tables, 6 * sc.boxes.mat_idx.shape[0])[0].size
    log("march_scene", shape=[cfg.height, cfg.width], n_slots=4,
        status_nhits_agree=share, max_abs_err=err, within_tol=within,
        events_equal=bool(events_equal),
        every_lane_equal=bool(share == 1.0 and err == 0.0 and events_equal),
        ms=ms, ms_with_events=ms_events, device_ms=dev_ms, plain_ms=plain_ms,
        launch=dict(threads=design["SCENE_THREADS"],
                    warp_tile=[design["TILE_ROWS"],
                               32 // design["TILE_ROWS"]],
                    table_words=words,
                    tables=("shared memory, copied once a block"
                            if words <= kernel_scene.SHARED_TABLE_WORDS
                            else "device memory"),
                    ptxas=ptxas.get("march_scene_kernel", "not rebuilt")),
        executed_steps=steps, table_tested_steps=counted.steps,
        exact_row_tests_per_step=counted.exact / steps,
        table_rows=sum(len(r) for r in tables.values()),
        table_ops_per_step=dict(full_table=full_table_ops,
                                culled_per_lane=counted.lane_ops / steps),
        ops_per_step=ops_step, bound_ms=b_ms, bound_by=b_by,
        full_table_bound_ms=full_ms, status_counts=counts,
        max_nhits=int(kout[4].max()))
    require(share >= 0.999, f"march_scene status/nhits agreement {share}")
    require(within >= 0.999, f"march_scene float agreement {within}")
    require(events_equal, "march_scene events differ from plain")

    # 4. frames: the forward path, with the launch counters reset around it
    reset_launches()
    img = sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=4)
    sky = sp.render_horizon_sky(c2["camera"], cfg2, c2["background"], 1.0)
    fwd_launches = read_launches()
    require(img.shape == (720, 1280, 4) and bool(torch.isfinite(img).all()),
            "render_fast frame not finite or misshapen")
    require(sky.shape == (512, 512, 4) and bool(torch.isfinite(sky).all()),
            "render_horizon_sky frame not finite or misshapen")
    require(fwd_launches["march_scene"] >= 1, "render_fast launched no kernel")
    require(fwd_launches["march_bh"] >= 1,
            "render_horizon_sky launched no kernel")
    frame_ms = cuda_ms(lambda: sp.render_fast(sc, cam, cfg, bg, tex, 1.0,
                                              n_slots=4))
    sky_ms = cuda_ms(lambda: sp.render_horizon_sky(c2["camera"], cfg2,
                                                   c2["background"], 1.0))
    log("frames", launches=fwd_launches, render_fast_1280x720_ms=frame_ms,
        render_horizon_sky_512_ms=sky_ms,
        mean_rgb=[round(x, 6) for x in img[..., :3].mean((0, 1)).tolist()])

    small = sp.RenderConfig(width=320, height=180, percent_black=-1.0)
    gpu_img = sp.render_fast(sc, cam, small, bg, tex, 1.0).cpu()
    cpu_img = sp.render_fast(configs.demo_scene(device=cpu),
                             configs.demo_camera(device=cpu), small,
                             configs.background_texture(device=cpu),
                             configs.demo_texture_stack(device=cpu), 1.0)
    sky_small = sp.RenderConfig(width=128, height=128, percent_black=-1.0)
    gpu_sky = sp.render_horizon_sky(c2["camera"], sky_small,
                                    c2["background"], 1.0).cpu()
    cpu_sky = sp.render_horizon_sky(configs.demo_camera(device=cpu),
                                    sky_small,
                                    configs.background_texture(device=cpu),
                                    1.0)
    share_img = ((gpu_img - cpu_img).abs().amax(-1) < 2e-3).float().mean()
    share_sky = ((gpu_sky - cpu_sky).abs().amax(-1) < 2e-3).float().mean()
    log("frames_vs_cpu", render_fast_320x180=share_img.item(),
        render_horizon_sky_128=share_sky.item())
    require(share_img.item() >= 0.995, f"render_fast vs CPU {share_img}")
    require(share_sky.item() >= 0.995, f"render_horizon_sky vs CPU {share_sky}")

    # 5. march_scene_bwd at 1280x720 on the forward kernel's events
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    H, W = cfg.height, cfg.width
    cts = (rnd(H, W, 3), rnd(H, W, 3),
           [(rnd(H, W, 3), rnd(H, W, 3), rnd(H, W)) for _ in range(4)])
    bwd_args = (o, d, 1.0, cfg, cts, kout[2], kout[5], 4)
    got = kernel_scene.march_scene_bwd(*bwd_args)
    ref = kernel_scene.march_scene_bwd_torch(*bwd_args)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() / b.abs().max().item()
            for a, b in zip(got[:2], ref[:2])]
    rs_err = abs(got[2].item() - ref[2].item()) / abs(ref[2].item())
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    ms = cuda_ms(lambda: kernel_scene.march_scene_bwd(*bwd_args))
    dev_ms = device_ms(lambda: kernel_scene.march_scene_bwd(*bwd_args),
                       "march_scene_bwd_kernel")
    plain_ms = cuda_ms(lambda: kernel_scene.march_scene_bwd_torch(*bwd_args),
                       warmup=1, reps=3)
    scratch = kernel_scene.bwd_scratch_bytes(cfg, n)
    saves_every_step = cfg.max_steps * 15 * n * 4
    b_ms, b_by = bound((81 + 32 * 4) * n,
                       (OPS_BWD_STEP + 4) * steps
                       + (OPS_INIT + OPS_INIT_VJP) * n)
    results["march_scene_bwd"] = dict(
        max_abs_err=max((a - b).abs().max().item()
                        for a, b in zip(got[:2], ref[:2])),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by)
    log("march_scene_bwd", shape=[H, W], n_slots=4,
        rel_err_origin=errs[0], rel_err_direction=errs[1], rel_err_r_s=rs_err,
        max_abs_err=results["march_scene_bwd"]["max_abs_err"], ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms,
        checkpoint_every=kernel_scene.BWD_CHECKPOINT_EVERY,
        scratch_bytes=scratch,
        scratch_bytes_saving_every_step=saves_every_step,
        threads=design["BWD_THREADS"],
        shared_bytes_per_block=(kernel_scene.BWD_CHECKPOINT_EVERY
                                * len(kernel_scene._CORE)
                                * design["BWD_THREADS"] * 4),
        executed_steps=steps, bound_ms=b_ms, bound_by=b_by,
        ptxas=ptxas.get("march_scene_bwd_kernel", "library not rebuilt"))
    require(scratch * 4 <= saves_every_step,
            f"adjoint scratch {scratch} B is over a quarter of "
            f"{saves_every_step}")
    require(finite, "march_scene_bwd gave non-finite gradients")
    require(max(errs) <= 2e-3 and rs_err <= 2e-3,
            f"march_scene_bwd vs plain: {errs}, r_s {rs_err}")

    # 6. gradient frames: the gradient path, counters reset around it
    w = torch.rand((H, W, 4), generator=gen).to(dev)
    w2 = torch.rand((512, 512, 4), generator=gen).to(dev)

    def scene_grad(device, cfg_, w_, scene, camera, back, stack):
        pos = camera.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=device, requires_grad=True)
        bg_data = back.data.clone().requires_grad_(True)
        img_ = sp.render_fast(scene, camera._replace(pos=pos), cfg_,
                              sp.Texture(bg_data), stack, r_s,
                              overflow="ignore", differentiable=True)
        return torch.autograd.grad((img_ * w_).sum(), [r_s, pos, bg_data])

    def sky_grad(device, cfg_, w_, camera, back):
        pos = camera.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=device, requires_grad=True)
        bg_data = back.data.clone().requires_grad_(True)
        img_ = sp.render_horizon_sky(camera._replace(pos=pos), cfg_,
                                     sp.Texture(bg_data), r_s,
                                     differentiable=True)
        return torch.autograd.grad((img_ * w_).sum(), [r_s, pos, bg_data])

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    g_scene = scene_grad(dev, cfg, w, sc, cam, bg, tex)
    scene_launches = read_launches()
    scene_peak = torch.cuda.max_memory_allocated() - base_mem
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    g_sky = sky_grad(dev, cfg2, w2, c2["camera"], c2["background"])
    sky_launches = read_launches()
    sky_peak = torch.cuda.max_memory_allocated() - base_mem
    for g in g_scene + g_sky:
        require(bool(torch.isfinite(g).all()), "non-finite frame gradient")
    require(scene_launches["march_scene"] >= 1
            and scene_launches["march_scene_bwd"] >= 1,
            f"render_fast gradient launches {scene_launches}")
    require(sky_launches["march_bh"] >= 1
            and sky_launches["march_scene_bwd"] >= 1,
            f"render_horizon_sky gradient launches {sky_launches}")
    require(bool((g_scene[2] != 0).any()) and bool((g_sky[2] != 0).any()),
            "no background texel gradient")
    scene_ms = cuda_ms(lambda: scene_grad(dev, cfg, w, sc, cam, bg, tex))
    sky_grad_ms = cuda_ms(lambda: sky_grad(dev, cfg2, w2, c2["camera"],
                                           c2["background"]))
    profiled = profile_device(lambda: scene_grad(dev, cfg, w, sc, cam, bg,
                                                 tex))
    log("gradient_frames", launches_render_fast=scene_launches,
        launches_render_horizon_sky=sky_launches,
        render_fast_1280x720_fwd_bwd_ms=scene_ms,
        render_horizon_sky_512_fwd_bwd_ms=sky_grad_ms,
        split_ms=dict(march_forward_with_events=ms_events,
                      adjoint=ms,
                      composition_fwd_bwd=scene_ms - ms_events - ms),
        peak_bytes_render_fast=scene_peak,
        peak_bytes_render_horizon_sky=sky_peak,
        profiled_render_fast=profiled,
        grad_r_s=g_scene[0].item(), grad_pos=g_scene[1].tolist(),
        sky_grad_r_s=g_sky[0].item())

    small = sp.RenderConfig(width=64, height=36, percent_black=-1.0)
    ws = torch.rand((36, 64, 4), generator=gen)
    gg = scene_grad(dev, small, ws.to(dev), sc, cam, bg, tex)
    gc = scene_grad(cpu, small, ws, configs.demo_scene(device=cpu),
                    configs.demo_camera(device=cpu),
                    configs.background_texture(device=cpu),
                    configs.demo_texture_stack(device=cpu))
    sky_small = sp.RenderConfig(width=64, height=64, percent_black=-1.0)
    wk = torch.rand((64, 64, 4), generator=gen)
    hg = sky_grad(dev, sky_small, wk.to(dev), c2["camera"], c2["background"])
    hc = sky_grad(cpu, sky_small, wk, configs.demo_camera(device=cpu),
                  configs.background_texture(device=cpu))

    def close(a, b):
        return bool(torch.allclose(a.cpu(), b, rtol=2e-2, atol=1e-3))

    grads_ok = dict(render_fast_r_s=close(gg[0], gc[0]),
                    render_fast_pos=close(gg[1], gc[1]),
                    render_horizon_sky_r_s=close(hg[0], hc[0]),
                    render_horizon_sky_pos=close(hg[1], hc[1]))
    log("gradients_vs_cpu", sizes=dict(render_fast=[36, 64],
                                       render_horizon_sky=[64, 64]),
        card=[gg[0].item(), gg[1].tolist(), hg[0].item(), hg[1].tolist()],
        cpu=[gc[0].item(), gc[1].tolist(), hc[0].item(), hc[1].tolist()],
        within_rule=grads_ok)
    require(all(grads_ok.values()), f"card gradients vs CPU: {grads_ok}")

    # 7. inverse: config 5, five fit steps from r_s 0.7, counters reset
    c5 = configs.config5_inverse(device=dev)
    target = sp.render_fast(c5["scene"], c5["camera"], c5["cfg"],
                            c5["background"], c5["tex"], 1.0,
                            overflow="ignore")
    messages, stamps = [], []

    def log_fn(msg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        messages.append(msg)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, history = inverse.fit(
        c5["scene"], c5["cfg"], c5["background"], c5["tex"], 5, target,
        c5["camera"], r_s0=0.7, n_steps=5, log_every=1, log_fn=log_fn,
        renderer="fast")
    inverse_launches = read_launches()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    warnings = [m for m in messages if "WARNING" in m]
    r_s_fit = float(torch.logaddexp(params.r_s_raw, torch.zeros_like(
        params.r_s_raw)))
    optimizer = inverse.default_optimizer()
    step = inverse.make_train_step(inverse.make_loss(
        c5["scene"], c5["cfg"], c5["background"], c5["tex"], 5, target),
        optimizer)
    state = optimizer.init(params)
    log("inverse", shape=[128, 128], steps=len(history), losses=history,
        step_ms=step_ms, r_s_after=r_s_fit, launches=inverse_launches,
        nonfinite_fired=len(warnings),
        profiled_step=profile_device(lambda: step(params, state)))
    require(len(history) == 5 and all(
        map(lambda x: x == x and abs(x) != float("inf"), history)),
        f"config-5 losses {history}")
    require(not warnings, f"non-finite gradient entries: {warnings}")
    require(inverse_launches["march_scene_bwd"] >= 5,
            f"config-5 steps launched {inverse_launches}")

    # 8. flyby: config 4 through animation.render_trajectory, counters reset
    flyby_phase(dev, cpu, reset_launches, read_launches)

    src = "schwarzschild_tpu_torch/csrc/march.cu"
    kernels = [
        dict(name="march_bh", route="cuda", source=src,
             replaces="schwarzschild_tpu/kernel.py:252",
             launches=fwd_launches["march_bh"], library_ms=None,
             **results["march_bh"]),
        dict(name="march_scene", route="cuda", source=src,
             replaces="schwarzschild_tpu/kernel_scene.py:961",
             launches=fwd_launches["march_scene"], library_ms=None,
             **results["march_scene"]),
        dict(name="march_scene_bwd", route="cuda", source=src,
             replaces="schwarzschild_tpu/kernel_scene.py:787",
             launches=scene_launches["march_scene_bwd"], library_ms=None,
             **results["march_scene_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
