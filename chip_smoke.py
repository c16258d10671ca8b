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
     share, and a 192x108 flyby frame on the card against the CPU's;
  9. dense: the dense differentiable renderer, render.render, on the demo
     scene at 1280x720 (100 steps, forward only) against render_fast on
     the card; its frame time (CUDA-event median of 5 after 1 warm-up),
     kernels a frame and device time (torch.profiler), peak memory, the
     steps the march runs before every ray has stopped;
 10. dense_grad: config 5 at its published 128x128: 3 steps of
     inverse.fit(renderer="jnp") (losses, ms a step, peak memory,
     launches: the dense path launches no march kernel); the gradient of
     adjoint.make_diff_scene_renderer(backward="twin") in r_s, cam.pos and
     the background texels against backward="kernel" at config 5, and of
     make_diff_horizon_sky at config 2, 512x512 (the twin's forward
     launches its kernel once a call); the steps the dense march runs at
     the target;
 11. test_ray: the demo scene at 1280x720 from the demo camera with two
     test rays (the demo camera's, radial: 2 points; one aimed at
     (2.5, 0, 0) from the demo position, which bends into the horizon: 34
     points): march_scene with the tube rows against its plain version on
     every lane and plane, events on and off; render_fast(test_ray=,
     n_slots=6) against the dense render(test_ray=); tube pixels present;
     march_scene's device time with and without the tubes, the table
     words and their route; one gradient frame with tubes (finite, the
     adjoint launched);
 12. cem: config 5's pose search as the JAX package's harness drives it
     (benchmarks/inverse_r05.py): a 2-view rig at 64x64 (offsets (0, 0,
     0) and (5, 0, -3), horizon_softness 0.1), make_multiview_loss(
     renderer="fast", blur_sigmas=(8, 2)) with the disk masked out by
     view_weights, 3 iterations of cem_fit_pose(pop=64, elite=16): time a
     iteration, march_scene launches an iteration (pop x views), the best
     loss of each;
 13. trilinear: texture_filter="trilinear" through render_fast (demo,
     1280x720, 4 slots) and render_horizon_sky (config 2, 512x512) with
     the counters reset around them (one march launch a frame), their times
     beside the bilinear frames', the mip pyramid's bytes and the frames'
     peak memory, the same frame from textures that carry their mips, small
     frames on the card against the CPU's, render_fast against the dense
     render on the card, one 720p trilinear gradient frame (r_s, cam.pos,
     the sky's and the stack's texels: finite, one adjoint launch) and its
     gradients on the card against the CPU's at 64x36;
 14. prng: noise_mode="prng" at 1280x720, percent_black 0.75: the field on
     the card equals the CPU's bit for bit and the first 16 values and the
     SHA-256 recorded from jax.random.uniform; the march's active mask is
     the field's (its t_end plane too); render_fast skips exactly those
     pixels, one launch;
 15. oracle: config 2 at 512x512 against the native float64 oracle,
     render_horizon_sky and render_fast, by benchmarks/parity_r05.py's
     method (tools/parity_oracle.py runs configs 2 and 3 at full size);
 16. profiling: profiling.device_time of a march_bh call at 512x512 beside
     its cuda_ms and device_ms;
 17. sharded: a one-rank NCCL group and make_mesh(); the demo frame at
     1280x720 through make_sharded_render, "fast" (4 slots) and "jnp",
     each equal to the unsharded frame bit for bit; the tile function at
     every coordinate of meshes (4, 1), (2, 2) and (7, 1) (720 rows padded
     to 721), each assembled frame equal to the unsharded one with one
     march_scene launch a tile; config 2 at 512x512 through march_bh tiles
     on (3, 1), equal to the unsharded planes; the 720p gradient in r_s
     and cam.pos summed over 4 tiles within rtol 1e-3 of the unsharded
     one (4 adjoint launches); the sharded and unsharded frames' times
     and each tile's (one card: several cards over NCCL are not checked);
 18. viewer: examples/live_viewer_torch.py's frame function over its
     SELFTEST_SCRIPT at 1280x720 and 192x96: uint8 frames, one
     march_scene launch a frame (none in FLAT mode), each within 1 count
     of the CPU port's frame of the same state on at least 99.5% of
     pixels (every 16th row at 1280x720); median steady frame time and
     the ansi_frame encode time;
 19. examples: examples/render_configs_torch.py, configs 1-4 with --fast
     --scale 0.5: the PNGs written and the seconds a config;
 20. atlas: the demo's fetch atlas (build time, bytes) and one
     atlas_fetch a lane at 1280x720 lanes of mixed layers, equal to
     sample_stack/sample_texture, beside their time; the demo frame at
     1280x720 with compact_slots "auto", None and (None, 16, 16, 16),
     bit-equal, their times and host synchronizations beside the
     trilinear frame's per-slot loop; the reference's default
     (percent_black 0.75, hash noise) through the lane-sparse branch and
     tile noise (16, 128) through the tile-sparse one, each within 1e-6 of
     its compact_slots=None frame with one march launch, and at 512x128 /
     256x128 within the frame rule of the CPU's; march_scene on those
     rays and march_bh on config 2 at 512x512 under the same mask, with
     and without compact=True, bit-equal on active rays, device times;
     bfloat16 textures against float32 ones (within one count on 98% of
     channels); the 720p gradient frame with frozen texels and with the
     background's texels (finite, one adjoint launch, time, peak memory)
     and both against the CPU's at 64x36 by the gradient rule.
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
At the flyby's rays, and with the test-ray tube rows, the scene kernel must
equal its plain version on every lane: every plane of both instantiations
and every event.  render_fast against the dense renderer on the card: at
least 99.5% of pixels within 2e-3 (99% with tubes; tests/test_kernel_
scene.py's rules); twin against kernel gradients: rtol 2e-2, atol 1e-3
for r_s, cam.pos and every background texel.
A flyby frame on the card must match the CPU's within 1 uint8 level on at
least 99.5% of pixels (tests/test_aux.py's rule for the JAX animation module).
Trilinear render_fast against the dense render: at least 94% of pixels
within 2e-3 (tests/test_kernel_scene.py::test_trilinear_parity: the two
renderers take their LOD from different neighbours).  The oracle phase
fails on any non-boundary pixel more than a display count off that no
ulp-scale perturbation moves.
A kernel's time (``ms``) is its wrapper's whole call, host work included,
and the other times are CUDA-event medians of 10 runs after 2 warm-up
runs (plain versions: 3 after 1); ``device_ms`` is the kernel alone, its
device time from torch.profiler, the median of 20 launches after 3 warm-up
calls, or null (with a device_ms line saying why) where the profiler did
not see as many launches as the wrapper's counter made.

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

import importlib
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
    waits for it).  A run counts only if the profiler saw as many of the
    kernel's launches as its wrapper's counter made in that run (the
    profiler can lose some, or all); after ``tries`` runs that do not, the
    result is None and a ``device_ms`` line says why."""
    import torch

    counter = wrapper_of(name)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        before = counter.launches
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = counter.launches - before
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name]
        if launched and len(times) == launched:
            return statistics.median(times) / 1e3
        seen.append([len(times), launched])
    log("device_ms", kernel=name, value=None,
        reason="profiler launches != wrapper launches in every run",
        profiler_vs_wrapper=seen)
    return None


def wrapper_of(kernel_name):
    """The wrapper function (with its ``launches`` counter) that launches
    the CUDA kernel ``kernel_name``."""
    from schwarzschild_tpu_torch import kernel, kernel_scene

    return {"march_bh_kernel": kernel.march_bh,
            "march_scene_kernel": kernel_scene.march_scene,
            "march_scene_bwd_kernel": kernel_scene.march_scene_bwd}[
                kernel_name]


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


def profile_device(fn, top=5, host=True):
    """Device time (ms), kernel count and the ``top`` kernels by device
    time of one call of ``fn``, from torch.profiler.  A measurement only:
    a profiler that cannot trace the card gives "not measured", not a
    failure.  ``host=False`` traces the card alone (a call of some 10^5
    kernels has too many host events to collect quickly)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    try:
        with torch.profiler.profile(activities=acts) as prof:
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
            all_frames_local=True, renderer="fast",
            **c["trajectory"])[0][1])
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


def peak_bytes(fn):
    """(result of fn(), its peak device memory above what was allocated
    before the call)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def within(a, b, tol=2e-3):
    """Share of pixels of two (H, W, C) frames within tol on every
    channel (b's device)."""
    return ((a.to(b.device) - b).abs().amax(-1) < tol).float().mean().item()


def grads_close(a, b):
    """The gradient rule (tests/test_kernel_scene.py): a within rtol 2e-2,
    atol 1e-3 of b (on b's device)."""
    import torch

    return bool(torch.allclose(a.to(b.device), b, rtol=2e-2, atol=1e-3))


class FitClock:
    """inverse.fit's ``log_fn``: synchronises the card at every logged step
    and stamps the host clock."""

    def __init__(self):
        self.stamps, self.messages = [], []

    def __call__(self, msg):
        import torch

        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.messages.append(msg)

    def step_ms(self, t0):
        """Milliseconds of each logged step, the first from t0."""
        return [(b - a) * 1e3 for a, b in zip([t0] + self.stamps[:-1],
                                              self.stamps)]

    def warnings(self):
        return [m for m in self.messages if "WARNING" in m]


def dense_steps_run(sc, cam, cfg, bg, tex):
    """The steps the dense renderer's march runs: it ends once every ray
    has stopped (cfg.max_steps where some ray marches to the end)."""
    import torch

    render = importlib.import_module("schwarzschild_tpu_torch.render")
    with torch.no_grad():
        r_s = torch.tensor(1.0, device=bg.data.device)
        state, ctx = render._prepare(sc, cam, cfg, bg, tex, r_s)
        for i in range(cfg.max_steps):
            if not bool(state.active.any()):
                return i
            state = render._march_step(state, i, sc, cfg, r_s, tex, None)
    return cfg.max_steps


def dense_phase(sc, cam, bg, tex, reset_launches, read_launches,
                size=(1280, 720)):
    """Phase 9: the dense renderer at 1280x720, forward only, against
    render_fast on the card."""
    import torch

    import schwarzschild_tpu_torch as sp

    cfg = sp.RenderConfig(width=size[0], height=size[1], percent_black=-1.0)

    def dense():
        with torch.no_grad():
            return sp.render(sc, cam, cfg, bg, tex, 1.0)

    reset_launches()
    img, peak = peak_bytes(dense)
    launches = read_launches()
    steps_run = dense_steps_run(sc, cam, cfg, bg, tex)
    fast, n_over = sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=8,
                                  overflow="return")
    share = within(img, fast)
    frame_ms = cuda_ms(dense, warmup=1, reps=5)
    profiled = profile_device(dense, host=False)
    if isinstance(profiled.get("device_ms"), float):
        profiled["idle_share"] = 1.0 - profiled["device_ms"] / frame_ms
    log("dense", shape=[cfg.height, cfg.width], max_steps=cfg.max_steps,
        frame_ms=frame_ms, profiled_frame=profiled, peak_bytes=peak,
        launches=launches, steps_run=steps_run, render_fast_n_slots=8,
        render_fast_overflowed_rays=n_over, within_2e_3_of_render_fast=share,
        finite=bool(torch.isfinite(img).all()))
    require(img.shape == (cfg.height, cfg.width, 4)
            and bool(torch.isfinite(img).all()),
            "dense frame not finite or misshapen")
    require(share >= 0.995, f"dense frame vs render_fast: {share}")


def grads_of(f, cam, bg_data, w):
    """d sum(f(cam, bg, r_s) * w) / d (r_s, cam.pos, background texels)
    at r_s = 1."""
    import torch

    pos = cam.pos.clone().requires_grad_(True)
    r_s = torch.tensor(1.0, device=w.device, requires_grad=True)
    bg = bg_data.clone().requires_grad_(True)
    img = f(cam._replace(pos=pos), bg, r_s)
    return torch.autograd.grad((img * w).sum(), [r_s, pos, bg])


def compare_grads(twin, kern):
    """The twin-vs-kernel rule (grads_close) for r_s, cam.pos and the
    background texels, and the share of texels within it, logged."""
    import torch

    texels = (torch.abs(twin[2] - kern[2])
              <= 1e-3 + 2e-2 * torch.abs(kern[2])).float().mean().item()
    return dict(r_s=[twin[0].item(), kern[0].item()],
                pos=[twin[1].tolist(), kern[1].tolist()],
                r_s_close=grads_close(twin[0], kern[0]),
                pos_close=grads_close(twin[1], kern[1]),
                texels_close=grads_close(twin[2], kern[2]),
                texels_within=texels,
                finite=all(bool(torch.isfinite(g).all()) for g in twin + kern))


def dense_grad_phase(c5, target, c2, reset_launches, read_launches):
    """Phase 10: config 5's dense fit steps and the twin backward against
    the kernel backward at config 5 and config 2."""
    import torch

    from schwarzschild_tpu_torch import adjoint, inverse

    clock = FitClock()

    def run_fit():
        t0 = time.perf_counter()
        params, history = inverse.fit(
            c5["scene"], c5["cfg"], c5["background"], c5["tex"], 5, target,
            c5["camera"], r_s0=0.7, n_steps=3, log_every=1, log_fn=clock,
            renderer="jnp")
        return t0, history

    reset_launches()
    (t0, history), peak = peak_bytes(run_fit)
    fit_launches = read_launches()
    step_ms = clock.step_ms(t0)

    gen = torch.Generator(device="cpu").manual_seed(1)
    dev = target.device
    w5 = torch.rand(target.shape, generator=gen).to(dev)
    res = {}
    for name, cfg, cam, bg, w, make in (
            ("scene_config5", c5["cfg"], c5["camera"], c5["background"], w5,
             lambda b: adjoint.make_diff_scene_renderer(
                 c5["cfg"], c5["scene"], c5["tex"], backward=b)),
            ("horizon_config2_512", c2["cfg"], c2["camera"], c2["background"],
             torch.rand((c2["cfg"].height, c2["cfg"].width, 4),
                        generator=gen).to(dev),
             lambda b: adjoint.make_diff_horizon_sky(c2["cfg"], backward=b))):
        reset_launches()
        twin, twin_peak = peak_bytes(
            lambda: grads_of(make("twin"), cam, bg.data, w))
        twin_launches = read_launches()
        kern = grads_of(make("kernel"), cam, bg.data, w)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads_of(make("twin"), cam, bg.data, w)
        torch.cuda.synchronize()
        res[name] = dict(compare_grads(twin, kern), launches=twin_launches,
                         peak_bytes=twin_peak,
                         twin_fwd_bwd_ms=(time.perf_counter() - t1) * 1e3)
    log("dense_grad", shape=[c5["cfg"].height, c5["cfg"].width],
        fit_renderer="jnp", max_steps=c5["cfg"].max_steps,
        steps_run_at_target=dense_steps_run(
            c5["scene"], c5["camera"], c5["cfg"], c5["background"],
            c5["tex"]),
        losses=history, step_ms=step_ms, peak_bytes_fit=peak,
        fit_launches=fit_launches,
        nonfinite_warnings=clock.warnings(),
        twin_vs_kernel=res)
    require(len(history) == 3 and all(
        x == x and abs(x) != float("inf") for x in history),
        f"dense config-5 losses {history}")
    require(sum(fit_launches.values()) == 0,
            f"the dense fit launched a march kernel: {fit_launches}")
    for name, r in res.items():
        require(r["finite"] and r["r_s_close"] and r["pos_close"]
                and r["texels_close"],
                f"{name} twin vs kernel gradients: {r}")
    require(res["scene_config5"]["launches"] == dict(
        march_bh=0, march_scene=1, march_scene_bwd=0),
        f"scene twin launches {res['scene_config5']['launches']}")
    require(res["horizon_config2_512"]["launches"] == dict(
        march_bh=1, march_scene=0, march_scene_bwd=0),
        f"horizon twin launches {res['horizon_config2_512']['launches']}")


def tube_pixels(img):
    """(red, green) pixel counts: the curved and the flat tube's colours."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    red = (r > 0.99) & (g < 0.01) & (b < 0.01)
    green = (g > 0.99) & (r < 0.01) & (b < 0.01)
    return int(red.sum()), int(green.sum())


def tubes_phase(sc, cam, bg, tex, reset_launches, read_launches,
                size=(1280, 720)):
    """Phase 11: the demo frame at 1280x720 with the debug tubes."""
    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import camera as cam_mod
    from schwarzschild_tpu_torch import features, kernel, kernel_scene

    dev = cam.pos.device
    cfg = sp.RenderConfig(width=size[0], height=size[1], percent_black=-1.0)
    px = kernel.pixel_setup(cam, cfg, dev)
    o, d, act = px["origin"], px["direction"], px["march_px"]
    n_boxes = 6 * sc.boxes.mat_idx.shape[0]

    def march(tr, events=False):
        return kernel_scene.march_scene(o, d, act, 1.0, sc, cfg, 6, tex,
                                        events=events, test_ray=tr)

    plain_dev_ms = device_ms(lambda: march(None), "march_scene_kernel")
    out = []
    for name, src in (("demo_radial", cam),
                      ("aimed_2.5_0_0", cam_mod.look_at(
                          cam, torch.tensor((2.5, 0.0, 0.0), device=dev)))):
        tr = features.calculate_test_ray(src, device=dev)
        ref = kernel_scene.march_scene_torch(o, d, act, 1.0, sc, cfg, 6, tex,
                                             events=True, test_ray=tr)
        got = march(tr, events=True)
        pairs = [(a, b) for res in (march(tr), got)
                 for a, b in zip(scene_planes(res).values(),
                                 scene_planes(ref).values())]
        pairs += [(got[5]["t_end"], ref[5]["t_end"])] + list(
            zip(got[5]["ssteps"], ref[5]["ssteps"]))
        equal = all(torch.equal(a, b) for a, b in pairs)
        tables = kernel_scene._pack_scene_smem(sc, tex, tr, 1.0)
        words = kernel_scene._kernel_buffer(tables, n_boxes)[0].size
        with torch.no_grad():
            dense = sp.render(sc, cam, cfg, bg, tex, 1.0, test_ray=tr)
        reset_launches()
        fast = sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=6,
                              overflow="ignore", test_ray=tr)
        fast_launches = read_launches()
        share = within(fast, dense)
        pos = cam.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=dev, requires_grad=True)
        reset_launches()
        img = sp.render_fast(sc, cam._replace(pos=pos), cfg, bg, tex, r_s,
                             n_slots=6, overflow="ignore",
                             differentiable=True, test_ray=tr)
        g = torch.autograd.grad(img.sum(), [r_s, pos])
        grad_launches = read_launches()
        out.append(dict(
            test_ray=name, points=int(tr.num_points),
            every_lane_equal=equal,
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in pairs),
            status_counts={str(c): int((ref[2] == c).sum())
                           for c in range(5)},
            within_2e_3_of_dense=share, tube_pixels_dense=tube_pixels(dense),
            tube_pixels_fast=tube_pixels(fast),
            march_scene_device_ms=device_ms(lambda: march(tr),
                                            "march_scene_kernel"),
            table_words=words,
            tables=("shared memory" if words
                    <= kernel_scene.SHARED_TABLE_WORDS else "device memory"),
            render_fast_launches=fast_launches, grad_launches=grad_launches,
            grad_finite=all(bool(torch.isfinite(x).all()) for x in g),
            grad_r_s=g[0].item()))
    words0 = kernel_scene._kernel_buffer(
        kernel_scene._pack_scene_smem(sc, tex), n_boxes)[0].size
    log("test_ray", shape=[cfg.height, cfg.width], n_slots=6,
        march_scene_device_ms_without_tubes=plain_dev_ms,
        table_words_without_tubes=words0, rays=out)
    for r in out:
        require(r["every_lane_equal"],
                f"march_scene with tubes differs from plain: {r}")
        require(r["within_2e_3_of_dense"] >= 0.99,
                f"render_fast with tubes vs dense: {r}")
        require(r["tube_pixels_fast"][1] > 0 and (
            r["test_ray"] == "demo_radial" or r["tube_pixels_fast"][0] > 0),
            f"tube pixels missing: {r}")
        require(r["render_fast_launches"]["march_scene"] == 1
                and r["grad_launches"]["march_scene_bwd"] == 1
                and r["grad_finite"], f"tube frame launches/grads: {r}")


def cem_phase(c5, reset_launches, read_launches, pop=64, n_iters=3,
              size=64):
    """Phase 12: the config-5 CEM pose search on a 2-view rig at 64x64."""
    import dataclasses

    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import inverse

    cfg = dataclasses.replace(c5["cfg"], width=size, height=size,
                              horizon_softness=0.1, checkpoint_every=0)
    sc, bg, tex, cam = c5["scene"], c5["background"], c5["tex"], c5["camera"]
    dev = cam.pos.device
    offsets = [(0.0, 0.0, 0.0), (5.0, 0.0, -3.0)]
    targets = [sp.render_fast(sc, cam._replace(pos=cam.pos + torch.tensor(
        off, device=dev)), cfg, bg, tex, 1.0, overflow="ignore")
        for off in offsets]
    cam0 = cam._replace(pos=cam.pos + torch.tensor((0.3, -0.2, 0.4),
                                                   device=dev))
    p0 = inverse.init_params(cam0, 0.7, tex, 5)
    p0 = p0._replace(disk_texture=torch.full_like(p0.disk_texture, 0.5),
                     cam_fwd_raw=p0.cam_fwd_raw + torch.tensor(
                         (0.02, -0.015, 0.01), device=dev))

    # The harness's disk mask: pixels whose colour changes between two
    # flat disk colourings, blur-dilated by 6 pixels, are left out.
    weights = []
    with torch.no_grad():
        cam_p, r_s, _ = inverse.realize(p0, tex, 5)
        for off in offsets:
            imgs = [sp.render_fast(
                sc, cam_p._replace(pos=cam_p.pos + torch.tensor(
                    off, device=dev)), cfg, bg,
                inverse.realize(p0._replace(disk_texture=torch.full_like(
                    p0.disk_texture, c)), tex, 5)[2], r_s,
                overflow="ignore") for c in (0.25, 0.75)]
            m = ((imgs[0] - imgs[1]).abs().amax(-1) > 1.0 / 255.0).float()
            dil = inverse.gaussian_blur(m[..., None], 6.0)[..., 0]
            weights.append((dil < 0.02).float())
    loss_fn = inverse.make_multiview_loss(
        sc, cfg, bg, tex, 5, targets, offsets, renderer="fast",
        blur_sigmas=(8.0, 2.0), view_weights=weights)
    marks = []

    def timed_loss(p):
        value = loss_fn(p)
        torch.cuda.synchronize()
        marks.append((time.perf_counter(),
                      read_launches()["march_scene"]))
        return value

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, info = inverse.cem_fit_pose(timed_loss, p0, n_iters=n_iters,
                                     pop=pop, elite=16, seed=0)
    bounds = [(t0, 0)] + [marks[pop * (i + 1) - 1] for i in range(n_iters)]
    iter_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(bounds, bounds[1:])]
    iter_launches = [b[1] - a[1] for a, b in zip(bounds, bounds[1:])]
    cam_f, r_s_f, _ = inverse.realize(fit, tex, 5)
    log("cem", shape=[size, size], views=len(offsets), pop=pop, elite=16,
        iterations=n_iters, iter_ms=iter_ms, launches_per_iter=iter_launches,
        best_loss_per_iter=info["history"], best_loss=info["best_loss"],
        masked_pixels=[int((w == 0).sum()) for w in weights],
        r_s_after=float(r_s_f), pos_err_after=float(
            torch.linalg.norm(cam_f.pos - cam.pos)))
    require(all(n == pop * len(offsets) for n in iter_launches),
            f"CEM launches per iteration {iter_launches}")
    require(all(x == x and abs(x) != float("inf") for x in info["history"]),
            f"CEM losses {info['history']}")


# jax.random.uniform(jax.random.key(0), (720, 1280)), recorded from JAX 0.9.0
# on the CPU (the card's machine has no JAX): the float32 bits of its first
# 16 values and the SHA-256 of its float32 bytes, row-major.
PRNG_FIRST16_BITS = [
    1064475214, 1064993846, 1051337244, 1055913296, 1058137146, 1042905504,
    1050595796, 1060143564, 1061104664, 1043275376, 1065107494, 1020206464,
    1059314120, 1058016386, 1063662304, 1064254938]
PRNG_SHA256 = ("741bfad24330ed0b5e543fafd3bd71fc"
               "64ebe304435811230ab05361f9d35409")


def trilinear_phase(sc, cam, bg, tex, c2, reset_launches, read_launches,
                    size=(1280, 720), small=(96, 54), grad_small=(64, 36)):
    """Phase 13: texture_filter="trilinear" through render_fast (demo,
    4 slots) and render_horizon_sky (config 2), one launch of each march a
    frame, timed beside the bilinear frames; the mip pyramid's memory; small
    frames on the card against the CPU's; render_fast against the dense
    render on the card; one trilinear gradient frame, and its gradients on
    the card against the CPU's at a small size."""
    import dataclasses

    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs

    dev = bg.data.device
    cpu = torch.device("cpu")
    cfg_b = sp.RenderConfig(width=size[0], height=size[1],
                            percent_black=-1.0)
    cfg_t = dataclasses.replace(cfg_b, texture_filter="trilinear")
    sky_b = c2["cfg"]
    sky_t = dataclasses.replace(sky_b, texture_filter="trilinear")
    cam2, bg2 = c2["camera"], c2["background"]

    (bg_m, tex_m), mip_peak = peak_bytes(
        lambda: (sp.with_mips(bg), sp.stack_with_mips(tex)))
    mip_bytes = sum(m.numel() * m.element_size()
                    for m in bg_m.mips + tex_m.mips)
    base_bytes = sum(t.numel() * t.element_size()
                     for t in (bg.data, tex.data))

    def fast(cfg, b=bg, t=tex):
        return sp.render_fast(sc, cam, cfg, b, t, 1.0, n_slots=4)

    reset_launches()
    img, tri_peak = peak_bytes(lambda: fast(cfg_t))
    sky = sp.render_horizon_sky(cam2, sky_t, bg2, 1.0)
    launches = read_launches()
    require(img.shape == (size[1], size[0], 4)
            and bool(torch.isfinite(img).all()),
            "trilinear render_fast frame not finite or misshapen")
    require(bool(torch.isfinite(sky).all()),
            "trilinear render_horizon_sky frame not finite")
    require(launches["march_scene"] == 1 and launches["march_bh"] == 1,
            f"trilinear frames launched {launches}")
    _, bil_peak = peak_bytes(lambda: fast(cfg_b))
    same_prebuilt = bool(torch.equal(fast(cfg_t, bg_m, tex_m), img))
    differs = ((fast(cfg_b) - img).abs() > 1e-3).float().mean().item()
    times = dict(
        render_fast_trilinear_ms=cuda_ms(lambda: fast(cfg_t)),
        render_fast_bilinear_ms=cuda_ms(lambda: fast(cfg_b)),
        render_fast_trilinear_prebuilt_mips_ms=cuda_ms(
            lambda: fast(cfg_t, bg_m, tex_m)),
        render_horizon_sky_trilinear_ms=cuda_ms(
            lambda: sp.render_horizon_sky(cam2, sky_t, bg2, 1.0)),
        render_horizon_sky_bilinear_ms=cuda_ms(
            lambda: sp.render_horizon_sky(cam2, sky_b, bg2, 1.0)))

    small_t = sp.RenderConfig(width=small[0], height=small[1],
                              percent_black=-1.0, texture_filter="trilinear")
    sky_small = sp.RenderConfig(width=128, height=128, percent_black=-1.0,
                                texture_filter="trilinear")
    host = dict(sc=configs.demo_scene(device=cpu),
                cam=configs.demo_camera(device=cpu),
                bg=configs.background_texture(device=cpu),
                tex=configs.demo_texture_stack(device=cpu))
    card_small = sp.render_fast(sc, cam, small_t, bg, tex, 1.0)
    share_fast = within(card_small, sp.render_fast(
        host["sc"], host["cam"], small_t, host["bg"], host["tex"], 1.0))
    share_sky = within(
        sp.render_horizon_sky(cam2, sky_small, bg2, 1.0),
        sp.render_horizon_sky(host["cam"], sky_small, host["bg"], 1.0))
    with torch.no_grad():
        dense_small = sp.render(sc, cam, small_t, bg, tex, 1.0)
    share_dense = within(card_small, dense_small)

    def grads(device, cfg, w, scene, camera, back, stack):
        pos = camera.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=device, requires_grad=True)
        bg_data = back.data.clone().requires_grad_(True)
        tex_data = stack.data.clone().requires_grad_(True)
        out = sp.render_fast(scene, camera._replace(pos=pos), cfg,
                             sp.Texture(bg_data),
                             stack._replace(data=tex_data), r_s,
                             overflow="ignore", differentiable=True)
        return torch.autograd.grad((out * w).sum(),
                                   [r_s, pos, bg_data, tex_data])

    gen = torch.Generator(device="cpu").manual_seed(13)
    w = torch.rand((size[1], size[0], 4), generator=gen).to(dev)
    reset_launches()
    g_full, grad_peak = peak_bytes(
        lambda: grads(dev, cfg_t, w, sc, cam, bg, tex))
    grad_launches = read_launches()
    require(all(bool(torch.isfinite(g).all()) for g in g_full),
            "non-finite trilinear gradient")
    require(grad_launches["march_scene"] == 1
            and grad_launches["march_scene_bwd"] == 1,
            f"trilinear gradient frame launched {grad_launches}")
    require(bool((g_full[3] != 0).any()),
            "no texel gradient through the mips")
    grad_ms = cuda_ms(lambda: grads(dev, cfg_t, w, sc, cam, bg, tex),
                      warmup=1, reps=5)
    grad_profile = profile_device(
        lambda: grads(dev, cfg_t, w, sc, cam, bg, tex))
    small_g = sp.RenderConfig(width=grad_small[0], height=grad_small[1],
                              percent_black=-1.0, texture_filter="trilinear")
    ws = torch.rand((grad_small[1], grad_small[0], 4), generator=gen)
    gg = grads(dev, small_g, ws.to(dev), sc, cam, bg, tex)
    gc = grads(cpu, small_g, ws, host["sc"], host["cam"], host["bg"],
               host["tex"])
    close = {name: grads_close(a, b) for name, a, b in zip(
        ("r_s", "pos", "background", "texels"), gg, gc)}
    log("trilinear", shape=[size[1], size[0]], launches=launches,
        gradient_launches=grad_launches, **times,
        gradient_frame_fwd_bwd_ms=grad_ms,
        profiled_gradient_frame=grad_profile,
        mip_pyramid=dict(bytes=mip_bytes, base_texture_bytes=base_bytes,
                         build_peak_bytes=mip_peak,
                         frame_peak_bytes_trilinear=tri_peak,
                         frame_peak_bytes_bilinear=bil_peak,
                         gradient_frame_peak_bytes=grad_peak),
        prebuilt_mips_same_frame=same_prebuilt,
        share_of_pixels_changed_vs_bilinear=differs,
        card_vs_cpu=dict(render_fast=share_fast, render_horizon_sky=share_sky,
                         sizes=[list(small[::-1]), [128, 128]]),
        render_fast_vs_dense_on_card=share_dense,
        gradients_card_vs_cpu=close, grad_r_s=g_full[0].item())
    require(same_prebuilt, "a texture's own mips change the frame")
    require(differs > 0.0, "trilinear frame equals the bilinear one")
    require(share_fast >= 0.995 and share_sky >= 0.995,
            f"trilinear frames vs CPU: {share_fast}, {share_sky}")
    # tests/test_kernel_scene.py::test_trilinear_parity's rule for the two
    # renderers: their LOD neighbours differ (the dense renderer shades a
    # step's lanes, render_fast a slot's).
    require(share_dense >= 0.94,
            f"trilinear render_fast vs dense: {share_dense}")
    require(all(close.values()), f"trilinear gradients vs CPU: {close}")


def prng_phase(sc, cam, bg, tex, reset_launches, read_launches,
               size=(1280, 720), first16=PRNG_FIRST16_BITS,
               sha256=PRNG_SHA256):
    """Phase 14: noise_mode="prng" (jax.random's threefry field) at
    percent_black 0.75: the field on the card equals the CPU's bit for bit
    and JAX's recorded values; the march's active mask is the field's; the
    frame skips exactly those pixels."""
    import hashlib

    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import camera as cam_mod
    from schwarzschild_tpu_torch import kernel, kernel_scene, noise

    dev = bg.data.device
    cfg = sp.RenderConfig(width=size[0], height=size[1], percent_black=0.75,
                          noise_mode="prng")
    u, v = cam_mod.pixel_grid(size[0], size[1], device=dev)
    field = noise.noise_field(cfg, u, v)
    field_cpu = noise.noise_field(cfg, u.cpu(), v.cpu())
    bits = field.cpu().view(torch.int32)
    equal_cpu = bool(torch.equal(bits, field_cpu.view(torch.int32)))
    got16 = (bits.flatten()[:16].to(torch.int64) & 0xFFFFFFFF).tolist()
    digest = hashlib.sha256(field_cpu.numpy().tobytes()).hexdigest()

    px = kernel.pixel_setup(cam, cfg, dev)
    mask_is_field = bool(torch.equal(
        px["march_px"], ~px["flat_px"] & ~(field <= cfg.percent_black)))
    ev = kernel_scene.march_scene(px["origin"], px["direction"],
                                  px["march_px"], 1.0, sc, cfg, 4, tex,
                                  events=True)[5]
    kernel_mask = bool(torch.equal(ev["t_end"] >= 0, px["march_px"]))
    reset_launches()
    img = sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=4)
    launches = read_launches()
    skipped = px["noise_skip"]
    skips_exact = bool((img[skipped] == 0).all()) and bool(
        (img[~skipped].abs().amax(-1) > 0).float().mean() > 0.99)
    frame_ms = cuda_ms(lambda: sp.render_fast(sc, cam, cfg, bg, tex, 1.0,
                                              n_slots=4))
    log("prng", shape=[size[1], size[0]], percent_black=0.75,
        field_equal_cpu_bits=equal_cpu, first16_equal_jax=got16 == first16,
        sha256_equal_jax=digest == sha256, sha256=digest,
        active_mask_is_field=mask_is_field,
        kernel_marched_the_mask=kernel_mask, skipped_share=skipped.float()
        .mean().item(), skipped_pixels_black=skips_exact, launches=launches,
        render_fast_ms=frame_ms)
    require(equal_cpu, "prng field on the card differs from the CPU's")
    require(got16 == first16 and digest == sha256,
            "prng field differs from jax.random.uniform's")
    require(mask_is_field and kernel_mask,
            "the march's active mask is not the prng field's")
    require(launches["march_scene"] == 1, f"prng frame launched {launches}")
    require(skips_exact and bool(torch.isfinite(img).all()),
            "prng frame: skipped pixels not black, or not finite")


def oracle_phase(c2, size=512):
    """Phase 15: config 2 at size x size against the native float64 oracle
    (schwarzschild_tpu_torch.oracle.native), render_horizon_sky and
    render_fast on the card, by benchmarks/parity_r05.py's method:
    disagreements classified by distance to the oracle image's
    discontinuities, every pixel off by more than a display count at r0
    probed for decision marginality; the gate is no non-marginal offender.
    Config 3 at 1024 x 1024 is tools/parity_oracle.py's."""
    import dataclasses

    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch.oracle import native as oracle

    cam, bg = c2["camera"], c2["background"]
    cfg = dataclasses.replace(c2["cfg"], width=size, height=size,
                              percent_black=-1.0)
    t0 = time.perf_counter()
    osc = oracle.OracleScene.from_scene(c2["scene"], bg)
    gold = oracle.render_image(osc, cam.pos, cam.axes, cam.fov, size, size,
                               max_steps=cfg.max_steps).astype("float32")
    oracle_s = time.perf_counter() - t0

    def numpy_of(f):
        def run(camera, r_s):
            with torch.no_grad():
                return f(camera, torch.tensor(r_s, device=bg.data.device)
                         ).cpu().numpy()
        return run

    frames = {
        "render_horizon_sky": numpy_of(
            lambda c, r: sp.render_horizon_sky(c, cfg, bg, r)),
        "render_fast": numpy_of(
            lambda c, r: sp.render_fast(c2["scene"], c, cfg, bg, None, r,
                                        overflow="ignore"))}
    results = {}
    for name, render in frames.items():
        res, _ = oracle.parity(gold, render, cam)
        results[name] = {k: v for k, v in res.items()
                         if k != "offender_probe"}
        results[name]["offenders"] = res["offender_probe"]
    log("oracle", config="config2", shape=[size, size],
        oracle_seconds=oracle_s, results=results)
    for name, res in results.items():
        require(res["nonboundary_gt_display_r0_nonmarginal"] == 0,
                f"{name}: a non-marginal offender against the oracle")
        require(res["finite"], f"{name}: frame not finite")


def profiling_phase(c2):
    """Phase 16: profiling.device_time (the slope between chains of 2 and
    8 data-dependent calls, CUDA events) of a march_bh thunk on config 2's
    512 x 512 rays, beside cuda_ms (the wrapper's call) and device_ms (the
    kernel, torch.profiler) of the same call."""
    from schwarzschild_tpu_torch import kernel, profiling

    cfg = c2["cfg"]
    dev = c2["background"].data.device
    o, d, act = rays(c2["camera"], cfg.width, cfg.height, dev)

    def thunk(r):
        return kernel.march_bh(o * r, d, act, 1.0, cfg)[0][0, 0, 0]

    slope_ms = profiling.device_time(thunk, chains=(2, 8), trials=5,
                                     device=dev) * 1e3
    call_ms = cuda_ms(lambda: kernel.march_bh(o, d, act, 1.0, cfg))
    kernel_ms = device_ms(lambda: kernel.march_bh(o, d, act, 1.0, cfg),
                          "march_bh_kernel")
    log("profiling", shape=[cfg.height, cfg.width],
        device_time_slope_ms=slope_ms, cuda_ms=call_ms, device_ms=kernel_ms)
    require(slope_ms > 0.0, f"device_time slope {slope_ms} ms")


def sharded_phase(sc, cam, bg, tex, c2, reset_launches, read_launches,
                  size=(1280, 720), meshes=((4, 1), (2, 2), (7, 1)),
                  bh_mesh=(3, 1), grad_mesh=(4, 1)):
    """Phase 17: tile sharding (schwarzschild_tpu_torch.sharding).  A
    one-rank process group (NCCL on the card) and make_mesh(): the demo
    frame through make_sharded_render, "fast" (4 slots) and "jnp", each
    equal to the unsharded frame bit for bit; then, in this one process,
    the tile function at every coordinate of larger meshes, each assembled
    frame equal to the unsharded one with one march_scene launch a tile
    ((7, 1) pads 720 rows to 721); config 2's rays through march_bh tiles,
    equal to the unsharded planes; the gradient in r_s and cam.pos summed
    over the tiles of grad_mesh within rtol 1e-3 of the unsharded one, one
    adjoint launch a tile; the sharded against the unsharded frame's time
    and each tile's."""
    import functools

    import torch
    import torch.distributed as dist

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import kernel, sharding

    start = time.perf_counter()
    dev = bg.data.device
    W, H = size
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="smoke_pg_") as tmp:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = sharding.make_mesh()
            out["mesh"] = dict(shape=list(mesh.shape),
                               device_type=mesh.device_type,
                               backend=dist.get_backend())
            ref = sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=4,
                                 overflow="ignore")
            fast = sharding.make_sharded_render(mesh, cfg, "fast", 4)
            reset_launches()
            img = fast(sc, cam, bg, tex)
            out["fast_launches"] = read_launches()
            out["fast_equal"] = bool(torch.equal(img, ref))
            dense = sp.render(sc, cam, cfg, bg, tex, 1.0)
            dense_sharded = sharding.make_sharded_render(mesh, cfg, "jnp")(
                sc, cam, bg, tex)
            out["jnp_equal"] = bool(torch.equal(dense_sharded, dense))
            out["gather_image_equal"] = bool(
                (sharding.gather_image(img) == ref.cpu().numpy()).all())
            out["sharded_frame_ms"] = cuda_ms(lambda: fast(sc, cam, bg, tex))
            out["unsharded_frame_ms"] = cuda_ms(lambda: sp.render_fast(
                sc, cam, cfg, bg, tex, 1.0, n_slots=4, overflow="ignore"))
        finally:
            dist.destroy_process_group()

    tiles_out = {}
    for shape in meshes:
        tile = sharding.make_tile_render(cfg, "fast", 4, shape)
        coords = [(i, j) for i in range(shape[0]) for j in range(shape[1])]
        reset_launches()
        tiles = [tile(c, sc, cam, bg, tex) for c in coords]
        launches = read_launches()["march_scene"]
        equal = bool(torch.equal(sharding.assemble(tiles, H, W, shape), ref))
        ms = [cuda_ms(functools.partial(tile, c, sc, cam, bg, tex),
                      warmup=1, reps=3) for c in coords]
        tiles_out[str(shape)] = dict(
            tile=list(sharding.tile_size(H, W, shape)), equal=equal,
            march_scene_launches=launches, tile_ms=ms)
        require(equal, f"mesh {shape}: assembled tiles differ from the frame")
        require(launches == len(coords),
                f"mesh {shape}: {launches} march_scene launches for "
                f"{len(coords)} tiles")

    cfg2 = c2["cfg"]
    o, d, act = rays(c2["camera"], cfg2.width, cfg2.height, dev)
    planes = kernel.march_bh(o, d, act, 1.0, cfg2, events=True)
    march = functools.partial(kernel.march_bh, cfg=cfg2, events=True)
    reset_launches()
    parts = [sharding.march_tile(march, bh_mesh, (i, j), o, d, act, 1.0)
             for i in range(bh_mesh[0]) for j in range(bh_mesh[1])]
    bh_launches = read_launches()["march_bh"]

    def whole(get):
        return sharding.assemble([get(p) for p in parts], cfg2.height,
                                 cfg2.width, bh_mesh)

    bh_equal = all(torch.equal(whole(get), get(planes)) for get in (
        lambda p: p[0], lambda p: p[1], lambda p: p[2]["t_end"],
        lambda p: p[2]["died_moving"]))
    require(bh_equal, f"march_bh tiles on {bh_mesh} differ from the planes")
    require(bh_launches == bh_mesh[0] * bh_mesh[1],
            f"march_bh tiles launched {bh_launches}")

    gen = torch.Generator(device="cpu").manual_seed(7)
    w = torch.rand((H, W, 4), generator=gen).to(dev)

    def grads(render):
        pos = cam.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=dev, requires_grad=True)
        loss = render(cam._replace(pos=pos), r_s)
        return torch.autograd.grad(loss, [r_s, pos])

    ref_g = grads(lambda c, r: (sp.render_fast(
        sc, c, cfg, bg, tex, r, n_slots=4, overflow="ignore",
        differentiable=True) * w).sum())
    tile = sharding.make_tile_render(cfg, "fast", 4, grad_mesh,
                                     differentiable=True)
    coords = [(i, j) for i in range(grad_mesh[0])
              for j in range(grad_mesh[1])]
    reset_launches()
    tile_g = [grads(lambda c, r, xy=xy: (tile(xy, sc, c, bg, tex, r)
                                         * sharding.tile_of(w, H, W,
                                                            grad_mesh,
                                                            xy)).sum())
              for xy in coords]
    grad_launches = read_launches()
    summed = [sum(g[k] for g in tile_g) for k in range(2)]
    grad_ok = all(bool(torch.allclose(a, b, rtol=1e-3, atol=1e-6))
                  for a, b in zip(summed, ref_g))
    grad_ms = dict(
        frame=cuda_ms(lambda: grads(lambda c, r: (sp.render_fast(
            sc, c, cfg, bg, tex, r, n_slots=4, overflow="ignore",
            differentiable=True) * w).sum()), warmup=1, reps=3),
        tiles=[cuda_ms(lambda xy=xy: grads(lambda c, r: (
            tile(xy, sc, c, bg, tex, r)
            * sharding.tile_of(w, H, W, grad_mesh, xy)).sum()),
            warmup=1, reps=3) for xy in coords])
    log("sharded", seconds=time.perf_counter() - start, shape=[H, W], **out,
        tiles=tiles_out,
        march_bh=dict(shape=[cfg2.height, cfg2.width], mesh=list(bh_mesh),
                      equal=bh_equal, launches=bh_launches),
        gradient=dict(mesh=list(grad_mesh), summed_r_s=summed[0].item(),
                      unsharded_r_s=ref_g[0].item(),
                      summed_pos=summed[1].tolist(),
                      unsharded_pos=ref_g[1].tolist(), within_rule=grad_ok,
                      launches=grad_launches, ms=grad_ms))
    require(out["fast_equal"] and out["jnp_equal"]
            and out["gather_image_equal"],
            "a sharded frame differs from the unsharded one")
    require(out["fast_launches"]["march_scene"] == 1,
            f"sharded fast frame launched {out['fast_launches']}")
    require(grad_ok, "tile gradients do not sum to the frame's")
    require(grad_launches["march_scene_bwd"] == len(coords),
            f"tile gradients launched {grad_launches}")


def _load_example(name):
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def viewer_phase(dev, cpu, reset_launches, read_launches,
                 sizes=((1280, 720), (192, 96)), cpu_row_stride=(16, 1)):
    """Phase 18: examples/live_viewer_torch.py's own frame function
    (make_renderer) over SELFTEST_SCRIPT, played as its run_script plays
    it, at 1280x720 (the reference's window, main.cpp:25-26) and 192x96:
    every frame (H, W, 3) uint8, one march_scene launch a frame (none in
    FLAT mode), within 1 count of the CPU port's frame of the same state on
    at least 99.5% of pixels (at 1280x720 on every cpu_row_stride-th row:
    the CPU renders those rows from the frame's full-size grid, as a tile
    is rendered); the median steady frame time and the ansi_frame encode
    time."""
    import numpy as np

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs, kernel, viewer
    from schwarzschild_tpu_torch.features import calculate_test_ray

    start = time.perf_counter()
    ex = _load_example("live_viewer_torch")
    conf = dict(scene=configs.demo_scene(device=dev),
                background=configs.background_texture(device=dev),
                tex=configs.demo_texture_stack(device=dev))
    conf_cpu = dict(scene=configs.demo_scene(device=cpu),
                    background=configs.background_texture(device=cpu),
                    tex=configs.demo_texture_stack(device=cpu))
    results = []
    for (W, H), stride in zip(sizes, cpu_row_stride):
        frame = ex.make_renderer(conf, W, H, dev)
        rows = range(0, H, stride)
        state = viewer.initial_state()
        tray, on = None, False
        times, shares, launches, encode_ms = [], [], [], []
        for key in ex.SELFTEST_SCRIPT:
            reset_launches()
            t0 = time.perf_counter()
            img = frame(state)
            times.append((time.perf_counter() - t0) * 1e3)
            n = read_launches()["march_scene"]
            want = 0 if state.raytrace_type == sp.FLAT else 1
            require(img.shape == (H, W, 3) and img.dtype == np.uint8,
                    f"viewer frame {img.dtype} {img.shape}")
            require(n == want, f"viewer frame ({state.raytrace_type}): "
                    f"{n} march_scene launches, not {want}")
            launches.append(n)
            if state.test_ray and not on:
                tray = calculate_test_ray(state.cam, device=cpu)
            on = state.test_ray
            cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0,
                                  raytrace_type=state.raytrace_type,
                                  crosshair=True)
            part = kernel.take_pixels(
                kernel.grid_planes(state.cam, cfg, cpu), rows)
            want_img = sp.to_uint8(sp.render_fast(
                conf_cpu["scene"], None, cfg, conf_cpu["background"],
                conf_cpu["tex"], 1.0, overflow="ignore",
                test_ray=tray if state.test_ray else None,
                precomputed=part)).numpy()
            diff = np.abs(img[::stride].astype(np.int16) - want_img)
            shares.append(float((diff.max(-1) <= 1).mean()))
            t0 = time.perf_counter()
            viewer.ansi_frame(img, viewer.hud(state, times[-1]))
            encode_ms.append((time.perf_counter() - t0) * 1e3)
            state = viewer.advance_flyby(viewer.apply_key(state, key), 0.05)
            if state.quit:
                break
        steady = sorted(times[2:])[len(times[2:]) // 2]
        results.append(dict(size=[H, W], frames=len(times),
                            median_steady_frame_ms=steady, frame_ms=times,
                            march_scene_launches=launches,
                            cpu_rows_compared=len(rows),
                            within_1_count=shares,
                            ansi_encode_ms=statistics.median(encode_ms)))
        require(len(times) == len(ex.SELFTEST_SCRIPT),
                f"viewer played {len(times)} frames")
        require(min(shares) >= 0.995,
                f"viewer {W}x{H}: card vs CPU frames {min(shares)}")
    log("viewer", seconds=time.perf_counter() - start,
        script="".join(k[0] for k in ex.SELFTEST_SCRIPT), runs=results)


def examples_phase(reset_launches, read_launches, configs_=(1, 2, 3, 4),
                   scale=0.5, device="cuda"):
    """Phase 19: examples/render_configs_torch.py for configs 1-4 with
    --fast --scale 0.5 on the card: the PNGs written (decoded here), the
    seconds a config (its metrics.jsonl) and the launches."""
    ex = _load_example("render_configs_torch")
    with tempfile.TemporaryDirectory(prefix="smoke_configs_") as tmp:
        reset_launches()
        t0 = time.perf_counter()
        written = ex.main(["--config", ",".join(map(str, configs_)),
                           "--fast", "--scale", str(scale), "--out", tmp,
                           "--device", device])
        wall = time.perf_counter() - t0
        launches = read_launches()
        records = [json.loads(line) for line in
                   (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
        seconds = {str(r.get("config", 4)): r["seconds"] for r in records
                   if r["event"] in ("config_done", "config4_done")}
        pngs = {str(n): [[p.name, list(read_png(p).shape)] for p in paths]
                for n, paths in written.items()}
    log("examples", configs=list(configs_), scale=scale, pngs=pngs,
        seconds=seconds, wall_seconds=wall, launches=launches)
    require(all(len(pngs[str(n)]) == (8 if n == 4 else 1)
                for n in configs_),
            f"render_configs wrote {pngs}")
    require(launches["march_scene"] >= 1,
            f"render_configs launched {launches}")


def count_syncs(fn):
    """Host synchronizations in one call of ``fn`` (after a warm-up call):
    the warnings that torch.cuda.set_sync_debug_mode("warn") raises, one
    for each synchronizing CUDA call."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def in_turns(fns, rounds=4):
    """{name: [cuda_ms, ...]} of each function of ``fns`` (a dict), timed
    in turns (A, B, then B, A, ...): the host's noise drifts within a
    call, so two paths compare only side by side."""
    order = list(fns)
    times = {name: [] for name in order}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(cuda_ms(fns[name]))
    return times


def atlas_phase(sc, cam, bg, tex, c2, reset_launches, read_launches,
                size=(1280, 720), bh_size=512,
                small=dict(lane=(512, 128), tile=(256, 128))):
    """Phase 20 (see the module's docstring): the fetch atlas, the
    composition's compacted levels, the lane- and tile-sparse frames, the
    compacted marches, bfloat16 textures and the atlas gradient frames on
    the card, each checked and timed."""
    import torch

    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs, kernel, kernel_scene, noise
    from schwarzschild_tpu_torch import textures

    t_phase = time.perf_counter()
    W, H = size
    dev = bg.data.device
    cpu = torch.device("cpu")
    gen = torch.Generator(device="cpu").manual_seed(0)

    # The atlas: build time and bytes, and one fetch a lane against the
    # two samplers it replaces, at W x H lanes of mixed layers.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    atlas = textures.build_atlas(bg, tex)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    nbytes = textures.atlas_nbytes(bg, tex)
    require(nbytes == atlas.data.numel() * atlas.data.element_size(),
            "atlas_nbytes differs from the atlas built")
    n = W * H
    u = torch.rand(n, generator=gen).to(dev)
    v = torch.rand(n, generator=gen).to(dev)
    layer = torch.randint(0, tex.data.shape[0] + 1, (n,),
                          generator=gen).to(dev)

    def fetch():
        return textures.atlas_fetch(atlas, layer, u, v)

    def samplers():
        return (textures.sample_stack(tex, layer - 1, u, v),
                textures.sample_texture(bg, u, v))

    st_, bg_ = samplers()
    require(torch.equal(fetch(), torch.where((layer == 0)[:, None], bg_,
                                             st_)),
            "atlas_fetch differs from sample_texture/sample_stack")
    fetch_prof = profile_device(fetch, host=False)
    samplers_prof = profile_device(samplers, host=False)
    log("atlas", bytes=nbytes, build_ms=build_ms, lanes=n,
        layers=int(atlas.wrap.shape[0]), fetch_equals_samplers=True,
        atlas_fetch_ms=cuda_ms(fetch), atlas_fetch_device_ms=fetch_prof,
        samplers_ms=cuda_ms(samplers),
        sample_stack_and_sample_texture_device_ms=samplers_prof)

    # The demo frame through the atlas levels: compacted ("auto", per-pass
    # capacities) and full-frame levels bit-equal on the card.
    cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0)
    frames = {name: sp.render_fast(sc, cam, cfg, bg, tex, 1.0,
                                   compact_slots=value)
              for name, value in (("auto", "auto"), ("none", None),
                                  ("capacities", (None, 16, 16, 16)))}
    require(all(torch.equal(f, frames["none"]) for f in frames.values()),
            "compacted levels differ from full-frame levels on the card")
    tri_cfg = sp.RenderConfig(width=W, height=H, percent_black=-1.0,
                              texture_filter="trilinear")

    def frame(c, **kw):
        return lambda: sp.render_fast(sc, cam, c, bg, tex, 1.0, **kw)

    log("atlas_frames", shape=[H, W], bit_equal=True,
        ms_in_turns=in_turns(dict(
            auto=frame(cfg), none=frame(cfg, compact_slots=None),
            trilinear_per_slot_loop=frame(tri_cfg))),
        syncs=dict(auto=count_syncs(frame(cfg)),
                   none=count_syncs(frame(cfg, compact_slots=None)),
                   trilinear_per_slot_loop=count_syncs(frame(tri_cfg))),
        profiled_auto=profile_device(frame(cfg)),
        profiled_none=profile_device(frame(cfg, compact_slots=None)))

    # The reference's default (percent_black 0.75, hash noise) through the
    # lane-sparse branch, and tile noise (16, 128) through the tile-sparse
    # one: each within 1e-6 of its compact_slots=None frame, one launch.
    sparse = {}
    for kind, extra in (("lane", dict(noise_mode="hash")),
                        ("tile", dict(noise_mode="tile",
                                      noise_tile=(16, 128)))):
        scfg = sp.RenderConfig(width=W, height=H, percent_black=0.75, **extra)
        reset_launches()
        img = frame(scfg)()
        launches = read_launches()
        full = frame(scfg, compact_slots=None)()
        err = (img - full).abs().max().item()
        require(err <= 1e-6, f"{kind}-sparse frame vs full: {err}")
        require(launches["march_scene"] == 1,
                f"{kind}-sparse frame launches {launches}")
        w_, h_ = small[kind]
        c_small = sp.RenderConfig(width=w_, height=h_, percent_black=0.75,
                                  **extra)
        share = within(frame(c_small)(), sp.render_fast(
            configs.demo_scene(device=cpu), configs.demo_camera(device=cpu),
            c_small, configs.background_texture(device=cpu),
            configs.demo_texture_stack(device=cpu), 1.0))
        require(share >= 0.995, f"{kind}-sparse {w_}x{h_} vs CPU {share}")
        sparse[kind] = dict(
            max_abs_err_vs_full=err, launches=launches,
            ms_in_turns=in_turns(dict(
                sparse=frame(scfg), full_frame=frame(scfg,
                                                     compact_slots=None))),
            device=profile_device(frame(scfg)),
            full_frame_device=profile_device(frame(scfg, compact_slots=None)),
            syncs=count_syncs(frame(scfg)),
            full_frame_syncs=count_syncs(frame(scfg, compact_slots=None)),
            vs_cpu=dict(shape=[h_, w_], within_2e_3=share))
    log("sparse_frames", shape=[H, W], percent_black=0.75, **sparse)

    # The compacted marches on the same 0.75 hash mask: bit-equal on every
    # active ray, one launch a call, device time beside the unpacked one.
    def compact_check(name, run, mask):
        a = run(False)
        b = run(True)
        leaves_a, leaves_b = [], []
        for out, leaves in ((a, leaves_a), (b, leaves_b)):
            stack = [out]
            while stack:
                x = stack.pop()
                if isinstance(x, (list, tuple)):
                    stack.extend(x)
                else:
                    leaves.append(x)
        equal = all(torch.equal(x[mask], y[mask]) for x, y in
                    zip(leaves_a, leaves_b))
        require(equal, f"{name}(compact=True) differs on active rays")
        kname = f"{name}_kernel"
        return dict(bit_equal_on_active=equal,
                    active_share=mask.float().mean().item(),
                    device_ms=device_ms(lambda: run(False), kname),
                    compact_device_ms=device_ms(lambda: run(True), kname),
                    ms=cuda_ms(lambda: run(False)),
                    compact_ms=cuda_ms(lambda: run(True)))

    o, d, act = rays(cam, W, H, dev)
    mask = act & (noise.pixel_hash_rand(W, H, 0, device=dev) > 0.75)
    scene = compact_check("march_scene", lambda c: kernel_scene.march_scene(
        o, d, mask, 1.0, sc, cfg, 4, tex, compact=c), mask)
    o2, d2, act2 = rays(c2["camera"], bh_size, bh_size, dev)
    mask2 = act2 & (noise.pixel_hash_rand(bh_size, bh_size, 0, device=dev)
                    > 0.75)
    bh = compact_check("march_bh", lambda c: kernel.march_bh(
        o2, d2, mask2, 1.0, c2["cfg"], compact=c), mask2)
    reset_launches()
    kernel_scene.march_scene(o, d, mask, 1.0, sc, cfg, 4, tex, compact=True)
    kernel.march_bh(o2, d2, mask2, 1.0, c2["cfg"], compact=True)
    compact_launches = read_launches()
    require(compact_launches["march_scene"] == 1
            and compact_launches["march_bh"] == 1,
            f"compacted marches launched {compact_launches}")
    log("compact_march", march_scene=dict(shape=[H, W], **scene),
        march_bh=dict(shape=[bh_size, bh_size], **bh),
        launches=compact_launches)

    # bfloat16 texels against float32 ones.
    bg16, tex16 = sp.with_dtype(bg), sp.stack_with_dtype(tex)
    f16 = sp.render_fast(sc, cam, cfg, bg16, tex16, 1.0)
    share16 = ((f16 - frames["auto"]).abs() < 1 / 255).float().mean().item()
    require(share16 > 0.98, f"bf16 frame within a count on {share16}")
    log("bf16_frame", shape=[H, W], within_one_count=share16,
        ms=cuda_ms(lambda: sp.render_fast(sc, cam, cfg, bg16, tex16, 1.0)),
        atlas_bytes_bf16=textures.atlas_nbytes(bg, tex, torch.bfloat16))

    # The gradient frame through the atlas: frozen texels (r_s, cam.pos),
    # then the background's texels too (a differentiable atlas).
    w = torch.rand((H, W, 4), generator=gen).to(dev)

    def grad(cfg_, w_, scene, camera, back, stack, texels):
        pos = camera.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=w_.device, requires_grad=True)
        if texels:
            back = sp.Texture(back.data.clone().requires_grad_(True))
        img = sp.render_fast(scene, camera._replace(pos=pos), cfg_, back,
                             stack, r_s, overflow="ignore",
                             differentiable=True)
        wrt = [r_s, pos] + ([back.data] if texels else [])
        return torch.autograd.grad((img * w_).sum(), wrt)

    small_cfg = sp.RenderConfig(width=64, height=36, percent_black=-1.0)
    ws = torch.rand((36, 64, 4), generator=gen)
    grads = {}
    for texels in (False, True):
        key = "texels" if texels else "frozen"
        reset_launches()
        g, peak = peak_bytes(lambda: grad(cfg, w, sc, cam, bg, tex, texels))
        launches = read_launches()
        require(all(bool(torch.isfinite(x).all()) for x in g),
                f"non-finite {key} gradient")
        require(launches["march_scene_bwd"] == 1, f"{key} launches {launches}")
        gg = grad(small_cfg, ws.to(dev), sc, cam, bg, tex, texels)
        gc = grad(small_cfg, ws, configs.demo_scene(device=cpu),
                  configs.demo_camera(device=cpu),
                  configs.background_texture(device=cpu),
                  configs.demo_texture_stack(device=cpu), texels)
        ok = [grads_close(a, b) for a, b in zip(gg, gc)]
        require(all(ok), f"{key} gradients vs CPU {ok}")
        grads[key] = dict(peak_bytes=peak, launches=launches,
                          vs_cpu_64x36=ok, grad_r_s=g[0].item())
    log("atlas_gradient_frames", shape=[H, W], **grads,
        ms_in_turns=in_turns({key: (lambda t=t: grad(cfg, w, sc, cam, bg,
                                                      tex, t))
                              for key, t in (("frozen", False),
                                             ("texels", True))}),
        seconds=time.perf_counter() - t_phase)


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
    t_start = time.perf_counter()
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
    share, err, agree, same = agreement(dict(status=k[1], fdir=k[0]),
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
        fdir_max_abs_err=err, within_tol=agree, events_equal=events_equal,
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
    require(agree >= 0.999, f"march_bh fdir agreement {agree}")
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
    share, err, agree, same = agreement(scene_planes(kout),
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
        status_nhits_agree=share, max_abs_err=err, within_tol=agree,
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
    require(agree >= 0.999, f"march_scene float agreement {agree}")
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
    share_img = within(gpu_img, cpu_img)
    share_sky = within(gpu_sky, cpu_sky)
    log("frames_vs_cpu", render_fast_320x180=share_img,
        render_horizon_sky_128=share_sky)
    require(share_img >= 0.995, f"render_fast vs CPU {share_img}")
    require(share_sky >= 0.995, f"render_horizon_sky vs CPU {share_sky}")

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

    grads_ok = dict(render_fast_r_s=grads_close(gg[0], gc[0]),
                    render_fast_pos=grads_close(gg[1], gc[1]),
                    render_horizon_sky_r_s=grads_close(hg[0], hc[0]),
                    render_horizon_sky_pos=grads_close(hg[1], hc[1]))
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
    clock = FitClock()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, history = inverse.fit(
        c5["scene"], c5["cfg"], c5["background"], c5["tex"], 5, target,
        c5["camera"], r_s0=0.7, n_steps=5, log_every=1, log_fn=clock,
        renderer="fast")
    inverse_launches = read_launches()
    step_ms = clock.step_ms(t0)
    warnings = clock.warnings()
    r_s_fit = float(torch.logaddexp(params.r_s_raw, torch.zeros_like(
        params.r_s_raw)))
    optimizer = inverse.default_optimizer()
    step = inverse.make_train_step(inverse.make_loss(
        c5["scene"], c5["cfg"], c5["background"], c5["tex"], 5, target,
        renderer="fast"), optimizer)
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

    # 9-12. the dense renderer and its users, counters reset around each
    dense_phase(sc, cam, bg, tex, reset_launches, read_launches)
    dense_grad_phase(c5, target, c2, reset_launches, read_launches)
    tubes_phase(sc, cam, bg, tex, reset_launches, read_launches)
    cem_phase(c5, reset_launches, read_launches)

    # 13-16. trilinear frames, prng noise, the oracle, profiling
    trilinear_phase(sc, cam, bg, tex, c2, reset_launches, read_launches)
    prng_phase(sc, cam, bg, tex, reset_launches, read_launches)
    oracle_phase(c2)
    profiling_phase(c2)

    # 17-19. tile sharding, the live viewer, the config script
    sharded_phase(sc, cam, bg, tex, c2, reset_launches, read_launches)
    viewer_phase(dev, cpu, reset_launches, read_launches)
    examples_phase(reset_launches, read_launches)

    # 20. the fetch atlas, compacted levels, sparse frames, compacted
    # marches, bfloat16 textures, the atlas gradient frames
    atlas_phase(sc, cam, bg, tex, c2, reset_launches, read_launches)

    log("total", seconds=time.perf_counter() - t_start)
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
