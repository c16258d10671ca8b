"""Time the march kernels (and the dense frame) of two or more checkouts
of this repository in turns on one CUDA card.

    python3 tools/ab_march.py PATH_A PATH_B [PATH_C ...] [--pairs N]
                              [--kernels scene,bwd,bh,dense,frames]

N rounds (default 5); each round runs every checkout once, in the given
order in even rounds and in reverse in odd ones (A, B, then B, A for two).
Each run imports one checkout's schwarzschild_tpu_torch in a subprocess of
its own (the packages share a name), builds its kernels from its own
csrc/, and times each kernel's device time (``*_device_ms``: torch.profiler,
the median of 20 launches after 3 warm-up calls; null where the
profiler lost the launches) and its wrapper's whole
call (``*_ms``, host work included: CUDA-event medians of 20 calls):
  * march_scene on the demo scene at 1280x720 (4 slots, opaque stop on),
    and where a checkout has the choice (SHARED_TABLE_WORDS), the same with
    the tables read from device memory, the route of a large scene;
  * march_scene_bwd at 1280x720 on the events of the plain forward march
    (the same in every checkout) and cotangents from a seeded CPU
    generator, so every checkout gets the same inputs;
  * march_bh on config-2 rays at 512x512, with ptxas's registers and
    spills for it where the run built the library, and the resident blocks
    an SM where a checkout can say (march_bh_blocks_per_sm);
  * the host work of packing the demo scene's tables, which each
    march_scene call does before its launch (``pack_scene_tables_host_ms``,
    host clock, the median of 20 after 3);
  * with ``dense``, where a checkout has the dense renderer
    (``render.render``), its demo frame at 1280x720, 100 steps, forward
    only: the CUDA-event median of 5 frames after 1 and the device time
    of one frame (torch.profiler), as chip_smoke.py's dense phase.
  * with ``frames``, the frames a user waits for, each through the
    checkout's default path: the demo's render_fast at 1280x720 (CUDA-event
    median of 10 after 2, device time, kernels and host synchronizations
    of one frame), the same at the reference's default noise
    (percent_black 0.75, hash), its gradient in r_s, cam.pos and the background's
    texels (median of 5 after 1, peak memory), one config-4 flyby frame
    (1920x1080, split screen, uint8 on the card; trajectory time 0.5) and
    one config-5 "fast" training step (128x128, the disk texels free).
``--kernels`` names the ones to time (default scene, bwd, bh; the
packing goes with scene).
The rays, the timing and the card line are this repository's
chip_smoke.py's, whichever checkout is timed.  It prints one JSON line per
run, one per checkout with each time's median and quartile spread over the
rounds, then the card's name and power limit.  Versions compare only
inside one such call: cards and hosts differ from call to call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

RUN = r"""
import importlib, importlib.util, json, os, statistics, time, torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              os.environ["AB_CHIP_SMOKE"])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu_torch import _ext, configs, kernel, kernel_scene

only = os.environ["AB_KERNELS"].split(",")
built = _ext.build()
res = {}
dev = torch.device("cuda", 0)
cfg = sp.RenderConfig(width=1280, height=720, percent_black=-1.0)
if any(k in only for k in ("scene", "bwd", "dense", "frames")):
    cam = configs.demo_camera(device=dev)
    sc = configs.demo_scene(device=dev)
    tex = configs.demo_texture_stack(device=dev)
    o, d, act = smoke.rays(cam, 1280, 720, dev)
if "scene" in only:
    scene = lambda: kernel_scene.march_scene(o, d, act, 1.0, sc, cfg, 4, tex)
    res["march_scene_1280x720_device_ms"] = smoke.device_ms(
        scene, "march_scene_kernel")
    tables_dev = None  # the tables from device memory, where a checkout can
    if hasattr(kernel_scene, "SHARED_TABLE_WORDS"):
        shared = kernel_scene.SHARED_TABLE_WORDS
        kernel_scene.SHARED_TABLE_WORDS = 0
        tables_dev = smoke.device_ms(scene, "march_scene_kernel")
        kernel_scene.SHARED_TABLE_WORDS = shared
    res["march_scene_tables_in_device_memory_1280x720_device_ms"] = tables_dev
    pack = []
    for _ in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel_scene._pack_scene_smem(sc, tex)
        pack.append((time.perf_counter() - t0) * 1e3)
    res["pack_scene_tables_host_ms"] = statistics.median(pack[3:])
    res["march_scene_1280x720_ms"] = smoke.cuda_ms(scene, warmup=3, reps=20)
if "bwd" in only:
    fwd = kernel_scene.march_scene_torch(o, d, act, 1.0, sc, cfg, 4, tex,
                                         events=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    cts = (rnd(720, 1280, 3), rnd(720, 1280, 3),
           [(rnd(720, 1280, 3), rnd(720, 1280, 3), rnd(720, 1280))
            for _ in range(4)])
    bwd = lambda: kernel_scene.march_scene_bwd(o, d, 1.0, cfg, cts, fwd[2],
                                               fwd[5], 4)
    res["march_scene_bwd_1280x720_device_ms"] = smoke.device_ms(
        bwd, "march_scene_bwd_kernel")
    res["march_scene_bwd_1280x720_ms"] = smoke.cuda_ms(bwd, warmup=3,
                                                       reps=20)
if "bh" in only:
    c2 = configs.config2_curved(device=dev)
    o2, d2, act2 = smoke.rays(c2["camera"], 512, 512, dev)
    bh = lambda: kernel.march_bh(o2, d2, act2, 1.0, c2["cfg"])
    res["march_bh_512_device_ms"] = smoke.device_ms(bh, "march_bh_kernel")
    res["march_bh_512_ms"] = smoke.cuda_ms(bh, warmup=3, reps=20)
    ptxas = {k: v for k, v in smoke.ptxas_report(built.log).items()
             if k.startswith("march_bh")}
    if ptxas:
        res["march_bh_ptxas"] = ptxas
    lib = _ext.library()
    if hasattr(lib, "march_bh_blocks_per_sm"):
        res["march_bh_blocks_per_sm"] = lib.march_bh_blocks_per_sm(0)
if "dense" in only:
    render = importlib.import_module("schwarzschild_tpu_torch.render")
    if hasattr(render, "render"):
        bg = configs.background_texture(device=dev)

        def dense():
            with torch.no_grad():
                return render.render(sc, cam, cfg, bg, tex, 1.0)

        res["dense_1280x720_ms"] = smoke.cuda_ms(dense, warmup=1, reps=5)
        res["dense_1280x720_device_ms"] = smoke.profile_device(
            dense, host=False)["device_ms"]
if "frames" in only:
    from schwarzschild_tpu_torch import camera, inverse
    render = importlib.import_module("schwarzschild_tpu_torch.render")
    bg = configs.background_texture(device=dev)
    frame = lambda: sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=4)
    res["frame_1280x720_ms"] = smoke.cuda_ms(frame)
    prof = smoke.profile_device(frame)
    res["frame_1280x720_device_ms"] = prof["device_ms"]
    res["frame_1280x720_kernels"] = prof.get("kernels")
    res["frame_1280x720_syncs"] = smoke.count_syncs(frame)
    ref_cfg = sp.RenderConfig(width=1280, height=720, percent_black=0.75,
                              noise_mode="hash")
    ref = lambda: sp.render_fast(sc, cam, ref_cfg, bg, tex, 1.0, n_slots=4)
    res["ref_default_1280x720_ms"] = smoke.cuda_ms(ref)
    prof = smoke.profile_device(ref)
    res["ref_default_1280x720_device_ms"] = prof["device_ms"]
    res["ref_default_1280x720_kernels"] = prof.get("kernels")
    res["ref_default_1280x720_syncs"] = smoke.count_syncs(ref)
    w = torch.rand((720, 1280, 4),
                   generator=torch.Generator().manual_seed(0)).to(dev)

    def grad():
        pos = cam.pos.clone().requires_grad_(True)
        r_s = torch.tensor(1.0, device=dev, requires_grad=True)
        bg_d = bg.data.clone().requires_grad_(True)
        img = sp.render_fast(sc, cam._replace(pos=pos), cfg,
                             sp.Texture(bg_d), tex, r_s, overflow="ignore",
                             differentiable=True)
        return torch.autograd.grad((img * w).sum(), [r_s, pos, bg_d])

    res["grad_1280x720_ms"] = smoke.cuda_ms(grad, warmup=1, reps=5)
    res["grad_1280x720_peak_bytes"] = float(smoke.peak_bytes(grad)[1])
    c4 = configs.config4_animation(n_frames=2, device=dev)
    cam4 = camera.hyperbolic_trajectory(
        camera.make_camera((0.0, 2.0, 15.0), device=dev), time=0.5,
        **c4["trajectory"])
    fly = lambda: render.to_uint8(sp.render_fast(
        c4["scene"], cam4, c4["cfg"], c4["background"], c4["tex"], 1.0,
        overflow="ignore"))
    res["flyby_frame_1920x1080_ms"] = smoke.cuda_ms(fly, warmup=1, reps=5)
    c5 = configs.config5_inverse(device=dev)
    target = sp.render_fast(c5["scene"], c5["camera"], c5["cfg"],
                            c5["background"], c5["tex"], 1.0,
                            overflow="ignore")
    opt = inverse.default_optimizer()
    params = inverse.init_params(c5["camera"], 0.7, c5["tex"], 5)
    state = opt.init(params)
    step = inverse.make_train_step(inverse.make_loss(
        c5["scene"], c5["cfg"], c5["background"], c5["tex"], 5, target,
        renderer="fast"), opt)
    res["config5_fast_step_ms"] = smoke.cuda_ms(lambda: step(params, state),
                                                warmup=1, reps=5)
print(json.dumps(res))
"""


def run(path, kernels):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(path),
               AB_CHIP_SMOKE=str(ROOT / "chip_smoke.py"),
               AB_KERNELS=kernels)
    out = subprocess.run([sys.executable, "-c", RUN], cwd=path, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{path}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def summary(times):
    """Median and quartile spread (Q3 - Q1) of a list of times; a run whose
    device time the profiler lost (None) is left out and counted."""
    got = [t for t in times if t is not None]
    if not got:
        return dict(median=None, quartile_spread=None, runs=times)
    q1, _, q3 = (statistics.quantiles(got, n=4, method="inclusive")
                 if len(got) > 1 else got * 3)
    return dict(median=statistics.median(got), quartile_spread=q3 - q1,
                runs=times, lost=len(times) - len(got))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--kernels", default="scene,bwd,bh")
    args = ap.parse_args()
    if len(args.paths) < 2:
        ap.error("give at least two checkouts")
    times = {p: {} for p in args.paths}
    for k in range(args.pairs):
        order = args.paths if k % 2 == 0 else args.paths[::-1]
        for path in order:
            res = run(path, args.kernels)
            print(json.dumps({"pair": k, "path": path, **res}), flush=True)
            for key, ms in res.items():
                if isinstance(ms, (float, type(None))):
                    times[path].setdefault(key, []).append(ms)
    for path, by_key in times.items():
        print(json.dumps({"path": path, **{
            key: summary(ms) for key, ms in by_key.items()}}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
