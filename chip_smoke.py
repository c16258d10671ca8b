"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises, so the exit code is not
0):
  0. device: the card's name and power limit (nvidia-smi);
  1. build: nvcc compiles schwarzschild_tpu_torch/csrc/*.cu for sm_90a;
  2. march_bh: the kernel against its plain version on config-2 rays at
     512x512 (status agreement, fdir error, kernel and plain ms);
  3. march_scene: the same on demo-scene rays at 1280x720 with 4 slots
     (status, nhits, fdir, fpos, slot planes);
  4. frames: render_fast (demo scene, 1280x720, 4 slots) and
     render_horizon_sky (config 2, 512x512) with the launch counters reset
     just before and read just after, then their times, then small frames
     rendered on the card against the same frames rendered on the CPU (the
     plain versions).
Then one JSON line of per-kernel results, the card line again, and as the
last line {"ok": true, "device": {...}}.

Tolerances: a kernel must agree with its plain version on the status of at
least 99.9% of lanes; among agreeing lanes at least 99.9% must have every
float output within 1e-3 relative to 1 + |plain| (the march is chaotic near
the photon sphere, so a lane can drift without changing its fate).  A frame
on the card must match the CPU frame within 2e-3 on at least 99.5% of
pixels.  Times are CUDA-event medians of 10 runs after 2 warm-up runs.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


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


def agreement(kernel_out, plain_out):
    """(status share, max abs error and in-tolerance share of the float
    outputs over status-agreeing lanes)."""
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
    return share, max_err, within


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import _ext, configs
    from schwarzschild_tpu_torch import camera as cam_mod
    from schwarzschild_tpu_torch import geometry as geo
    from schwarzschild_tpu_torch import kernel, kernel_scene, physics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 0. device
    card = card_line()
    log("device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # 1. build
    t0 = time.perf_counter()
    built = _ext.build()
    _ext.library()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(built.seconds, 3), compiled=built.built,
        flags=" ".join(_ext.NVCC_FLAGS), sources="schwarzschild_tpu_torch/csrc",
        library=built.path.name, ptxas=ptxas)

    results = {}

    def rays(cam, W, H):
        u, v = cam_mod.pixel_grid(W, H, device=dev)
        o, d = cam_mod.generate_rays(cam, u, v, W, H)
        active = ~physics.is_radial(d, geo.safe_normalize(o))
        return o, d, active

    # 2. march_bh on config-2 rays at 512x512
    c2 = configs.config2_curved(device=dev)
    cfg2 = c2["cfg"]
    o, d, act = rays(c2["camera"], cfg2.width, cfg2.height)
    k = kernel.march_bh(o, d, act, 1.0, cfg2)
    p = kernel.march_bh_torch(o, d, act, 1.0, cfg2)
    torch.cuda.synchronize()
    share, err, within = agreement(dict(status=k[1], fdir=k[0]),
                                   dict(status=p[1], fdir=p[0]))
    ms = cuda_ms(lambda: kernel.march_bh(o, d, act, 1.0, cfg2))
    plain_ms = cuda_ms(lambda: kernel.march_bh_torch(o, d, act, 1.0, cfg2))
    results["march_bh"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log("march_bh", shape=[cfg2.height, cfg2.width], status_agree=share,
        fdir_max_abs_err=err, within_tol=within, ms=ms, plain_ms=plain_ms,
        captured=int((k[1] == 1.0).sum()))
    require(share >= 0.999, f"march_bh status agreement {share}")
    require(within >= 0.999, f"march_bh fdir agreement {within}")

    # 3. march_scene on demo-scene rays at 1280x720, 4 slots
    sc = configs.demo_scene(device=dev)
    cam = configs.demo_camera(device=dev)
    bg = configs.background_texture(device=dev)
    tex = configs.demo_texture_stack(device=dev)
    cfg = sp.RenderConfig(width=1280, height=720, percent_black=-1.0)
    o, d, act = rays(cam, cfg.width, cfg.height)

    def flat(out):
        fdir, fpos, status, slots, nhits = out
        res = dict(fdir=fdir, fpos=fpos, status=status, nhits=nhits)
        for i, (s0, d0, l0) in enumerate(slots):
            res.update({f"slot{i}.start": s0, f"slot{i}.dir": d0,
                        f"slot{i}.len": l0})
        return res

    k = flat(kernel_scene.march_scene(o, d, act, 1.0, sc, cfg, 4, tex))
    p = flat(kernel_scene.march_scene_torch(o, d, act, 1.0, sc, cfg, 4, tex))
    torch.cuda.synchronize()
    share, err, within = agreement(k, p)
    ms = cuda_ms(lambda: kernel_scene.march_scene(o, d, act, 1.0, sc, cfg, 4,
                                                  tex))
    plain_ms = cuda_ms(lambda: kernel_scene.march_scene_torch(
        o, d, act, 1.0, sc, cfg, 4, tex))
    results["march_scene"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    counts = {str(c): int((k["status"] == c).sum()) for c in range(5)}
    log("march_scene", shape=[cfg.height, cfg.width], n_slots=4,
        status_nhits_agree=share, max_abs_err=err, within_tol=within, ms=ms,
        plain_ms=plain_ms, status_counts=counts,
        max_nhits=int(k["nhits"].max()))
    require(share >= 0.999, f"march_scene status/nhits agreement {share}")
    require(within >= 0.999, f"march_scene float agreement {within}")

    # 4. frames: the main path, with the launch counters reset around it
    kernel.march_bh.launches = 0
    kernel_scene.march_scene.launches = 0
    img = sp.render_fast(sc, cam, cfg, bg, tex, 1.0, n_slots=4)
    sky = sp.render_horizon_sky(c2["camera"], cfg2, c2["background"], 1.0)
    torch.cuda.synchronize()
    launches = {"march_bh": kernel.march_bh.launches,
                "march_scene": kernel_scene.march_scene.launches}
    require(img.shape == (720, 1280, 4) and bool(torch.isfinite(img).all()),
            "render_fast frame not finite or misshapen")
    require(sky.shape == (512, 512, 4) and bool(torch.isfinite(sky).all()),
            "render_horizon_sky frame not finite or misshapen")
    require(launches["march_scene"] >= 1, "render_fast launched no kernel")
    require(launches["march_bh"] >= 1,
            "render_horizon_sky launched no kernel")
    frame_ms = cuda_ms(lambda: sp.render_fast(sc, cam, cfg, bg, tex, 1.0,
                                              n_slots=4))
    sky_ms = cuda_ms(lambda: sp.render_horizon_sky(c2["camera"], cfg2,
                                                   c2["background"], 1.0))
    log("frames", launches=launches, render_fast_1280x720_ms=frame_ms,
        render_horizon_sky_512_ms=sky_ms,
        mean_rgb=[round(x, 6) for x in img[..., :3].mean((0, 1)).tolist()])

    small = sp.RenderConfig(width=320, height=180, percent_black=-1.0)
    gpu_img = sp.render_fast(sc, cam, small, bg, tex, 1.0).cpu()
    cpu_img = sp.render_fast(configs.demo_scene(), configs.demo_camera(),
                             small, configs.background_texture(),
                             configs.demo_texture_stack(), 1.0)
    sky_small = sp.RenderConfig(width=128, height=128, percent_black=-1.0)
    gpu_sky = sp.render_horizon_sky(c2["camera"], sky_small,
                                    c2["background"], 1.0).cpu()
    cpu_sky = sp.render_horizon_sky(configs.demo_camera(), sky_small,
                                    configs.background_texture(), 1.0)
    share_img = ((gpu_img - cpu_img).abs().amax(-1) < 2e-3).float().mean()
    share_sky = ((gpu_sky - cpu_sky).abs().amax(-1) < 2e-3).float().mean()
    log("frames_vs_cpu", render_fast_320x180=share_img.item(),
        render_horizon_sky_128=share_sky.item())
    require(share_img.item() >= 0.995, f"render_fast vs CPU {share_img}")
    require(share_sky.item() >= 0.995, f"render_horizon_sky vs CPU {share_sky}")

    src = "schwarzschild_tpu_torch/csrc/march.cu"
    kernels = [
        dict(name="march_bh", route="cuda", source=src,
             replaces="schwarzschild_tpu/kernel.py:252",
             launches=launches["march_bh"], **results["march_bh"]),
        dict(name="march_scene", route="cuda", source=src,
             replaces="schwarzschild_tpu/kernel_scene.py:961",
             launches=launches["march_scene"], **results["march_scene"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
