"""Render the five BASELINE configs to PNG files with the PyTorch port.

    python examples/render_configs_torch.py --config 2 --out out/
    python examples/render_configs_torch.py --config all --scale 0.25
    python examples/render_configs_torch.py --config 1,2,3,4 --fast \\
        --device cpu --scale 0.1

--scale shrinks resolutions for quick smoke runs; --fast renders configs
1, 3 and 4 with ``render_fast`` (the scene-march kernel on the card)
instead of the dense renderer; --device picks the card (default) or the
CPU, where the kernels' plain versions run.  Imports only the port.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import schwarzschild_tpu_torch as sp  # noqa: E402
from schwarzschild_tpu_torch import configs  # noqa: E402
from schwarzschild_tpu_torch.animation import render_trajectory  # noqa: E402
from schwarzschild_tpu_torch.kernel_scene import render_fast  # noqa: E402
from schwarzschild_tpu_torch.metrics import MetricsLogger  # noqa: E402


def scaled(cfg: sp.RenderConfig, scale: float) -> sp.RenderConfig:
    return dataclasses.replace(
        cfg, width=max(16, int(cfg.width * scale)),
        height=max(16, int(cfg.height * scale)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_config(n: int, out: Path, scale: float, fast: bool, logger,
               device="cuda"):
    """Render config ``n`` into ``out``; returns the PNG paths written."""
    device = torch.device(device)
    if n == 1:
        c = configs.config1_flat(device=device)
    elif n == 2:
        c = configs.config2_curved(device=device)
    elif n == 3:
        c = configs.config3_full_scene(device=device)
    elif n == 4:
        c = configs.config4_animation(n_frames=8, device=device)
        cfg = scaled(c["cfg"], scale)
        t0 = time.time()
        frames = render_trajectory(
            c["scene"], cfg, c["background"], c["tex"], times=c["times"],
            initial_distance=c["trajectory"]["initial_distance"],
            closest_distance=c["trajectory"]["closest_distance"],
            out_dir=str(out / "config4"), logger=logger,
            all_frames_local=True, renderer="fast" if fast else "jnp")
        logger.log("config4_done", seconds=time.time() - t0,
                   n_frames=len(frames))
        print(f"config 4: {len(frames)} frames in {out / 'config4'} "
              f"({time.time() - t0:.1f}s)")
        return [Path(p) for _, p in frames]
    elif n == 5:
        from schwarzschild_tpu_torch import inverse

        c = configs.config5_inverse(device=device)
        cfg = dataclasses.replace(scaled(c["cfg"], scale),
                                  horizon_softness=0.15)
        target = sp.render(c["scene"], c["camera"], cfg, c["background"],
                           c["tex"], r_s=1.0)
        t0 = time.time()
        params, history = inverse.fit(
            c["scene"], cfg, c["background"], c["tex"], 5, target,
            c["camera"], r_s0=0.7, n_steps=60, learning_rate=2e-2,
            checkpoint_dir=str(out / "config5_ckpt"), log_every=10)
        r_s = float(inverse._softplus(params.r_s_raw))
        logger.log("config5_done", seconds=time.time() - t0,
                   recovered_r_s=r_s, final_loss=history[-1])
        print(f"config 5: recovered r_s = {r_s:.4f}")
        return []
    else:
        raise ValueError(n)

    cfg = scaled(c["cfg"], scale)
    t0 = time.time()
    if fast and c["tex"] is not None:
        img = render_fast(c["scene"], c["camera"], cfg, c["background"],
                          c["tex"], 1.0)
    else:
        img = sp.render(c["scene"], c["camera"], cfg, c["background"],
                        c["tex"], 1.0)
    _sync(device)
    path = out / f"config{n}.png"
    sp.save_png(img, path)
    logger.log("config_done", config=n, seconds=time.time() - t0,
               path=str(path))
    print(f"config {n}: {path} ({time.time() - t0:.1f}s)")
    return [path]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="all")
    ap.add_argument("--out", default="out")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(out / "metrics.jsonl")

    which = (range(1, 6) if args.config == "all"
             else [int(x) for x in args.config.split(",")])
    written = {}
    for n in which:
        written[n] = run_config(n, out, args.scale, args.fast, logger,
                                args.device)
    return written


if __name__ == "__main__":
    main()
