"""Live interactive viewer on the PyTorch port: fly the camera around the
black hole in a terminal.

The counterpart of the reference's interactive window
(src/main.cpp:303-435 draw loop + src/lib/Input/input.cpp
WASD/mouse): keys update a ViewerState (schwarzschild_tpu_torch.viewer),
every frame is one ``render_fast`` call (the scene-march kernel on the
card), quantized to uint8 on the card and copied to the host once, and
blitted to the terminal as ANSI truecolor half-blocks.

    python examples/live_viewer_torch.py                  # demo scene, 192x96
    python examples/live_viewer_torch.py --width 256 --height 128 --config 3
    python examples/live_viewer_torch.py --selftest       # no TTY: scripted keys
    python examples/live_viewer_torch.py --device cpu --script wwa2hq

Keys: wasd/zx move, arrows look, +/- zoom, 1-4 render mode (main.cpp
keys 1-4), h hyperbolic flyby (key H), r test-ray tubes (key R), q quit.
Imports only the port.
"""

import argparse
import json
import select
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import schwarzschild_tpu_torch as sp  # noqa: E402
from schwarzschild_tpu_torch import configs, viewer  # noqa: E402
from schwarzschild_tpu_torch.camera import Camera  # noqa: E402
from schwarzschild_tpu_torch.compile_cache import (  # noqa: E402
    enable_persistent_cache)
from schwarzschild_tpu_torch.features import calculate_test_ray  # noqa: E402
from schwarzschild_tpu_torch.kernel_scene import render_fast  # noqa: E402
from schwarzschild_tpu_torch.render import to_uint8  # noqa: E402
from schwarzschild_tpu_torch.textures import build_atlas_cached  # noqa: E402


def make_renderer(conf, width, height, device="cuda"):
    """The frame function: ViewerState -> (height, width, 3) uint8 numpy
    image.  The state's camera moves to ``device`` once a frame; the
    frame is quantized to uint8 there (the host copy moves 3 bytes a
    pixel, not 16) and copied to the host once.  The test-ray polyline is
    snapshotted from the camera when key R turns it on, as the reference
    recomputes it on each press (main.cpp:94-124)."""
    device = torch.device(device)
    sc, bg, tex = conf["scene"], conf["background"], conf["tex"]
    atlas = build_atlas_cached(bg, tex)  # once: every frame fetches from it
    tray_holder = {"tray": None, "on": False}
    cfgs = {}

    def frame(state: viewer.ViewerState) -> np.ndarray:
        if state.test_ray and not tray_holder["on"]:
            tray_holder["tray"] = calculate_test_ray(state.cam, device=device)
        tray_holder["on"] = state.test_ray
        cfg = cfgs.setdefault(state.raytrace_type, sp.RenderConfig(
            width=width, height=height, percent_black=-1.0,
            raytrace_type=state.raytrace_type, crosshair=True))
        cam = Camera(*(x.to(device) for x in state.cam))
        img = render_fast(sc, cam, cfg, bg, tex, 1.0, overflow="ignore",
                          test_ray=tray_holder["tray"] if state.test_ray
                          else None, atlas=atlas)
        return to_uint8(img).cpu().numpy()

    return frame


def run_tty(frame, state, fps_cap):
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    sys.stdout.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
    frame_ms = 0.0
    try:
        tty.setcbreak(fd)
        last = time.perf_counter()
        while not state.quit:
            t0 = time.perf_counter()
            img = frame(state)
            frame_ms = (time.perf_counter() - t0) * 1e3
            sys.stdout.write(viewer.ansi_frame(img,
                                               viewer.hud(state, frame_ms)))
            sys.stdout.flush()
            # pace to the cap, then drain whatever keys arrived
            budget = 1.0 / fps_cap - (time.perf_counter() - t0)
            r, _, _ = select.select([fd], [], [], max(budget, 0.0))
            if r:
                for k in viewer.decode_keys(sys.stdin.buffer.read1(64)):
                    state = viewer.apply_key(state, k)
            now = time.perf_counter()
            state = viewer.advance_flyby(state, now - last)
            last = now
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\x1b[?25h\n")


SELFTEST_SCRIPT = ["w", "a", "up", "left", "+", "2", "1", "r", "r", "h",
                   "down", "right", "s", "d", "-", "q"]


def run_script(frame, state, script, artifact=None):
    """Scripted run, no TTY: plays ``script`` keys one frame apart
    (with a 0.05 s flyby tick each) and prints, and optionally writes as
    JSON, the frame times: the checkable proof that the interactive loop
    works end to end."""
    times = []
    for k in script:
        t0 = time.perf_counter()
        img = frame(state)
        times.append((time.perf_counter() - t0) * 1e3)
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"frame is {img.dtype} {img.shape}, not "
                             "(H, W, 3) uint8")
        state = viewer.apply_key(state, k)
        state = viewer.advance_flyby(state, 0.05)
        if state.quit:
            break
    steady = sorted(times[2:])[len(times[2:]) // 2] if len(times) > 2 \
        else times[-1]
    print(f"script ok: {len(times)} frames, median steady frame "
          f"{steady:.1f} ms ({1e3 / steady:.0f} FPS)")
    if artifact:
        with open(artifact, "w") as f:
            json.dump({"frames": len(times), "frame_ms": times,
                       "median_steady_ms": steady,
                       "keys": list(script)}, f, indent=2)
    return times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--config", type=int, default=2, choices=(2, 3))
    ap.add_argument("--fps-cap", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--script", help="play this key string headlessly "
                    "(e.g. 'wwa1hxq') instead of reading the TTY")
    ap.add_argument("--artifact", help="write frame timings to this JSON")
    args = ap.parse_args(argv)

    enable_persistent_cache()
    dev = args.device
    if args.config == 3:
        conf = configs.config3_full_scene(device=dev)
    else:
        conf = dict(scene=configs.demo_scene(device=dev),
                    background=configs.background_texture(device=dev),
                    tex=configs.demo_texture_stack(device=dev))
    frame = make_renderer(conf, args.width, args.height, dev)
    state = viewer.initial_state()

    if args.script:
        return run_script(frame, state,
                          viewer.decode_keys(args.script.encode()),
                          artifact=args.artifact)
    if args.selftest or not sys.stdin.isatty():
        times = run_script(frame, state, SELFTEST_SCRIPT,
                           artifact=args.artifact)
        if len(times) != len(SELFTEST_SCRIPT):
            raise RuntimeError(f"selftest played {len(times)} of "
                               f"{len(SELFTEST_SCRIPT)} frames")
        return times
    run_tty(frame, state, args.fps_cap)
    return None


if __name__ == "__main__":
    main()
