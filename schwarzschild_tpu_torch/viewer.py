"""The live viewer's engine: key bindings, camera state, terminal blit
(counterpart of ``schwarzschild_tpu.viewer``).

The reference is an interactive window: a free-running draw loop
(src/main.cpp:303-435) fed by WASD and mouse camera
controls (src/lib/Input/input.cpp:17-53), mode keys 1-4
(main.cpp:352-365), key H (the hyperbolic flyby) and key R (the test
ray).  Here a key maps a :class:`ViewerState` to the next one, and
:func:`ansi_frame` encodes a frame as ANSI half-blocks for a terminal;
examples/live_viewer_torch.py is the loop around them.

Transitions compute on the host in float32 numpy, with the rotations and
the flyby in CPU torch, so a key costs no device sync and a state equals
the JAX package's bit for bit.  The state's camera holds CPU tensors; the
frame function moves it to the card once a frame.

Bindings (reference parity where a keyboard analog exists):
  w/s       move along camera forward/back        (input.cpp W/S)
  a/d       strafe left/right                     (input.cpp A/D)
  z/x       move down/up world-Y                  (input.cpp LSHIFT/SPACE)
  arrows    yaw (left/right), pitch (up/down)     (mouse look, input.cpp:33-53)
  + / -     zoom: fov down/up                     (scroll zoom analog)
  1..4      raytrace mode CURVED/FLAT/HALF_WIDTH/HALF_HEIGHT (main.cpp:352-365)
  h         restart the hyperbolic flyby          (main.cpp:404-410 key H)
  r         toggle the test-ray tube overlay      (main.cpp key R)
  q / ESC   quit
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import camera as cam_mod
from . import geometry as geo
from .config import CURVED

MOVE_STEP = 0.5   # world units per keypress (input.cpp moves ~speed*dt)
TURN_STEP = 4.0   # degrees per keypress
FOV_STEP = 5.0    # degrees per keypress
FOV_MIN, FOV_MAX = 20.0, 150.0


@dataclasses.dataclass(frozen=True)
class ViewerState:
    """Everything the draw loop needs; immutable, so transitions are
    pure.  ``cam`` holds float32 CPU tensors."""

    cam: cam_mod.Camera
    raytrace_type: int = CURVED
    test_ray: bool = False
    flyby_t: Optional[float] = None  # None = free flight, else [0, 1] progress
    quit: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                      np.float32)


def _with(cam: cam_mod.Camera, **fields) -> cam_mod.Camera:
    """``cam`` with numpy fields replaced, as CPU tensors."""
    return cam._replace(**{k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in fields.items()})


def initial_state(pos=(0.0, 2.0, 15.0)) -> ViewerState:
    cam = cam_mod.look_at(cam_mod.make_camera(pos, device="cpu"))
    return ViewerState(cam=cam)


def _rotate_cam(cam: cam_mod.Camera, axis, angle_deg: float):
    """Yaw or pitch: rotate the axes about ``axis`` (Rodrigues, the
    primitive the reference's mouse look composes, input.cpp:33-53), then
    re-orthonormalize, since repeated float32 rotations drift: forward is
    kept, right is made orthogonal to it, up completes the frame."""
    ang = math.radians(angle_deg)
    axis = torch.from_numpy(np.asarray(axis, np.float32))
    axes = _host(cam.axes)
    cols = [_host(geo.rotate_vector(ang, torch.from_numpy(
        np.ascontiguousarray(axes[:, i])), axis)) for i in range(3)]
    f = cols[2] / np.linalg.norm(cols[2])
    r = cols[0] - f * float(np.dot(cols[0], f))
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    return _with(cam, axes=np.stack([r, u, f], axis=1))


def apply_key(state: ViewerState, key: str) -> ViewerState:
    """One key -> next state.  ``key`` is a decoded name: single characters
    plus 'up'/'down'/'left'/'right'/'esc'.  Unknown keys are no-ops."""
    cam = state.cam
    pos = _host(cam.pos)
    fwd = _host(cam.forward)
    right = _host(cam.right)

    def moved(new_pos):
        return state.replace(cam=_with(cam, pos=new_pos), flyby_t=None)

    def turned(axis, angle):
        return state.replace(cam=_rotate_cam(cam, axis, angle), flyby_t=None)

    if key in ("q", "esc"):
        return state.replace(quit=True)
    if key == "w":
        return moved(pos + MOVE_STEP * fwd)
    if key == "s":
        return moved(pos - MOVE_STEP * fwd)
    if key == "a":
        return moved(pos - MOVE_STEP * right)
    if key == "d":
        return moved(pos + MOVE_STEP * right)
    if key == "x":
        return moved(pos + np.float32([0, MOVE_STEP, 0]))
    if key == "z":
        return moved(pos - np.float32([0, MOVE_STEP, 0]))
    if key == "left":
        return turned((0.0, 1.0, 0.0), TURN_STEP)
    if key == "right":
        return turned((0.0, 1.0, 0.0), -TURN_STEP)
    if key == "up":
        return turned(tuple(right), TURN_STEP)
    if key == "down":
        return turned(tuple(right), -TURN_STEP)
    if key in ("+", "="):
        fov = max(FOV_MIN, float(cam.fov) - FOV_STEP)
        return state.replace(cam=_with(cam, pos=pos, fov=np.float32(fov)))
    if key == "-":
        fov = min(FOV_MAX, float(cam.fov) + FOV_STEP)
        return state.replace(cam=_with(cam, pos=pos, fov=np.float32(fov)))
    if key in ("1", "2", "3", "4"):
        return state.replace(raytrace_type=int(key) - 1)
    if key == "r":
        return state.replace(test_ray=not state.test_ray)
    if key == "h":
        return state.replace(flyby_t=0.0)
    return state


def advance_flyby(state: ViewerState, dt: float,
                  initial_distance: float = 30.0,
                  closest_distance: float = 10.0) -> ViewerState:
    """Tick the key-H hyperbolic flyby: the camera follows
    camera.hyperbolic_trajectory over HYPERBOLIC_TRAJECTORY_DURATION wall
    seconds (camera.h:10, main.cpp:404-410), then returns to free flight."""
    if state.flyby_t is None:
        return state
    t = state.flyby_t + dt / cam_mod.HYPERBOLIC_TRAJECTORY_DURATION
    if t >= 1.0:
        return state.replace(flyby_t=None)
    base = cam_mod.make_camera((0.0, 2.0, 15.0), device="cpu")
    cam = cam_mod.hyperbolic_trajectory(base, initial_distance,
                                        closest_distance, t)
    return state.replace(cam=cam, flyby_t=t)


def decode_keys(raw: bytes) -> list:
    """Decode a raw stdin chunk into key names (ESC [ A/B/C/D arrow
    sequences; a bare ESC quits)."""
    keys = []
    i = 0
    arrows = {65: "up", 66: "down", 67: "right", 68: "left"}
    while i < len(raw):
        b = raw[i]
        if b == 0x1B:
            if i + 2 < len(raw) and raw[i + 1] == 0x5B and \
                    raw[i + 2] in arrows:
                keys.append(arrows[raw[i + 2]])
                i += 3
                continue
            keys.append("esc")
            i += 1
            continue
        keys.append(chr(b).lower())
        i += 1
    return keys


def ansi_frame(img, status: str = "") -> str:
    """Encode an (H, W, 3|4) image (float in [0, 1], or uint8; numpy or a
    tensor) as ANSI truecolor half-blocks: one character cell shows two
    vertically stacked pixels (upper = foreground over '▀', lower =
    background), so an H-row image needs H/2 terminal rows.  Returns the
    whole escape string, with the home-cursor prefix."""
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    if img.dtype == np.uint8:
        a = img[..., :3]
    else:
        a = (np.clip(img[..., :3], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h = a.shape[0] // 2 * 2
    top, bot = a[0:h:2], a[1:h:2]
    rows = ["\x1b[H"]
    for rt, rb in zip(top.tolist(), bot.tolist()):
        cells = []
        prev = None
        for (tr, tg, tb), (br, bg_, bb) in zip(rt, rb):
            code = (tr, tg, tb, br, bg_, bb)
            if code != prev:  # run-length: an SGR only on a colour change
                cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg_};{bb}m")
                prev = code
            cells.append("▀")
        cells.append("\x1b[0m")
        rows.append("".join(cells))
    if status:
        rows.append("\x1b[0m\x1b[K" + status)
    return "\r\n".join(rows)


def hud(state: ViewerState, frame_ms: float) -> str:
    p = _host(state.cam.pos)
    mode = ["CURVED", "FLAT", "HALF_W", "HALF_H"][state.raytrace_type]
    fly = f" flyby {state.flyby_t:.2f}" if state.flyby_t is not None else ""
    return (f"[{mode}] pos ({p[0]:+.1f},{p[1]:+.1f},{p[2]:+.1f}) "
            f"fov {float(state.cam.fov):.0f}  {1e3 / max(frame_ms, 1e-6):.0f}"
            f" FPS ({frame_ms:.1f} ms){fly}  "
            "wasd/zx move, arrows look, +/- zoom, 1-4 mode, h flyby, "
            "r ray, q quit")
