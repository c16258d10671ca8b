"""Traffic kind ``frames``: closed-loop ``render_fast`` frames, one client;
a frame counts when its image is on the device (synchronised).

The poses come from the traffic's orbit (``inputs.orbit_yaws``); a seeded
reservoir keeps ``check_frames`` of the window's frames.  The check renders
each kept frame again with the reference from the same pose and reads two
numbers over its pixels: the share of pixels whose largest channel error
exceeds the traffic's ``pixel_tol``, and the mean absolute error.

``control="bf16_textures"`` (control runs only) renders from bfloat16
textures, the program's own lower-precision path.  A ``fault`` (tests
only) breaks the timed path underneath the harness: "half" leaves half of
the frame out, "answer" alters the frame where it is produced.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs as I
from ..reference import render as R
from ..window import mark, reservoir_pick, span, sync

FAULTS = ("half", "answer")


def load(cell, seed, seconds, device, *, profiler=None, scale=None,
         fault=None, control=None) -> dict:
    import schwarzschild_tpu_torch as st

    if fault not in (None,) + FAULTS:
        raise ValueError(f"no fault {fault!r} for frames")
    cfg, traffic = cell.config, cell.traffic
    raws = I.raw_textures(cfg)
    sc, rc, bg, tex, n_slots = I.program_inputs(cfg, traffic, raws, device,
                                               scale)
    if control == "bf16_textures":  # the program's own lower precision
        bg, tex = st.with_dtype(bg), st.stack_with_dtype(tex)
    elif control is not None:
        raise ValueError(f"no control {control!r} for frames")
    mark("inputs")
    yaws = I.orbit_yaws(traffic, seed)
    cams = [I.program_camera(cfg["camera"], y, device=device) for y in yaws]
    r_s = float(cfg["r_s"])
    H = rc.height

    def render(k):
        img = st.render_fast(sc, cams[k % len(cams)], rc, bg, tex, r_s,
                             n_slots=n_slots)
        if fault == "half":
            img = torch.cat([img[:H // 2], torch.zeros_like(img[H // 2:])])
        elif fault == "answer":
            img = img + 0.01
        return img

    render(0)  # builds the kernels and the atlas
    sync(device)
    mark("first_frame")
    render(1)
    sync(device)
    rng = np.random.default_rng([seed, 1])
    keep_n = int(traffic["check_frames"])
    kept = []

    def unit(k):
        with span("portbench.frame", profiler is not None):
            img = render(k)
            sync(device)
        j = reservoir_pick(rng, k, keep_n)
        if j is not None:
            if j < len(kept):
                kept[j] = (k, img)
            else:
                kept.append((k, img))

    return dict(unit=unit, kept=kept, yaws=yaws, state=[sc, tex, bg, cams])


def work(cell, loaded: dict, device, scale=None) -> list:
    """Each pose's executed steps and marched rays, from the benchmark's own
    march; the traced frames cycle through the poses in this order."""
    cfg, traffic = cell.config, cell.traffic
    n_slots = int(I.render_fields(cfg, traffic).get("n_slots", 4))
    inp = I.reference_inputs(cfg, traffic, I.raw_textures(cfg), device,
                             scale=scale)
    return [dict(zip(("steps", "rays"), R.march_counts(
        inp, I.reference_pose(cfg["camera"], y, device=device),
        float(cfg["r_s"]))), n_slots=n_slots, events=False)
        for y in loaded["yaws"]]


def check(cell, loaded: dict, device, scale=None):
    cfg, traffic = cell.config, cell.traffic
    chk = traffic["check"]
    lim = chk["limits"]
    inp = I.reference_inputs(cfg, traffic, I.raw_textures(cfg), device,
                             scale=scale)
    share = mae = 0.0
    failed = 0
    yaws = loaded["yaws"]
    for k, img in loaded["kept"]:
        pose = I.reference_pose(cfg["camera"], yaws[k % len(yaws)],
                                device=device)
        ref, _ = R.render_frame(inp, pose, float(cfg["r_s"]))
        s, m = R.pixel_gap(img, ref, float(chk["pixel_tol"]))
        del ref
        share, mae = max(share, s), max(mae, m)
        failed += int(s > lim["bad_px_share"] or m > lim["mean_abs_err"])
    return dict(bad_px_share=(share, lim["bad_px_share"]),
                mean_abs_err=(mae, lim["mean_abs_err"])), failed


SIDES = ("program", "control") + FAULTS


def readings(cell, seed, device, side, seconds=2.0, scale=None) -> dict:
    """The numbers the check compares, for one seed: the program run as a
    benchmark run runs it with a short window, or with the control or a
    fault in place."""
    from ..run import run_cell

    if side not in SIDES:
        raise ValueError(f"no side {side!r} for frames")
    out = run_cell(cell, seed, seconds, False, device, scale=scale,
                   control="bf16_textures" if side == "control" else None,
                   fault=side if side in FAULTS else None)
    return {k: c["value"] for k, c in out["checks"].items()}
