"""Traffic kind ``fit``: ``inverse.make_train_step`` steps back to back,
each ending in ``float(loss)`` as ``inverse.fit`` records its history.

Set-up builds the target, the parameters, the optimizer state and the step
once, runs the first ``compare_steps`` steps through the window's own call,
and hands the same objects to the window.  A seeded reservoir keeps
``window_steps`` of the window's steps, each with the parameters and the
optimizer state before and after it.

The check: the reference (``reference.render.follow``) takes every recorded
step from the program's parameters and optimizer state before it (the
trajectories of two sound renderers part after one step: ulp-level
differences flip rays that graze the photon sphere, whose gradients are
huge; PERF.md has the readings), and builds the start itself.  The
numbers: the start's largest relative difference from the reference's; the
largest relative gap between the two sides' losses; the worst leaf's gap
between the two sides' norms of the clipped gradient each step's optimizer
took (the program's worked out from its Adam moments) and of each step's
change, over the larger of that leaf's reference norm and the median
leaf's (leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change: they move by round-off alone);
and the largest gap between the optimizer's count of updates after a step
and the number of steps the reference knows were taken by then, which an
update skipped or a state returned unchanged moves on every seed, also
where every gradient is zero on both sides.

A ``fault`` (tests only) breaks the timed path underneath the harness:
"half" leaves half of the loss's pixels out, "answer" alters the loss
where it is produced, "unchanged" makes the step return its parameters and
state unchanged.  The control (``readings``) is the reference computed in
bfloat16, in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs as I
from ..reference import render as R
from ..window import mark, reservoir_pick, span

FAULTS = ("half", "answer", "unchanged")


def problem(cell) -> dict:
    """The configuration's fit with the traffic's overrides."""
    return {**cell.config["fit"], **cell.traffic.get("fit", {})}


def load(cell, seed, seconds, device, *, profiler=None, scale=None,
         fault=None, control=None) -> dict:
    import schwarzschild_tpu_torch as st
    from schwarzschild_tpu_torch import inverse, textures

    if control is not None:
        raise ValueError("the fit's control is the reference in bfloat16 "
                         "(readings), not a program path")
    if fault not in (None,) + FAULTS:
        raise ValueError(f"no fault {fault!r} for the fit")
    cfg, traffic = cell.config, cell.traffic
    fp = problem(cell)
    raws = I.raw_textures(cfg)
    sc, rc, bg, tex, n_slots = I.program_inputs(cfg, traffic, raws, device,
                                               scale)
    slot = fp["disk_slot"]
    pass_atlas = bool(fp.get("pass_atlas", False))
    mark("inputs")
    cam_true = I.program_camera(cfg["camera"], device=device)
    offset = I.pose_offset(float(fp["pose_offset"]), seed)
    cam0 = I.program_camera(cfg["camera"], offset=offset, device=device)
    with torch.no_grad():
        target = st.render_fast(sc, cam_true, rc, bg, tex,
                                float(fp["r_s_true"]), n_slots=n_slots,
                                overflow="ignore")
    mark("target")
    params = inverse.init_params(cam0, float(fp["r_s_start"]), tex, slot)
    opt = inverse.default_optimizer(float(fp["learning_rate"]))
    opt_state = opt.init(params)
    # pass_atlas: the atlas is built once and handed to every step.
    aux = (textures.build_atlas_cached(bg, tex),) if pass_atlas else ()
    if fault == "half":
        H = rc.height

        def loss_fn(p, *atlas):
            cam, r_s, tex_p = inverse.realize(p, tex, slot)
            img = st.render_fast(sc, cam, rc, bg, tex_p, r_s,
                                 overflow="ignore", differentiable=True,
                                 atlas=atlas[0] if atlas else None)
            return torch.mean((img[:H // 2] - target[:H // 2]) ** 2)
    else:
        loss_fn = inverse.make_loss(sc, rc, bg, tex, slot, target,
                                    renderer=fp["renderer"],
                                    pass_atlas=pass_atlas)
    step = inverse.make_train_step(loss_fn, opt)
    if fault == "unchanged":
        def step(p, s, *atlas):
            return p, s, loss_fn(p, *atlas).detach()

    state = dict(params=params, opt_state=opt_state)

    def one():
        state["params"], state["opt_state"], loss = step(
            state["params"], state["opt_state"], *aux)
        value = float(loss)
        return value * 1.01 if fault == "answer" else value

    def snapshot():
        p = _leaves(state["params"])
        return (p,) + _adam_state(state["opt_state"], p)

    # The first steps, recorded for the check; they also warm every shape.
    setup = _segment(0, snapshot())
    for _ in range(int(traffic["compare_steps"])):
        loss = one()
        _extend(setup, loss, snapshot())

    mark("first_steps")
    rng = np.random.default_rng([seed, 2])
    keep_n = int(traffic["window_steps"])
    window = []
    first = int(traffic["compare_steps"])

    def unit(k):
        j = reservoir_pick(rng, k, keep_n)
        before = snapshot() if j is not None else None
        with span("portbench.step", profiler is not None):
            loss = one()
        if before is not None:
            seg = _segment(first + k, before)
            _extend(seg, loss, snapshot())
            if j < len(window):
                window[j] = seg
            else:
                window.append(seg)

    return dict(unit=unit, record=dict(setup=setup, window=window),
                offset=offset, state=[sc, tex, bg, target, state, aux])


def _segment(first: int, snap) -> dict:
    """A record of consecutive steps from overall step ``first``: the
    parameters, Adam's moments and its count before each step and after
    the last, and each step's loss."""
    p, mu, nu, count = snap
    return dict(first=first, params=[p], mu=[mu], nu=[nu], counts=[count],
                losses=[])


def _extend(seg: dict, loss: float, snap):
    p, mu, nu, count = snap
    seg["losses"].append(loss)
    seg["params"].append(p)
    seg["mu"].append(mu)
    seg["nu"].append(nu)
    seg["counts"].append(count)


def _leaves(params) -> dict:
    """The parameters' tensors by field name (fields that are None, as an
    unfitted disk texture, left out), copied."""
    return {n: x.detach().clone() for n, x in zip(params._fields, params)
            if x is not None}


def _adam_state(opt_state, like: dict):
    """Copies of Adam's first and second moments by leaf (``like``'s names,
    in order) and of its count, in the optimizer's state."""
    stack = [opt_state]
    while stack:
        s = stack.pop()
        if hasattr(s, "mu") and hasattr(s, "nu") and hasattr(s, "count"):
            return (dict(zip(like, (m.detach().clone() for m in s.mu))),
                    dict(zip(like, (v.detach().clone() for v in s.nu))),
                    torch.as_tensor(s.count).detach().clone())
        if isinstance(s, tuple):
            stack.extend(s)
    raise RuntimeError("no Adam state in the optimizer's state")


def work(cell, loaded: dict, device, scale=None) -> list:
    """The executed steps and marched rays at the parameters the window
    starts from, from the benchmark's own march."""
    cfg, traffic = cell.config, cell.traffic
    n_slots = int(I.render_fields(cfg, traffic).get("n_slots", 4))
    inp = I.reference_inputs(cfg, traffic, I.raw_textures(cfg), device,
                             scale=scale)
    p = loaded["record"]["setup"]["params"][-1]
    pose, r_s, _ = R.realize(p, inp.stack, None)
    pose = R.Pose(*(x.to(device=device, dtype=torch.float32) for x in pose))
    steps, rays = R.march_counts(inp, pose, r_s.to(device))
    return [dict(steps=steps, rays=rays, n_slots=n_slots, events=True)]


def inputs(cell, offset, device, dtype=torch.float32, scale=None):
    """The reference's inputs of a fit: (inputs, target, start)."""
    cfg, traffic = cell.config, cell.traffic
    fp = problem(cell)
    inp = I.reference_inputs(cfg, traffic, I.raw_textures(cfg), device,
                             dtype=dtype, scale=scale)
    true_pose = I.reference_pose(cfg["camera"], device=device, dtype=dtype)
    target, _ = R.render_frame(inp, true_pose, float(fp["r_s_true"]))
    start = I.reference_pose(cfg["camera"], offset=offset, device=device,
                             dtype=dtype)
    return inp, target, R.start_params(inp, start, float(fp["r_s_start"]),
                                       fp["disk_slot"])


def _norms(tree: dict) -> dict:
    return R.leaf_norms({k: v.to(torch.float32) for k, v in tree.items()})


def numbers(cell, record: dict, inp, target, start: dict) -> dict:
    """{name: (value, limit)} of a recorded fit (the program's, or the
    control's) against the reference."""
    fp = problem(cell)
    limits = cell.traffic["check"]["limits"]
    setup = record["setup"]
    p0 = setup["params"][0]
    if set(p0) != set(start):
        raise ValueError(f"fitted leaves {sorted(p0)}, "
                         f"expected {sorted(start)}")
    start_gap = max(float((p0[k].to(torch.float32)
                           - start[k].to(torch.float32)).abs().max())
                    / max(float(start[k].abs().max()), 1e-30)
                    for k in start)
    loss_gap = grad_gap = change_gap = count_gap = 0.0
    b1 = R.Adam.b1
    for seg in [setup] + list(record.get("window", [])):
        ref = R.follow(inp, seg, target, fp["disk_slot"],
                       float(fp["learning_rate"]))
        for k, r in enumerate(ref):
            loss_gap = max(loss_gap, abs(seg["losses"][k] - r["loss"])
                           / abs(r["loss"]))
            # The clipped gradient the program's optimizer took at step k.
            taken = {n: (m - b1 * seg["mu"][k][n]) / (1 - b1)
                     for n, m in seg["mu"][k + 1].items()}
            g_ref = _norms(r["grad"])
            grad_gap = max(grad_gap, R.worst_leaf_gap(_norms(taken), g_ref))
            med = float(np.median(list(g_ref.values())))
            moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med]
            change = {n: seg["params"][k + 1][n] - x
                      for n, x in seg["params"][k].items()}
            change_gap = max(change_gap, R.worst_leaf_gap(
                _norms(change), _norms(r["update"]), moved))
            count_gap = max(count_gap, abs(
                int(seg["counts"][k + 1]) - r["count"]))
    return dict(start_gap=(start_gap, limits["start_gap"]),
                loss_gap=(loss_gap, limits["loss_gap"]),
                grad_gap=(grad_gap, limits["grad_gap"]),
                change_gap=(change_gap, limits["change_gap"]),
                count_gap=(float(count_gap), limits["count_gap"]))


def check(cell, loaded: dict, device, scale=None):
    inp, target, start = inputs(cell, loaded["offset"], device, scale=scale)
    nums = numbers(cell, loaded["record"], inp, target, start)
    return nums, sum(int(v > lim) for v, lim in nums.values())


SIDES = ("program", "control") + FAULTS


def readings(cell, seed, device, side, seconds=2.0, scale=None) -> dict:
    """The numbers the check compares, for one seed: the program run as a
    benchmark run runs it with a short window, or with a fault planted;
    or the control, the reference in bfloat16 in the program's place."""
    from ..run import run_cell

    if side not in SIDES:
        raise ValueError(f"no side {side!r} for the fit")
    if side != "control":
        out = run_cell(cell, seed, seconds, False, device, scale=scale,
                       fault=None if side == "program" else side)
        return {k: c["value"] for k, c in out["checks"].items()}
    fp = problem(cell)
    offset = I.pose_offset(float(fp["pose_offset"]), seed)
    inp, target, start = inputs(cell, offset, device, torch.bfloat16, scale)
    setup = R.fit_trajectory(inp, start, target, fp["disk_slot"],
                             float(fp["learning_rate"]),
                             int(cell.traffic["compare_steps"]))
    del inp, target, start
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inp, target, start = inputs(cell, offset, device, scale=scale)
    nums = numbers(cell, dict(setup=setup), inp, target, start)
    return {k: v for k, (v, _) in nums.items()}
