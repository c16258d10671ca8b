"""The reference renderer and the reference fit: plain PyTorch, in blocks
of image rows, importing nothing of the program.

The march follows the dense renderer's per-pixel program (frag:843-936):
every ray of a block takes the same RK4 steps, with GLSL's breaks as
per-ray flags.  The scenes that the benchmark renders are opaque (every
texel's alpha is 1 and every material double-sided), so a ray's colour is
that of its first hit; a step records the segment that hit, and the hit is
intersected again in full and shaded once after the march.  A frame whose
hits are not all opaque raises :class:`Unsupported` rather than rendering
something else.

``fit_reference`` is ``inverse.fit``'s loop worked out again: the
parameters realised into a camera, r_s and a texture stack, the mean
squared error against a target, its gradient by autograd, and optax's
chain (zero non-finite entries, clip the global norm to 1, Adam).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import plain as P


class Unsupported(RuntimeError):
    """The frame needs a part of the renderer that the reference lacks."""


class Inputs(NamedTuple):
    """What both sides are handed, in the reference's own form."""

    scene: dict  # spheres, hollow, materials, lights: dicts of tensors
    stack: torch.Tensor  # (T, H, W, 4) texels, row 0 = bottom
    sizes: torch.Tensor  # (T, 2) true (width, height)
    max_size: torch.Tensor  # (2,)
    sky: torch.Tensor  # (H, W, 4)
    width: int
    height: int
    max_steps: int
    max_revolutions: int
    u_f: float
    percent_black: float  # < 0: no noise
    noise_seed: int


# ---------------------------------------------------------------------------
# Inputs from the configuration's description.
# ---------------------------------------------------------------------------


def gl_rgba(raw: np.ndarray) -> np.ndarray:
    """A top-down uint8 (H, W, C) image as bottom-up float32 RGBA."""
    arr = raw[::-1]
    h, w, c = arr.shape
    out = np.zeros((h, w, 4), np.float32)
    out[..., :c] = arr.astype(np.float32) / 255.0
    if c < 4:
        out[..., 3] = 1.0
    return out


def sky_rgba(raw: np.ndarray) -> np.ndarray:
    """The sky, a top-down uint8 image, as the float RGBA the renderer
    samples: scaled in float64, rounded to float32, flipped, alpha 1."""
    arr = np.asarray(raw.astype(np.float64) / 255.0, np.float32)[::-1]
    if arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.ones(arr.shape[:-1] + (1,), np.float32)], -1)
    return np.ascontiguousarray(arr)


# The render fields the reference implements, each with the values it
# implements (None: any value).  A field that changes the frame in a way the
# reference does not follow raises Unsupported, so that a new cell fails
# loudly instead of being compared with another renderer.
RENDER_FIELDS = dict(
    width=None, height=None, max_steps=None, max_revolutions=None,
    u_f=None, percent_black=None, noise_seed=None, n_slots=None,
    raytrace_type=(0,),  # CURVED: every pixel marched
    crosshair=(False,), horizon_softness=(0.0,),
    texture_filter=("bilinear",),
    # Read by the program's gradient path for its checkpoints, by its
    # half-and-half modes, by its "tile" noise and by its test rays: none
    # of them changes a CURVED frame with hash noise or none.
    checkpoint_every=None, curved_percentage=None, noise_tile=None,
    test_ray_capacity=None)


def _check_render(r: dict):
    for key, value in r.items():
        if key == "noise_mode":
            if float(r.get("percent_black", 0.75)) >= 0.0 and value != "hash":
                raise Unsupported(f"noise_mode {value!r}: the reference "
                                  "draws the hash field alone")
            continue
        if key not in RENDER_FIELDS:
            raise Unsupported(f"render field {key!r}")
        allowed = RENDER_FIELDS[key]
        if allowed is not None and value not in allowed:
            raise Unsupported(f"render field {key}={value!r}")


def build_inputs(desc: dict, sky_raw, stack_raws, dtype=torch.float32,
                 device="cpu") -> Inputs:
    """The scene of ``desc`` (the configuration's ``scene`` block) and the
    raw textures as reference tensors of ``dtype``."""
    dev = torch.device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dtype)

    mats, spheres, hollow = [], [], []
    for obj in desc["objects"]:
        mats.append(obj.get("material", {}))
        if obj["type"] == "sphere":
            spheres.append((obj, len(mats) - 1))
        elif obj["type"] == "hollow_disk":
            hollow.append((obj, len(mats) - 1))
        else:
            raise Unsupported(f"object type {obj['type']!r}")
    eye = np.eye(3, dtype=np.float32)

    def axes(o):
        return np.asarray(o.get("axes", eye), np.float32).reshape(3, 3)

    def m(key, default):
        return [mm.get(key, default) for mm in mats]

    materials = dict(
        color=f(np.array(m("color", (0.5, 0.0, 0.5, 1.0)),
                         np.float32).reshape(-1, 4)),
        ambient=f(m("ambient", 0.1)), diffuse=f(m("diffuse", 0.9)),
        specular=f(m("specular", 0.5)), shininess=f(m("shininess", 32.0)),
        texture_index=torch.tensor(m("texture_index", -1), dtype=torch.int32,
                                   device=dev),
        normal_map_index=torch.tensor(m("normal_map_index", -1),
                                      dtype=torch.int32, device=dev),
        invert_uv_x=torch.tensor(m("invert_uv_x", False), device=dev),
        invert_uv_y=torch.tensor(m("invert_uv_y", False), device=dev),
        swap_uvs=torch.tensor(m("swap_uvs", False), device=dev),
        double_sided=torch.tensor(m("double_sided_normals", True),
                                  device=dev),
        flip_normals=torch.tensor(m("flip_normals", False), device=dev))
    sc = dict(
        materials=materials,
        spheres=dict(
            pos=f(np.array([o["pos"] for o, _ in spheres],
                           np.float32).reshape(-1, 3)),
            axes=f(np.array([axes(o) for o, _ in spheres],
                            np.float32).reshape(-1, 3, 3)),
            radius=f([o.get("radius", 1.0) for o, _ in spheres]),
            mat=torch.tensor([i for _, i in spheres], dtype=torch.int32,
                             device=dev)),
        hollow=dict(
            pos=f(np.array([o.get("pos", (0.0, 0.0, 0.0)) for o, _ in hollow],
                           np.float32).reshape(-1, 3)),
            axes=f(np.array([axes(o) for o, _ in hollow],
                            np.float32).reshape(-1, 3, 3)),
            inner=f([o.get("inner_radius", 2.5) for o, _ in hollow]),
            outer=f([o.get("outer_radius", 5.0) for o, _ in hollow]),
            mat=torch.tensor([i for _, i in hollow], dtype=torch.int32,
                             device=dev)),
        lights=dict(
            pos=f(np.array([lt.get("pos", (10.0, 10.0, 10.0))
                            for lt in desc["lights"]], np.float32)),
            color=f(np.array([lt.get("color", (1.0, 1.0, 1.0))
                              for lt in desc["lights"]], np.float32)),
            intensity=f([lt.get("intensity", 2.5) for lt in desc["lights"]]),
            att_constant=f([lt.get("attenuation_constant", 1.0)
                            for lt in desc["lights"]]),
            att_linear=f([lt.get("attenuation_linear", 0.09)
                          for lt in desc["lights"]]),
            att_quadratic=f([lt.get("attenuation_quadratic", 0.032)
                             for lt in desc["lights"]])))
    gls = [gl_rgba(r) for r in stack_raws]
    max_h = max(g.shape[0] for g in gls)
    max_w = max(g.shape[1] for g in gls)
    data = np.zeros((len(gls), max_h, max_w, 4), np.float32)
    sizes = np.zeros((len(gls), 2), np.float32)
    for i, g in enumerate(gls):
        data[i, :g.shape[0], :g.shape[1]] = g
        sizes[i] = (g.shape[1], g.shape[0])
    r = desc["render"]
    _check_render(r)
    return Inputs(scene=sc, stack=f(data), sizes=f(sizes),
                  max_size=f([max_w, max_h]), sky=f(sky_rgba(sky_raw)),
                  width=int(r["width"]), height=int(r["height"]),
                  max_steps=int(r.get("max_steps", 100)),
                  max_revolutions=int(r.get("max_revolutions", 2)),
                  u_f=float(r.get("u_f", 0.01)),
                  # The renderer's default noise, main.cpp:66.
                  percent_black=float(r.get("percent_black", 0.75)),
                  noise_seed=int(r.get("noise_seed", 0)))


class Pose(NamedTuple):
    pos: torch.Tensor  # (3,)
    axes: torch.Tensor  # (3, 3) columns right, up, forward
    fov: torch.Tensor  # () degrees


def make_pose(pos, forward, right, fov, dtype=torch.float32, device="cpu"):
    """A camera as make_camera builds it: forward and right normalised, up
    = normalize(cross(right, forward))."""
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)

    fw, rt = P.normalize(f(forward)), P.normalize(f(right))
    up = P.normalize(P.cross(rt, fw))
    return Pose(f(pos), torch.stack([rt, up, fw], -1), f(fov))


# ---------------------------------------------------------------------------
# The frame.
# ---------------------------------------------------------------------------


def _vec(s, prefix):
    return torch.stack([s[prefix + c] for c in "xyz"], -1)


def render_rows(inp: Inputs, pose: Pose, r_s, rows, stack=None,
                compose=True):
    """Image rows [r0, r1) of the frame: ((r1 - r0, W, 4) RGBA, executed
    lane-steps, marched rays).  Differentiable in the pose, r_s and
    ``stack`` (default ``inp.stack``) where they require grad.
    ``compose=False`` marches alone and returns no image."""
    stack = inp.stack if stack is None else stack
    dt, dev = inp.sky.dtype, inp.sky.device
    r_s = torch.as_tensor(r_s, device=dev).to(dt)
    W, H = inp.width, inp.height
    u, v = P.pixel_ndc(rows, W, H, dt, dev)
    origin, direction = P.camera_rays(pose.pos.to(dt), pose.axes.to(dt),
                                      pose.fov.to(dt), u, v, W, H)
    flat_px = P.is_radial(direction, P.safe_normalize(origin))
    if inp.percent_black >= 0.0:
        rnd = torch.as_tensor(P.hash_rand_np(W, H, inp.noise_seed)
                              [rows[0]:rows[1]], device=dev)
        skip = ~flat_px & (rnd <= inp.percent_black)
    else:
        skip = torch.zeros_like(flat_px)
    max_angle, u_f, far_r2 = P.march_scalars(inp.max_steps,
                                             inp.max_revolutions, inp.u_f)
    sc = inp.scene
    s = P.init_march(origin, direction)
    active = ~flat_px & ~skip
    marched = active.sum()
    no = torch.zeros_like(active)
    flat_finish, add_bg, has_hit = no, no, no
    pos, dirn = origin, direction
    nrm, tan = _vec(s, "n"), _vec(s, "t")
    uu, du, phi = s["u"], s["du"], s["phi"]
    rec_pos = torch.zeros_like(origin)
    rec_dir = torch.zeros_like(origin)
    rec_len = torch.zeros_like(uu)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(inp.max_steps):
        if not bool(active.any()):
            break  # every later step is the identity
        steps = steps + active.sum()
        s = dict(u=uu, du=du, phi=phi)
        for prefix, vec in (("p", pos), ("d", dirn), ("n", nrm), ("t", tan)):
            for c, x in zip("xyz", vec.unbind(-1)):
                s[prefix + c] = x
        finish = P.far_field(s, active, u_f, far_r2)
        active = active & ~finish
        flat_finish = flat_finish | finish
        seg, seg_len = P.rk4_segment(s, i, r_s, inp.max_steps, max_angle)
        escaped = active & (seg["u"] < 0.0)
        add_bg = add_bg | escaped
        active = active & ~escaped
        new_pos, new_dir = _vec(seg, "p"), _vec(seg, "d")
        with torch.no_grad():
            hit_now = active & P.any_hit(pos.detach(), new_dir.detach(),
                                         seg_len.detach(), sc, r_s.detach())
        h3 = hit_now[..., None]
        rec_pos = torch.where(h3, pos, rec_pos)
        rec_dir = torch.where(h3, new_dir, rec_dir)
        rec_len = torch.where(hit_now, seg_len, rec_len)
        has_hit = has_hit | hit_now
        active = active & ~hit_now
        moved = active | hit_now
        uu = torch.where(moved, seg["u"], uu)
        du = torch.where(moved, seg["du"], du)
        phi = torch.where(moved, seg["phi"], phi)
        nrm, tan = _vec(s, "n"), _vec(s, "t")
        pos = torch.where(moved[..., None], new_pos, pos)
        dirn = torch.where(moved[..., None], new_dir, dirn)
    if not compose:
        return None, steps, marched

    args = (sc, stack, inp.sizes, inp.max_size)
    hit = P.intersect(rec_pos, rec_dir, rec_len, sc, r_s)
    rgba = P.shade(hit, -rec_dir, *args)
    if bool((has_hit & ~(hit.valid & (rgba[..., 3] == 1.0))).any()):
        raise Unsupported("a recorded hit is not opaque on its recomputation")
    color = torch.where(has_hit[..., None], rgba, 0.0)
    add_bg = add_bg | active  # exhausted marchers (frag:935)
    do_flat = flat_px | flat_finish
    flat_hit = P.intersect(pos, dirn, torch.full_like(uu, -1.0), sc, r_s)
    flat_rgba = P.shade(flat_hit, -dirn, *args)
    flat_color = torch.where((flat_hit.valid & do_flat)[..., None],
                             flat_rgba, 0.0)
    flat_needs_bg = do_flat & (flat_color[..., 3] != 1.0)
    bg = P.background(inp.sky, dirn)
    color = color + flat_color
    color = color + torch.where((flat_needs_bg | add_bg)[..., None], bg, 0.0)
    return color, steps, marched


def _blocks(height: int, width: int, block_rays: int):
    n = max(1, block_rays // width)
    return [(r, min(r + n, height)) for r in range(0, height, n)]


@torch.no_grad()
def render_frame(inp: Inputs, pose: Pose, r_s, block_rays=1 << 22,
                 stack=None):
    """The whole (H, W, 4) frame and its executed lane-steps, rendered in
    blocks of rows."""
    out, total = [], 0
    for rows in _blocks(inp.height, inp.width, block_rays):
        img, steps, _ = render_rows(inp, pose, r_s, rows, stack)
        out.append(img)
        total += int(steps)
    return torch.cat(out, 0), total


@torch.no_grad()
def march_counts(inp: Inputs, pose: Pose, r_s, block_rays=1 << 22):
    """(executed lane-steps, marched rays) of the frame's march, each ray
    stopping at its first hit (every hit of these scenes is opaque)."""
    steps = rays = 0
    for rows in _blocks(inp.height, inp.width, block_rays):
        _, s, m = render_rows(inp, pose, r_s, rows, compose=False)
        steps += int(s)
        rays += int(m)
    return steps, rays


# ---------------------------------------------------------------------------
# The fit.
# ---------------------------------------------------------------------------

def realize(params: dict, stack, disk_slot):
    """Parameters -> (pose, r_s, stack): axes Gram-Schmidt-orthonormalised
    from the free forward and right vectors, r_s = softplus(r_s_raw), the
    disk's slot of the stack replaced by its texels (``disk_slot`` None:
    the texels are not fitted)."""
    f = P.safe_normalize(params["cam_fwd_raw"])
    r = P.safe_normalize(params["cam_right_raw"]
                         - f * P.dot(params["cam_right_raw"], f))
    u = P.cross(r, f)
    pose = Pose(params["cam_pos"], torch.stack([r, u, f], -1),
                params["fov"])
    r_s = torch.logaddexp(params["r_s_raw"],
                          torch.zeros_like(params["r_s_raw"]))
    if disk_slot is None:
        return pose, r_s, stack
    data = torch.cat([stack[:disk_slot], params["disk_texture"][None],
                      stack[disk_slot + 1:]])
    return pose, r_s, data


def loss_and_grad(inp: Inputs, params: dict, target, disk_slot: int,
                  block_rays=1 << 20):
    """Mean squared error of the rendered frame against ``target`` and its
    gradient in every leaf, one block of rows at a time (each block's graph
    freed before the next)."""
    leaves = {k: x.detach().requires_grad_(True) for k, x in params.items()}
    grads = {k: torch.zeros_like(x) for k, x in leaves.items()}
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    for rows in _blocks(inp.height, inp.width, block_rays):
        pose, r_s, data = realize(leaves, inp.stack, disk_slot)
        img, _, _ = render_rows(inp, pose, r_s, rows, data)
        part = torch.sum((img - target[rows[0]:rows[1]]) ** 2)
        gs = torch.autograd.grad(part, list(leaves.values()),
                                 allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                grads[k] += g
        total += part.detach().double()
        del img, part, gs
    n = inp.height * inp.width * 4
    return float(total / n), {k: g / n for k, g in grads.items()}


class Adam:
    """optax's chain as ``inverse.default_optimizer`` builds it: zero the
    non-finite entries, clip the global norm to 1, Adam (b1 0.9, b2 0.999,
    eps 1e-8), times -lr.  ``count``, ``mu`` and ``nu`` are its state:
    zeros for a fresh optimizer, or a state handed to it."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, lr: float, count=0, mu=None, nu=None):
        self.lr = lr
        self.count = count
        self.mu = mu or {k: torch.zeros_like(x) for k, x in params.items()}
        self.nu = nu or {k: torch.zeros_like(x) for k, x in params.items()}
        self.taken = None  # the clipped gradient of the last update

    def update(self, grads: dict) -> dict:
        g = {k: torch.where(torch.isfinite(x), x, torch.zeros_like(x))
             for k, x in grads.items()}
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        if not bool(norm < 1.0):
            g = {k: x / norm for k, x in g.items()}
        self.taken = g
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        out = {}
        for k in self.mu:
            self.mu[k] = (1 - self.b1) * g[k] + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g[k] * g[k]) + self.b2 * self.nu[k]
            out[k] = -self.lr * ((self.mu[k] / c1)
                                 / (torch.sqrt(self.nu[k] / c2) + self.eps))
        return out


def start_params(inp: Inputs, pose: Pose, r_s: float, disk_slot):
    """``inverse.init_params``'s start: softplus^-1 of r_s (in float64,
    rounded once), the pose's position, forward and right, its field of
    view and, where they are fitted, the disk's texels."""
    r_raw = np.log(np.expm1(np.float64(r_s))).astype(np.float32)
    dev, dt = inp.stack.device, inp.stack.dtype
    out = dict(r_s_raw=torch.tensor(r_raw, device=dev).to(dt),
               cam_pos=pose.pos, cam_fwd_raw=pose.axes[:, 2],
               cam_right_raw=pose.axes[:, 0], fov=pose.fov)
    if disk_slot is not None:
        out["disk_texture"] = inp.stack[disk_slot].clone()
    return out


def fit_trajectory(inp: Inputs, params0: dict, target, disk_slot: int,
                   lr: float, n_steps: int, block_rays=1 << 20):
    """``n_steps`` steps of the fit from ``params0``, recorded as the
    program's are: from step 0, the parameters, Adam's moments and its
    count before each step and after the last, and the losses."""
    params = {k: x.detach().clone() for k, x in params0.items()}
    opt = Adam(params, lr)
    rec = dict(first=0, params=[params], mu=[dict(opt.mu)],
               nu=[dict(opt.nu)], counts=[0], losses=[])
    for _ in range(n_steps):
        loss, grads = loss_and_grad(inp, params, target, disk_slot,
                                    block_rays)
        upd = opt.update(grads)
        params = {k: (x + upd[k]).detach() for k, x in params.items()}
        rec["params"].append(params)
        rec["mu"].append(dict(opt.mu))
        rec["nu"].append(dict(opt.nu))
        rec["counts"].append(opt.count)
        rec["losses"].append(loss)
    return rec


def follow(inp: Inputs, rec: dict, target, disk_slot: int, lr: float,
           block_rays=1 << 20):
    """The reference's step taken from each recorded step's parameters and
    Adam moments before it: its loss, the clipped gradient its optimizer
    takes, its update, and its count of updates after it.  ``rec`` holds
    consecutive steps from overall step ``rec["first"]``: that many updates
    came before its first step, whatever count the record carries."""
    dt = inp.stack.dtype
    out = []
    for k in range(len(rec["losses"])):
        params = {n: x.to(dt) for n, x in rec["params"][k].items()}
        if "disk_texture" in params and not bool(
                (params["disk_texture"][..., 3] == 1.0).all()):
            raise Unsupported("a texel's alpha is off 1: the disk is no "
                              "longer opaque")
        n = int(rec["first"]) + k
        state = {} if n == 0 else dict(
            count=n, mu={m: x.to(dt) for m, x in rec["mu"][k].items()},
            nu={m: x.to(dt) for m, x in rec["nu"][k].items()})
        opt = Adam(params, lr, **state)
        loss, grads = loss_and_grad(inp, params, target, disk_slot,
                                    block_rays)
        upd = opt.update(grads)
        out.append(dict(loss=loss, grad=opt.taken, update=upd,
                        count=opt.count))
    return out


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(x.double()))
            for k, x in tree.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's (``keep``: the leaves that count)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def pixel_gap(img, ref, tol: float):
    """(share of pixels whose largest channel error exceeds ``tol``, the
    mean absolute error), of two (H, W, 4) frames."""
    err = (img.to(torch.float32) - ref.to(torch.float32)).abs()
    worst = err.amax(-1)
    return (float((worst > tol).double().mean()),
            float(err.double().mean()))

