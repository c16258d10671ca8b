"""Horizon + sky march and frame (counterpart of ``schwarzschild_tpu.kernel``).

``march_bh`` is the wrapper of the CUDA kernel ``march_bh_kernel``
(csrc/march.cu), which replaces the Pallas kernel ``_march_kernel``.  On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``march_bh_torch``, the plain version: the same per-ray arithmetic as the
kernel, one step at a time over whole tensors.  ``march_bh_diff`` makes the
march differentiable: its backward is the adjoint kernel of
``kernel_scene.march_scene_bwd`` fed the forward's event record.
``render_horizon_sky`` is the BASELINE config-2 frame around it.

The march helpers below are shared with ``kernel_scene`` as
csrc/march_common.cuh is shared by both CUDA kernels.  Divisions by a
Python number go through ``geo.true_div`` so that the plain version rounds
like the kernel on the GPU too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._pytree import tree_map

from . import _ext
from . import camera as cam_mod
from . import geometry as geo
from . import physics
from .config import FLAT, HALF_HEIGHT, HALF_WIDTH, RenderConfig
from .noise import noise_field
from .shading import CROSSHAIR_COLOR, crosshair_mask, get_background
from .textures import Texture, ensure_mips

STATUS_MARCHING = 0.0
STATUS_CAPTURED = 1.0
STATUS_ESCAPED = 2.0


# ---------------------------------------------------------------------------
# Plain march arithmetic (the kernels' math on whole tensors).
# ---------------------------------------------------------------------------


def march_scalars(cfg: RenderConfig):
    """(max_angle, u_f, far_r2) as the kernels get them: computed in double
    and rounded to f32 once, as JAX rounds the Python floats."""
    rf = 1.0 / cfg.u_f
    return (float(np.float32(cfg.max_angle)), float(np.float32(cfg.u_f)),
            float(np.float32(rf * rf)))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _rnorm(x, y, z):
    return 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))


def _len3(x, y, z):
    return torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))


def _guard(x):
    return torch.where(torch.abs(x) < 1e-12, 1e-12, x)


def _tangent_of(nx, ny, nz, dx, dy, dz):
    """normalize(cross(cross(n, d), n)) in jnp.cross's component order."""
    cx = ny * dz - nz * dy
    cy = nz * dx - nx * dz
    cz = nx * dy - ny * dx
    tx = cy * nz - cz * ny
    ty = cz * nx - cx * nz
    tz = cx * ny - cy * nx
    inv = _rnorm(tx, ty, tz)
    return tx * inv, ty * inv, tz * inv


def _sphere_entry(px, py, pz, dx, dy, dz, r2, cx=None, cy=None, cz=None):
    """First positive lambda of a sphere (centre c, default the origin)."""
    if cx is not None:
        px, py, pz = px - cx, py - cy, pz - cz
    d_oc = _dot3(dx, dy, dz, px, py, pz)
    oc2 = _dot3(px, py, pz, px, py, pz)
    disc = d_oc * d_oc - oc2 + r2
    sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
    lam = geo.min_positive(-d_oc - sq, -d_oc + sq)
    return (disc >= 0.0) & (lam >= 0.0), lam


def _init_march(origin, direction, active):
    """Orbital-plane init (frag:865, 883-887) as a dict of planes."""
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    inv = _rnorm(ox, oy, oz)
    nx, ny, nz = ox * inv, oy * inv, oz * inv
    tx, ty, tz = _tangent_of(nx, ny, nz, dx, dy, dz)
    nd0 = _dot3(nx, ny, nz, dx, dy, dz)
    dt0 = _dot3(tx, ty, tz, dx, dy, dz)
    return dict(px=ox, py=oy, pz=oz, dx=dx, dy=dy, dz=dz,
                nx=nx, ny=ny, nz=nz, tx=tx, ty=ty, tz=tz,
                u=inv, du=-inv * nd0 / _guard(dt0),
                phi=torch.zeros_like(inv),
                status=torch.where(active, STATUS_MARCHING, STATUS_ESCAPED),
                live=active.clone())


def _far_field(s, u_f, far_r2):
    """Far-field rule (frag:891-912): re-enter live rays with u < u_f at the
    r = 1/u_f sphere (in place) and return the rays that finish flat."""
    ff = s["live"] & (s["u"] < u_f)
    big_ok, big_lam = _sphere_entry(s["px"], s["py"], s["pz"],
                                    s["dx"], s["dy"], s["dz"], far_r2)
    hx = s["px"] + big_lam * s["dx"]
    hy = s["py"] + big_lam * s["dy"]
    hz = s["pz"] + big_lam * s["dz"]
    inv_h = _rnorm(hx, hy, hz)
    nnx, nny, nnz = hx * inv_h, hy * inv_h, hz * inv_h
    nd = _dot3(nnx, nny, nnz, s["dx"], s["dy"], s["dz"])
    radial = torch.abs(nd) >= 1.0 - geo.EPSILON
    finish = ff & (~big_ok | radial)
    reinit = ff & big_ok & ~radial
    ntx, nty, ntz = _tangent_of(nnx, nny, nnz, s["dx"], s["dy"], s["dz"])
    dt = _dot3(ntx, nty, ntz, s["dx"], s["dy"], s["dz"])
    new = dict(nx=nnx, ny=nny, nz=nnz, tx=ntx, ty=nty, tz=ntz, u=inv_h,
               du=-inv_h * nd / _guard(dt))
    for k, v in new.items():
        s[k] = torch.where(reinit, v, s[k])
    return finish


def _rk4_segment(s, i, r_s, max_steps, max_angle):
    """One RK4 step (frag:914-919) and its Cartesian segment
    (frag:924-928)."""
    step = geo.true_div(max_angle - s["phi"], float(max_steps - i))
    phi = s["phi"] + step
    d_u, d_du = physics.rk4_step(s["u"], s["du"], step, r_s)
    u1 = s["u"] + d_u
    du1 = s["du"] + d_du
    inv_u = 1.0 / torch.clamp_min(u1, 1e-6)
    c, sn = torch.cos(phi), torch.sin(phi)
    npx = (c * s["nx"] + sn * s["tx"]) * inv_u
    npy = (c * s["ny"] + sn * s["ty"]) * inv_u
    npz = (c * s["nz"] + sn * s["tz"]) * inv_u
    ddx, ddy, ddz = npx - s["px"], npy - s["py"], npz - s["pz"]
    seg_len = _len3(ddx, ddy, ddz)
    inv_seg = _rnorm(ddx, ddy, ddz)
    return dict(px=npx, py=npy, pz=npz,
                dx=ddx * inv_seg, dy=ddy * inv_seg, dz=ddz * inv_seg,
                u=u1, du=du1, phi=phi), seg_len


def _advance(s, moved, seg):
    for k, v in seg.items():
        s[k] = torch.where(moved, v, s[k])


def _final_status(s):
    """Rays still marching after max_steps escape to the sky (frag:935)."""
    return torch.where(s["live"], STATUS_ESCAPED, s["status"])


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_events(active, max_steps: int):
    """Event planes before the first step: t_end = max_steps for a ray that
    marches (it keeps that value if it never ends), -1 for one that never
    does."""
    return torch.where(active, float(max_steps), -1.0)


def steps_of(t_end, max_steps: int):
    """Executed lane-steps of a march from its t_end plane: each ray runs
    min(t_end + 1, max_steps) loop iterations (0 if it never marched)."""
    return torch.clamp(t_end.to(torch.int64) + 1, max=max_steps).sum()


def march_bh_torch(origin, direction, active, r_s, cfg: RenderConfig,
                   events: bool = False):
    """Plain version of the horizon + sky march: (final_dir, status), and
    with ``events`` a dict of the ray's end step ``t_end`` and whether it
    moved at that step, ``died_moving`` (see :func:`march_bh`)."""
    r_s = _f32(r_s, origin.device)
    rs2 = r_s * r_s
    max_angle, u_f, far_r2 = march_scalars(cfg)
    s = _init_march(origin, direction, active)
    t_end = init_events(active, cfg.max_steps)
    died_moving = torch.zeros_like(active)
    for i in range(cfg.max_steps):
        if not bool(s["live"].any()):
            break  # every later step is the identity
        live = s["live"]
        finish = _far_field(s, u_f, far_r2)
        bh_hit, _ = _sphere_entry(s["px"], s["py"], s["pz"],
                                  s["dx"], s["dy"], s["dz"], rs2)
        status = torch.where(finish, torch.where(bh_hit, STATUS_CAPTURED,
                                                 STATUS_ESCAPED), s["status"])
        live = live & ~finish
        seg, seg_len = _rk4_segment(s, i, r_s, cfg.max_steps, max_angle)
        escaped = live & (seg["u"] < 0.0)
        status = torch.where(escaped, STATUS_ESCAPED, status)
        live = live & ~escaped
        cap_ok, cap_lam = _sphere_entry(s["px"], s["py"], s["pz"],
                                        seg["dx"], seg["dy"], seg["dz"], rs2)
        captured = live & cap_ok & (cap_lam <= seg_len)
        status = torch.where(captured, STATUS_CAPTURED, status)
        live = live & ~captured
        _advance(s, live | captured, seg)
        t_end = torch.where(finish | escaped | captured, float(i), t_end)
        died_moving = died_moving | captured
        s["status"], s["live"] = status, live
    out = torch.stack([s["dx"], s["dy"], s["dz"]], -1), _final_status(s)
    if events:
        out = out + (dict(t_end=t_end, died_moving=died_moving),)
    return out


# The JAX package's name for its plain twin of the march.
march_bh_jnp = march_bh_torch


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------


def check_rays(origin, direction, active):
    """The march wrappers' input contract: (..., 3) float32 origin and
    direction and a bool ``active`` of the leading shape, contiguous, on one
    device."""
    if origin.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError("origin and direction must be float32")
    if active.dtype != torch.bool:
        raise TypeError("active must be a bool tensor")
    if (origin.shape != direction.shape or origin.shape[-1:] != (3,)
            or origin.shape[:-1] != active.shape):
        raise ValueError(
            f"shapes: origin {tuple(origin.shape)}, direction "
            f"{tuple(direction.shape)}, active {tuple(active.shape)}")
    if not (origin.device == direction.device == active.device):
        raise ValueError("origin, direction and active must share a device")
    if not (origin.is_contiguous() and direction.is_contiguous()
            and active.is_contiguous()):
        raise ValueError("origin, direction and active must be contiguous")
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {origin.device}")


def compact_march(march_fn, origin, direction, active):
    """Run ``march_fn(origin, direction, active)`` with the active rays
    packed into the leading lanes: a stable permutation from two cumsums
    (actives in order, then the rest), so a sparse mask leaves whole warp
    tiles idle instead of every tile partly live.  Per ray the results are
    bit-identical; only the layout the kernel sees changes.  Differentiable
    (the permutation is an index_copy and an index_select).

    ``origin``/``direction`` (H, W, 3), ``active`` (H, W); ``march_fn``
    returns a nest of (H, W[, ...]) planes, unpacked back to the image's
    order."""
    n = active.numel()
    a = active.reshape(n)
    ai = a.to(torch.int64)
    pos = torch.where(a, torch.cumsum(ai, 0) - 1,
                      ai.sum() + torch.cumsum(1 - ai, 0) - 1)

    def pack(x):
        flat = x.reshape((n,) + x.shape[active.dim():])
        return flat.new_zeros(flat.shape).index_copy(0, pos, flat).reshape(
            x.shape)

    def unpack(x):
        flat = x.reshape((n,) + x.shape[active.dim():])
        return flat.index_select(0, pos).reshape(x.shape)

    out = march_fn(pack(origin), pack(direction), pack(active))
    return tree_map(unpack, out)


def march_bh(origin, direction, active, r_s, cfg: RenderConfig,
             events: bool = False, count_steps: bool = False, mesh=None,
             compact: bool = False):
    """Horizon + sky march of (..., 3) rays: (final_dir (..., 3), status
    (...,) float32 in {1 captured, 2 escaped}).

    ``events=True`` appends a dict: ``t_end``, the step of each ray's
    terminal event (``max_steps`` if it used up its steps, -1 if it never
    marched), and ``died_moving``, whether it moved at that step: true for a
    capture on a segment, false for an escape or a flat finish, even one
    that ends captured (the unbounded horizon test of a far-field ray).
    ``count_steps=True`` appends the executed lane-steps, the sum over rays
    of their loop iterations (an int64 scalar tensor).

    A CUDA tensor launches ``march_bh_kernel`` (counted in
    ``march_bh.launches``); a CPU tensor runs :func:`march_bh_torch`.
    ``mesh`` (a ``DeviceMesh``, see ``sharding.make_mesh``) marches this
    rank's tile of the (H, W) rays, one launch, and returns the full
    planes on every rank (``sharding.shard_march``).  ``compact=True``
    packs the active rays into the leading lanes first
    (:func:`compact_march`; under a mesh, within each tile); it takes no
    ``events`` or ``count_steps``."""
    if (events or count_steps) and compact:
        raise ValueError("events and count_steps: non-compact marches only")
    if mesh is not None:
        if count_steps:
            raise ValueError("count_steps: a march on one device only")
        from .sharding import shard_march

        return shard_march(mesh, functools.partial(
            march_bh, cfg=cfg, events=events, compact=compact))(
                origin, direction, active, r_s)
    if compact:
        return compact_march(
            lambda o, d, a: march_bh(o, d, a, r_s, cfg), origin, direction,
            active)
    check_rays(origin, direction, active)
    want = events or count_steps
    if origin.device.type == "cpu":
        fdir, status, ev = march_bh_torch(origin, direction, active, r_s, cfg,
                                          events=True)
    else:
        dev = origin.device
        fdir = torch.empty_like(origin)
        status = torch.empty(active.shape, dtype=torch.float32, device=dev)
        ev = dict(t_end=None, died_moving=None)  # null: the kernel skips them
        if want:
            ev = dict(t_end=torch.empty_like(status),
                      died_moving=torch.empty_like(active))
        n = active.numel()
        if n:
            max_angle, u_f, far_r2 = march_scalars(cfg)
            lib = _ext.library()
            # An (H, W) image's warps march 4 x 8 tiles; a 1-D batch is
            # one row.
            width = active.shape[-1] if active.dim() else 1
            rc = lib.march_bh_launch(
                _ext.ptr(origin), _ext.ptr(direction), _ext.ptr(active),
                n // width, width,
                _ext.ptr(fdir), _ext.ptr(status), _ext.ptr(ev["t_end"]),
                _ext.ptr(ev["died_moving"]), n,
                float(np.float32(float(r_s))), cfg.max_steps, max_angle,
                u_f, far_r2, _ext.stream_ptr(dev))
            _ext.check(rc, "march_bh")
            march_bh.launches += 1
    out = (fdir, status)
    if events:
        out = out + (ev,)
    if count_steps:
        out = out + (steps_of(ev["t_end"], cfg.max_steps),)
    return out


march_bh.launches = 0


class _MarchBhDiff(torch.autograd.Function):
    """The horizon + sky march with the adjoint kernel as its backward: the
    forward records each ray's end step and whether it moved there, which
    fixes every decision the backward replays (n_slots = 0, no fpos)."""

    @staticmethod
    def forward(ctx, origin, direction, r_s, active, cfg):
        fdir, status, ev = march_bh(origin, direction, active, r_s, cfg,
                                    events=True)
        ctx.save_for_backward(origin, direction, r_s, ev["t_end"],
                              ev["died_moving"])
        ctx.cfg = cfg
        ctx.mark_non_differentiable(status)
        return fdir, status

    @staticmethod
    def backward(ctx, g_fdir, _g_status):
        from .kernel_scene import march_scene_bwd

        origin, direction, r_s, t_end, died_moving = ctx.saved_tensors
        g_fdir = (torch.zeros_like(origin) if g_fdir is None
                  else g_fdir.contiguous())
        g_o, g_d, g_rs = march_scene_bwd(
            origin, direction, r_s, ctx.cfg,
            (g_fdir, torch.zeros_like(origin), []), None,
            dict(t_end=t_end, ssteps=[], died_moving=died_moving), n_slots=0)
        return g_o, g_d, g_rs.reshape(r_s.shape), None, None


def march_bh_diff(origin, direction, active, r_s, cfg: RenderConfig,
                  mesh=None, compact: bool = False):
    """Differentiable :func:`march_bh`: (final_dir, status), with gradients
    to origin, direction and r_s at the decisions the forward took.  The
    JAX package takes its backward from jax.vjp of a jnp replay of the
    whole march; here it is the adjoint kernel (``march_scene_bwd``), the
    same fixed-decision gradient.  ``mesh`` and ``compact`` as
    :func:`march_bh`'s: each rank's adjoint runs on its own tile, and a
    compacted march's on the packed rays."""
    if mesh is not None:
        from .sharding import shard_march

        return shard_march(mesh, functools.partial(
            march_bh_diff, cfg=cfg, compact=compact))(origin, direction,
                                                      active, r_s)
    if compact:
        return compact_march(
            lambda o, d, a: march_bh_diff(o, d, a, r_s, cfg), origin,
            direction, active)
    r_s = _f32(r_s, origin.device)
    return _MarchBhDiff.apply(origin, direction, r_s, active, cfg)


# ---------------------------------------------------------------------------
# Frame.
# ---------------------------------------------------------------------------


def grid_planes(cam, cfg: RenderConfig, device):
    """The frame's grid quantities, computed on the full H x W grid: a dict
    of ``origin`` and ``direction`` (H, W, 3), ``u_ndc`` and ``v_ndc``
    (H, W) and ``rnd`` (H, W), the noise field (zeros with noise off).
    They depend on absolute pixel coordinates, so a strip or tile of a
    frame takes its part of them (:func:`take_pixels`), never recomputes
    them on its own grid."""
    H, W = cfg.height, cfg.width
    u, v = cam_mod.pixel_grid(W, H, device=device)
    origin, direction = cam_mod.generate_rays(cam, u, v, W, H)
    return dict(origin=origin, direction=direction, u_ndc=u, v_ndc=v,
                rnd=noise_field(cfg, u, v))


def _index(sel):
    """A row or column selection as an index: None (all), a (start, stop)
    pair, a range, or an integer index tensor."""
    if sel is None:
        return slice(None)
    if isinstance(sel, tuple):
        return slice(*sel)
    if isinstance(sel, range):
        return slice(sel.start, sel.stop, sel.step)
    return sel


def take_pixels(planes, rows=None, cols=None):
    """``planes`` (a dict of (H, W, ...) tensors) restricted to image
    ``rows`` and ``cols``, each None, (start, stop), a range or an integer
    index tensor (indices may repeat or wrap)."""
    r, c = _index(rows), _index(cols)
    return {name: x[r][:, c] for name, x in planes.items()}


def pixel_masks(planes, cfg: RenderConfig):
    """Per-pixel masks and the crosshair layer from given planes (those of
    :func:`grid_planes`, or any part of them): a dict with u, v, origin,
    direction, base (crosshair overlay), flat_px, noise_skip, march_px and
    normal_vec0.  Every value is a function of its own pixel's planes."""
    if cfg.texture_filter not in ("bilinear", "trilinear"):
        raise ValueError(f"unknown texture_filter {cfg.texture_filter!r}")
    H, W = cfg.height, cfg.width
    u, v = planes["u_ndc"], planes["v_ndc"]
    # Contiguous, as the march wrappers take them (a tile is a view).
    origin = planes["origin"].contiguous()
    direction = planes["direction"].contiguous()
    device = u.device
    batch = u.shape

    base = torch.zeros(batch + (4,), device=device)
    if cfg.crosshair:
        ch = crosshair_mask(u, v, W, H)
        base = torch.where(ch[..., None],
                           torch.tensor(CROSSHAIR_COLOR, device=device), base)

    if cfg.raytrace_type == FLAT:
        mode_flat = torch.ones(batch, dtype=torch.bool, device=device)
    elif cfg.raytrace_type == HALF_WIDTH:
        mode_flat = u > 2.0 * cfg.curved_percentage - 1.0
    elif cfg.raytrace_type == HALF_HEIGHT:
        mode_flat = v > 2.0 * cfg.curved_percentage - 1.0
    else:
        mode_flat = torch.zeros(batch, dtype=torch.bool, device=device)

    normal_vec0 = geo.safe_normalize(origin)
    flat_px = mode_flat | physics.is_radial(direction, normal_vec0)
    if cfg.percent_black >= 0.0 and cfg.noise_mode != "none":
        noise_skip = ~flat_px & (planes["rnd"] <= cfg.percent_black)
    else:
        noise_skip = torch.zeros(batch, dtype=torch.bool, device=device)
    return dict(u=u, v=v, origin=origin, direction=direction, base=base,
                flat_px=flat_px, noise_skip=noise_skip,
                march_px=~flat_px & ~noise_skip, normal_vec0=normal_vec0)


def pixel_setup(cam, cfg: RenderConfig, device, rows=None, cols=None):
    """Rays and per-pixel masks shared by the frames (see
    :func:`pixel_masks`) of the image ``rows`` and ``cols`` (see
    :func:`take_pixels`; default the whole frame), every value equal to
    the full frame's at that pixel: the grid quantities are built at full
    size and then selected."""
    return pixel_masks(take_pixels(grid_planes(cam, cfg, device), rows, cols),
                       cfg)


def soft_shadow_alphas(origin, direction, normal_vec0, flat_pos, flat_dir,
                       r_s, softness):
    """Soft silhouette weights (render.py:297-329 of the JAX package):
    sigmoids of the photon's conserved impact parameter against
    b_crit = 3 sqrt(3)/2 r_s for marched rays, and of the straight-line
    impact parameter against r_s for straight rays.  Returns
    (alpha_curved, alpha_flat)."""
    dev = origin.device
    s_soft = _f32(softness, dev)
    tangent_vec0 = geo.safe_normalize(
        geo.cross(geo.cross(normal_vec0, direction), normal_vec0))
    u0 = 1.0 / geo.length(origin)
    dt0 = geo.dot(direction, tangent_vec0)
    dt0 = torch.where(torch.abs(dt0) < 1e-12, 1e-12, dt0)
    du0 = -u0 * geo.dot(direction, normal_vec0) / dt0
    e0 = du0 * du0 + u0 * u0 * (1.0 - r_s * u0)
    b_geo = 1.0 / torch.sqrt(torch.clamp_min(e0, 1e-20))
    b_crit = _f32(1.5, dev) * torch.sqrt(_f32(3.0, dev)) * r_s
    b_flat = geo.safe_length(geo.cross(flat_pos, flat_dir))
    return (torch.sigmoid((b_crit - b_geo) / s_soft),
            torch.sigmoid((r_s - b_flat) / s_soft))


def render_horizon_sky(cam, cfg: RenderConfig, background: Texture, r_s=1.0,
                       *, mesh=None, differentiable=False):
    """Config-2 frame: empty scene (horizon + equirect sky) marched by
    :func:`march_bh`, then one background gather.  (H, W, 4) RGBA on the
    device of ``background``.  ``differentiable=True`` marches through
    :func:`march_bh_diff`, so gradients reach ``r_s``, the camera's tensors
    and the background texels.  ``cfg.texture_filter="trilinear"`` samples
    the sky's mips, built here when ``background`` carries none.  ``mesh``
    marches each rank's tile of the frame (see :func:`march_bh`) and
    composes the full frame on every rank."""
    dev = background.data.device
    r_s = _f32(r_s, dev)
    px = pixel_setup(cam, cfg, dev)
    trilinear = cfg.texture_filter == "trilinear"
    if trilinear:
        background, _ = ensure_mips(background)
    origin, direction = px["origin"], px["direction"]
    flat_px, noise_skip = px["flat_px"], px["noise_skip"]

    march = march_bh_diff if differentiable else march_bh
    final_dir, status = march(origin, direction, px["march_px"], r_s, cfg,
                              mesh=mesh)

    # Flat pixels: one horizon-sphere test + sky (frag:874-877).
    d_oc = geo.dot(direction, origin)
    disc = d_oc * d_oc - geo.square_vector(origin) + r_s * r_s
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    lam = geo.min_positive(-d_oc - sq, -d_oc + sq)
    flat_bh = (disc >= 0.0) & (lam >= 0.0)

    captured = torch.where(flat_px, flat_bh, status == STATUS_CAPTURED)
    use_dir = torch.where(flat_px[..., None], direction, final_dir)
    bg = get_background(background, use_dir, trilinear=trilinear)
    black = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    zero = torch.zeros(4, device=dev)

    if cfg.horizon_softness > 0.0:
        alpha_curved, alpha_flat = soft_shadow_alphas(
            origin, direction, px["normal_vec0"], origin, direction, r_s,
            cfg.horizon_softness)
        alpha_sh = torch.where(flat_px, alpha_flat, alpha_curved)
        bg_scale = (1.0 - alpha_sh)[..., None]
        color = torch.where(
            noise_skip[..., None], zero,
            torch.where(captured[..., None], black, 0.0) + bg * bg_scale)
    else:
        color = torch.where(noise_skip[..., None], zero,
                            torch.where(captured[..., None], black, bg))
    return px["base"] + color
