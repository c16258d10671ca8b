"""The plain per-ray arithmetic of the reference renderer: plain PyTorch on
whole tensors, importing nothing of the program.

These functions are frozen copies of the port's plain versions at the
benchmark's first commit (``geometry``, ``physics``, ``kernel``'s march
helpers, ``intersect``'s sphere and hollow-disk candidates, ``shading``,
``textures``' bilinear sampler, ``camera``'s rays and ``noise``'s hash),
pruned to what the benchmark's scenes use, with the same operation order:
one ulp near the photon sphere grows into a visible pixel, so a
reimplementation that rounds differently would read as a fault.  Later
changes to the program do not reach them.  Every function computes in the
floating type of its inputs, so the same code runs the float32 reference
and its lower-precision control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EPSILON = 1e-7  # black_hole.frag:30
_TINY = 1e-20
_DIV_GUARD = 1e-12
_TWO_PI = 2.0 * math.pi
OBJECT_TYPE_SPECIAL = -42  # the horizon sphere
OBJECT_TYPE_SPHERE = 0
OBJECT_TYPE_HOLLOW_DISK = 3


# ---------------------------------------------------------------------------
# Vectors.
# ---------------------------------------------------------------------------


def true_div(a, b):
    """``a / b`` rounded once: a Python divisor becomes a tensor first."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


def dot(a, b):
    return _sum3(a * b)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def mat_vec(m, v):
    return _sum3(m * v[..., None, :])


def mat_tvec(m, v):
    p = m * v[..., :, None]
    return p[..., 0, :] + p[..., 1, :] + p[..., 2, :]


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def safe_length(v, eps=1e-24):
    return torch.sqrt(torch.clamp_min(dot(v, v), eps))


def safe_normalize(v, eps=1e-24):
    return v * (1.0 / torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def reflect(incident, normal):
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def min_positive(n1, n2):
    both = (n1 > 0) & (n2 > 0)
    return torch.where(both, torch.minimum(n1, n2),
                       torch.where(n1 > 0, n1, torch.where(n2 > 0, n2, -1.0)))


# ---------------------------------------------------------------------------
# Camera rays and the noise mask.
# ---------------------------------------------------------------------------


def pixel_ndc(rows, width: int, height: int, dtype, device):
    """NDC (u, v) of pixel centres of image ``rows`` [r0, r1), each
    (r1 - r0, width); the full grid's values at those pixels."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(rows[0], rows[1], dtype=dtype, device=device)
    u = true_div(2.0 * (xs + 0.5), float(width)) - 1.0
    v = 1.0 - true_div(2.0 * (ys + 0.5), float(height))
    n = rows[1] - rows[0]
    return (u[None, :].expand(n, width).contiguous(),
            v[:, None].expand(n, width).contiguous())


def camera_rays(pos, axes, fov, u, v, width: int, height: int):
    """Pinhole rays (black_hole.frag:859-863): (origin, direction)."""
    forward_len = 1.0 / torch.tan(true_div(fov, 360.0) * math.pi)
    uv_vec = torch.stack(
        [u, v * (height / width), forward_len.expand(u.shape)], dim=-1)
    direction = normalize(mat_vec(axes, uv_vec))
    origin = pos.expand(direction.shape).contiguous()
    return origin, direction


_M32 = 0xFFFFFFFF


def hash_rand_np(width: int, height: int, seed: int = 0) -> np.ndarray:
    """The lowbias32 per-pixel uniform of the reference's default noise
    (frag:879-881 with the hash field), (height, width) float32."""
    u32 = np.uint32
    y = np.broadcast_to(np.arange(height, dtype=np.int64)[:, None],
                        (height, width)).astype(u32)
    x = np.broadcast_to(np.arange(width, dtype=np.int64)[None, :],
                        (height, width)).astype(u32)
    seed_term = ((seed & _M32) * 0x9E3779B9) & _M32
    with np.errstate(over="ignore"):
        h = y * u32(width) + x + u32(seed_term)
        h = h ^ (h >> u32(16))
        h = h * u32(0x7FEB352D)
        h = h ^ (h >> u32(15))
        h = h * u32(0x846CA68B)
        h = h ^ (h >> u32(16))
    return h.astype(np.float32) * np.float32(2.3283064365386963e-10)


# ---------------------------------------------------------------------------
# The geodesic march (Binet form, RK4 in phi).
# ---------------------------------------------------------------------------


def march_scalars(max_steps: int, max_revolutions: int, u_f: float):
    """(max_angle, u_f, far_r2), each rounded to float32 once."""
    max_angle = 2.0 * float(max_revolutions) * math.pi
    rf = 1.0 / u_f
    return (float(np.float32(max_angle)), float(np.float32(u_f)),
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
    cx = ny * dz - nz * dy
    cy = nz * dx - nx * dz
    cz = nx * dy - ny * dx
    tx = cy * nz - cz * ny
    ty = cz * nx - cx * nz
    tz = cx * ny - cy * nx
    inv = _rnorm(tx, ty, tz)
    return tx * inv, ty * inv, tz * inv


def _sphere_entry(px, py, pz, dx, dy, dz, r2):
    d_oc = _dot3(dx, dy, dz, px, py, pz)
    oc2 = _dot3(px, py, pz, px, py, pz)
    disc = d_oc * d_oc - oc2 + r2
    sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
    lam = min_positive(-d_oc - sq, -d_oc + sq)
    return (disc >= 0.0) & (lam >= 0.0), lam


def init_march(origin, direction):
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
                phi=torch.zeros_like(inv))


def far_field(s, live, u_f, far_r2):
    """Far-field rule (frag:891-912): re-enter live rays with u < u_f at
    the r = 1/u_f sphere (in place in ``s``); returns the rays that finish
    flat."""
    ff = live & (s["u"] < u_f)
    big_ok, big_lam = _sphere_entry(s["px"], s["py"], s["pz"],
                                    s["dx"], s["dy"], s["dz"], far_r2)
    hx = s["px"] + big_lam * s["dx"]
    hy = s["py"] + big_lam * s["dy"]
    hz = s["pz"] + big_lam * s["dz"]
    inv_h = _rnorm(hx, hy, hz)
    nnx, nny, nnz = hx * inv_h, hy * inv_h, hz * inv_h
    nd = _dot3(nnx, nny, nnz, s["dx"], s["dy"], s["dz"])
    radial = torch.abs(nd) >= 1.0 - EPSILON
    finish = ff & (~big_ok | radial)
    reinit = ff & big_ok & ~radial
    ntx, nty, ntz = _tangent_of(nnx, nny, nnz, s["dx"], s["dy"], s["dz"])
    dt = _dot3(ntx, nty, ntz, s["dx"], s["dy"], s["dz"])
    new = dict(nx=nnx, ny=nny, nz=nnz, tx=ntx, ty=nty, tz=ntz, u=inv_h,
               du=-inv_h * nd / _guard(dt))
    for k, v in new.items():
        s[k] = torch.where(reinit, v, s[k])
    return finish


def _ddu(u, r_s):
    return -u * (1.0 - 1.5 * r_s * u)


def _rk4_step(u, du, delta_phi, r_s):
    k1 = du
    l1 = _ddu(u, r_s)
    k2 = du + 0.5 * l1 * delta_phi
    l2 = _ddu(u + 0.5 * k1 * delta_phi, r_s)
    k3 = du + 0.5 * l2 * delta_phi
    l3 = _ddu(u + 0.5 * k2 * delta_phi, r_s)
    k4 = du + l3 * delta_phi
    l4 = _ddu(u + k3 * delta_phi, r_s)
    h6 = true_div(delta_phi, 6.0)
    return (h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4),
            h6 * (l1 + 2.0 * l2 + 2.0 * l3 + l4))


def rk4_segment(s, i, r_s, max_steps, max_angle):
    """One RK4 step (frag:914-919) and its Cartesian segment
    (frag:924-928)."""
    step = true_div(max_angle - s["phi"], float(max_steps - i))
    phi = s["phi"] + step
    d_u, d_du = _rk4_step(s["u"], s["du"], step, r_s)
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


def is_radial(direction, normal_vec):
    return torch.abs(dot(direction, normal_vec)) >= 1.0 - EPSILON


# ---------------------------------------------------------------------------
# Intersections: the horizon, spheres and hollow disks (frag:457-517).
# ---------------------------------------------------------------------------


class Hit(NamedTuple):
    valid: torch.Tensor
    dist: torch.Tensor
    point: torch.Tensor
    tangent: torch.Tensor
    bitangent: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    obj_type: torch.Tensor
    mat_idx: torch.Tensor


def _safe_div(a, b):
    guarded = torch.where(torch.abs(b) < _DIV_GUARD,
                          torch.where(b < 0, -_DIV_GUARD, _DIV_GUARD), b)
    return a / guarded


def _phi_of(local_x, local_z):
    degenerate = (local_x * local_x + local_z * local_z
                  < _DIV_GUARD * _DIV_GUARD)
    x = torch.where(degenerate, 0.0, local_x)
    z = torch.where(degenerate, 1.0, local_z)
    phi = torch.atan2(x, z)
    return torch.where(phi < 0.0, phi + _TWO_PI, phi)


def _within(lam, max_lambda):
    return (lam >= 0.0) & ((max_lambda < 0.0) | (lam <= max_lambda))


def _local_tangent(phi):
    cp, sp = torch.cos(phi), torch.sin(phi)
    return cp, sp, torch.stack([cp, torch.zeros_like(cp), -sp], dim=-1)


def _sphere_lambda(o, d, ml, pos, radius):
    oc = o - pos
    d_oc = dot(d, oc)
    disc = d_oc * d_oc - dot(oc, oc) + radius * radius
    sqrt_d = torch.sqrt(torch.clamp_min(disc, _TINY))
    lam = min_positive(-d_oc - sqrt_d, -d_oc + sqrt_d)
    return lam, (disc >= 0.0) & _within(lam, ml)


def _plane_lambda(o, d, ml, pos, axes):
    normal = axes[..., :, 1]
    denom = dot(normal, d)
    lam = _safe_div(dot(normal, pos - o), denom)
    valid = (torch.abs(denom) >= EPSILON) & _within(lam, ml)
    return lam, valid


def _hollow_lambda(o, d, ml, pos, axes, inner, outer):
    lam, valid = _plane_lambda(o, d, ml, pos, axes)
    point = o + d * lam[..., None]
    sq = dot(point - pos, point - pos)
    return lam, point, valid & (sq >= inner * inner) & (sq <= outer * outer)


def _candidates(valid, lam, point, o, tangent, bitangent, normal, uv,
                obj_type, mat_idx):
    dist = safe_length(point - o)
    n = valid.shape
    return Hit(valid, torch.where(valid, dist, math.inf), point, tangent,
               bitangent, normal, uv,
               torch.full(n, obj_type, dtype=torch.int32,
                          device=valid.device),
               torch.broadcast_to(mat_idx.to(torch.int32), n))


def _sphere_candidates(o, d, ml, pos, axes, radius, mat_idx, obj_type):
    lam, valid = _sphere_lambda(o, d, ml, pos, radius)
    point = o + lam[..., None] * d
    disp = point - pos
    normal = safe_normalize(disp, _TINY)
    local = mat_tvec(axes, disp)
    phi = _phi_of(local[..., 0], local[..., 2])
    theta = torch.asin(torch.clamp(_safe_div(local[..., 1], radius),
                                   -1.0 + 1e-7, 1.0 - 1e-7))
    uv = torch.stack([true_div(phi, _TWO_PI),
                      true_div(theta, math.pi) + 0.5], dim=-1)
    cp, sp, tangent_local = _local_tangent(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    bitangent_local = torch.stack([sp * ct, st, cp * ct], dim=-1)
    return _candidates(valid, lam, point, o, mat_vec(axes, tangent_local),
                       mat_vec(axes, bitangent_local), normal, uv, obj_type,
                       mat_idx)


def _hollow_candidates(o, d, ml, hd):
    lam, point, valid = _hollow_lambda(o, d, ml, hd["pos"], hd["axes"],
                                       hd["inner"], hd["outer"])
    pos, axes = hd["pos"], hd["axes"]
    inner, outer = hd["inner"], hd["outer"]
    disp = point - pos
    local = mat_tvec(axes, disp)
    phi = _phi_of(local[..., 0], local[..., 2])
    r_local = safe_length(local)
    tangent = safe_normalize(disp, _TINY)
    _, _, bl = _local_tangent(phi)
    bitangent = mat_vec(axes, bl)
    normal = torch.broadcast_to(axes[..., :, 1], point.shape)
    uv = torch.stack([_safe_div(r_local - inner, outer - inner),
                      true_div(phi, _TWO_PI)], dim=-1)
    return _candidates(valid, lam, point, o, tangent, bitangent, normal, uv,
                       OBJECT_TYPE_HOLLOW_DISK, hd["mat"])


def _horizon(r_s, like):
    """The horizon as a one-row sphere table: radius r_s at the origin."""
    dt, dev = like.dtype, like.device
    return (torch.zeros((1, 3), dtype=dt, device=dev),
            torch.eye(3, dtype=dt, device=dev)[None],
            r_s.to(dt).reshape(1),
            torch.zeros((1,), dtype=torch.int32, device=dev))


def any_hit(origin, direction, max_lambda, sc, r_s):
    """Whether the segment hits anything: the horizon, a sphere or a hollow
    disk (the validity tests of :func:`intersect` alone)."""
    o, d, ml = origin[..., None, :], direction[..., None, :], \
        max_lambda[..., None]
    pos, _, rad, _ = _horizon(r_s, origin)
    hit = _sphere_lambda(o, d, ml, pos, rad)[1].any(-1)
    sp = sc["spheres"]
    if sp["radius"].shape[0]:
        hit = hit | _sphere_lambda(o, d, ml, sp["pos"],
                                   sp["radius"])[1].any(-1)
    hd = sc["hollow"]
    if hd["inner"].shape[0]:
        hit = hit | _hollow_lambda(o, d, ml, hd["pos"], hd["axes"],
                                   hd["inner"], hd["outer"])[2].any(-1)
    return hit


def _merge(a: Hit, b: Hit) -> Hit:
    better = b.dist < a.dist
    bv = better[..., None]
    return Hit(*(torch.where(better if x.dim() == better.dim() else bv, y, x)
                 for x, y in zip(a, b)))


def _reduce(c: Hit, best):
    scalar = {Hit._fields.index(f) for f in ("valid", "dist", "obj_type",
                                             "mat_idx")}
    for i in range(c.valid.shape[-1]):
        h = Hit(*(x[..., i] if j in scalar else x[..., i, :]
                  for j, x in enumerate(c)))
        best = h if best is None else _merge(best, h)
    return best


def intersect(origin, direction, max_lambda, sc, r_s) -> Hit:
    """Closest hit against the horizon, the spheres and the hollow disks,
    in that order; ties keep the earlier (frag:755-822)."""
    o, d, ml = origin[..., None, :], direction[..., None, :], \
        max_lambda[..., None]
    best = _reduce(_sphere_candidates(o, d, ml, *_horizon(r_s, origin),
                                      obj_type=OBJECT_TYPE_SPECIAL), None)
    sp = sc["spheres"]
    if sp["radius"].shape[0]:
        best = _reduce(_sphere_candidates(o, d, ml, sp["pos"], sp["axes"],
                                          sp["radius"], sp["mat"],
                                          OBJECT_TYPE_SPHERE), best)
    if sc["hollow"]["inner"].shape[0]:
        best = _reduce(_hollow_candidates(o, d, ml, sc["hollow"]), best)
    return best


# ---------------------------------------------------------------------------
# Textures and shading (frag:365-438, 829-837).
# ---------------------------------------------------------------------------


def bilinear(data, layer, u, v):
    """GL_LINEAR + GL_REPEAT sample of ``data`` (T, H, W, 4) at ``layer``,
    texel centres at (i + 0.5) / W; lerps as ``a + f * (b - a)``, which
    keeps an alpha of 1 at 1.  Gathers by ``index_select`` (its backward
    is a scatter-add)."""
    h, w = data.shape[-3], data.shape[-2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.where(x0i == w - 1, 0, x0i + 1)
    y1i = torch.where(y0i == h - 1, 0, y0i + 1)
    flat = data.reshape(-1, data.shape[-1])
    base = layer.to(torch.int64) * (h * w)

    def take(idx):
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (flat.shape[-1],)).to(u.dtype)

    c00 = take(base + y0i * w + x0i)
    c10 = take(base + y0i * w + x1i)
    c01 = take(base + y1i * w + x0i)
    c11 = take(base + y1i * w + x1i)
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return top + fy * (bot - top)


def background(sky, direction):
    """Equirectangular sky sample of a unit direction (frag:829-837)."""
    u = true_div(torch.atan2(direction[..., 2], direction[..., 0]), math.pi)
    u = torch.where(u < 0.0, u + 2.0, u) * 0.5
    v = true_div(torch.asin(torch.clamp(direction[..., 1], -1.0 + 1e-7,
                                        1.0 - 1e-7)), math.pi) + 0.5
    return bilinear(sky[None], torch.zeros_like(u, dtype=torch.int64), u, v)


def _stack_sample(stack, index, u, v):
    idx = torch.clamp(index, 0, stack.shape[0] - 1)
    return bilinear(stack, torch.broadcast_to(idx, u.shape), u, v)


def shade(hit: Hit, view_dir, sc, stack, sizes, max_size):
    """RGBA lighting of a batch of hits: the uv pipeline (swap, invert,
    rescale by the texture's true size), the base colour from the stack,
    the normal map, ambient plus per-light Phong, the horizon's black
    (frag:365-438).  Planes are not supported: their tiling window is left
    out."""
    m = sc["materials"]
    mi = torch.clamp(hit.mat_idx, 0, m["color"].shape[0] - 1).to(torch.int64)
    color = m["color"][mi]
    tex_index = m["texture_index"][mi]
    uv = hit.uv
    uv = torch.where(m["swap_uvs"][mi][..., None], torch.flip(uv, [-1]), uv)
    ones = torch.ones_like(uv)
    ux = torch.where(m["invert_uv_x"][mi], ones[..., 0] - uv[..., 0],
                     uv[..., 0])
    uy = torch.where(m["invert_uv_y"][mi], ones[..., 1] - uv[..., 1],
                     uv[..., 1])
    uv = torch.stack([ux, uy], dim=-1)
    tex_sizes = sizes[torch.clamp(tex_index, 0, sizes.shape[0] - 1)
                      .to(torch.int64)]
    rescaled = uv * tex_sizes / max_size
    sampled = _stack_sample(stack, tex_index, rescaled[..., 0],
                            rescaled[..., 1])
    base_color = torch.where((tex_index >= 0)[..., None], sampled, color)
    nm_rgb = None
    if bool((m["normal_map_index"] >= 0).any()):
        nm_index = m["normal_map_index"][mi]
        nm_sizes = sizes[torch.clamp(nm_index, 0, sizes.shape[0] - 1)
                         .to(torch.int64)]
        nm_uv = uv * nm_sizes / max_size
        nm_rgb = _stack_sample(stack, nm_index, nm_uv[..., 0],
                               nm_uv[..., 1])[..., :3]

    normal = torch.where(m["flip_normals"][mi][..., None], -hit.normal,
                         hit.normal)
    culled = (~m["double_sided"][mi]) & (dot(normal, view_dir) < 0.0)
    if nm_rgb is not None:
        ts_normal = (nm_rgb[..., 0:1] * hit.tangent
                     + nm_rgb[..., 1:2] * hit.bitangent
                     + nm_rgb[..., 2:3] * normal)
        normal = torch.where((nm_index >= 0)[..., None],
                             safe_normalize(ts_normal), normal)
    final_rgb = m["ambient"][mi][..., None] * base_color[..., :3]
    lt = sc["lights"]
    for i in range(lt["pos"].shape[0]):
        to_light = lt["pos"][i] - hit.point
        distance = safe_length(to_light)
        light_dir = to_light / distance[..., None]
        attenuation = 1.0 / (lt["att_constant"][i]
                             + lt["att_linear"][i] * distance
                             + lt["att_quadratic"][i] * distance * distance)
        diff = torch.clamp_min(dot(normal, light_dir), 0.0)
        diffuse = (m["diffuse"][mi][..., None] * diff[..., None]
                   * lt["color"][i] * base_color[..., :3])
        reflect_dir = reflect(-light_dir, normal)
        spec_dot = torch.clamp_min(dot(view_dir, reflect_dir), 0.0)
        spec = torch.where(spec_dot > 0.0,
                           torch.clamp_min(spec_dot, 1e-30)
                           ** m["shininess"][mi], 0.0)
        specular = m["specular"][mi][..., None] * spec[..., None] \
            * lt["color"][i]
        final_rgb = final_rgb + (diffuse + specular) * (
            attenuation * lt["intensity"][i])[..., None]
    lit = torch.cat([final_rgb, base_color[..., 3:4]], dim=-1)
    out = torch.where(culled[..., None], torch.zeros_like(lit), lit)
    black = torch.tensor((0.0, 0.0, 0.0, 1.0), dtype=out.dtype,
                         device=out.device)
    return torch.where((hit.obj_type == OBJECT_TYPE_SPECIAL)[..., None],
                       black, out)
