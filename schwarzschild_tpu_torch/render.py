"""The dense differentiable renderer, noise fields and image output
(counterpart of ``schwarzschild_tpu.render``).

:func:`render` is the per-pixel program of black_hole.frag:843-936 as a
dense, branch-free state machine over the whole ray batch, the JAX
package's correctness twin of the march kernels: GLSL's break and return
become per-ray flags updated with ``torch.where``; the march is a loop of
RK4 steps, each intersecting and shading its segment against the whole
scene, optionally checkpointed in chunks (``cfg.checkpoint_every``); the
"finish flat" exits are deferred to one flat-intersection pass after the
loop.  Every step is plain PyTorch, differentiable by autograd in the
camera, r_s, the scene's tensors and the texels.  It is the renderer the
JAX package's ``inverse.make_loss``, ``inverse.fit`` and
``animation.render_trajectory`` default to and the gradient oracle of
``adjoint``'s ``backward="twin"``.

PNG files are written by :func:`encode_png`, on the standard library's
zlib alone, so no frame writer needs an imaging package.  The noise
fields are in ``noise.py``.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import geometry as geo
from .config import FLAT, RenderConfig
from .intersect import TestRay, intersect_scene
from .kernel import (_far_field, _init_march, _rk4_segment, march_scalars,
                     pixel_setup)
from .scene import OBJECT_TYPE_SPECIAL, Scene
from .shading import get_background, shade
from .textures import Texture, TextureStack, ensure_mips

class MarchState(NamedTuple):
    active: torch.Tensor  # (...,) bool: still marching
    u: torch.Tensor
    du: torch.Tensor
    phi: torch.Tensor
    normal_vec: torch.Tensor  # (..., 3)
    tangent_vec: torch.Tensor  # (..., 3)
    pos: torch.Tensor  # (..., 3) current ray origin
    direction: torch.Tensor  # (..., 3)
    color: torch.Tensor  # (..., 4) accumulated
    captured: torch.Tensor  # (...,) bool: ended on an opaque horizon hit
    flat_finish: torch.Tensor  # (...,) bool: run the flat pass at the end
    add_bg: torch.Tensor  # (...,) bool: add the background at the end


class RenderContext(NamedTuple):
    """What the composition after the march needs besides the march state:
    the crosshair layer, the flat-pixel mask and the initial orbital-plane
    (u, du) for the soft horizon's impact parameter (the split
    :func:`_prepare` -> :func:`_run_march` -> :func:`_finalize` lets a
    tool replay the march step by step)."""

    base: torch.Tensor  # (..., 4) crosshair layer
    flat_px: torch.Tensor  # (...,) bool
    u0: torch.Tensor  # (...,) initial inverse radius
    du0: torch.Tensor  # (...,) initial du/dphi
    background: Texture
    tex: Optional[TextureStack]


def _planes(state: MarchState):
    """The march state as kernel.py's dict of planes."""
    s = dict(u=state.u, du=state.du, phi=state.phi, live=state.active)
    for prefix, vec in (("p", state.pos), ("d", state.direction),
                        ("n", state.normal_vec), ("t", state.tangent_vec)):
        for c, x in zip("xyz", vec.unbind(-1)):
            s[prefix + c] = x
    return s


def _vec(s, prefix):
    return torch.stack([s[prefix + c] for c in "xyz"], -1)


def _march_step(state: MarchState, i: int, sc: Scene, cfg: RenderConfig,
                r_s, tex: Optional[TextureStack],
                test_ray: Optional[TestRay]) -> MarchState:
    """One iteration of the marching loop (frag:890-933).  The geodesic
    arithmetic is the march kernels' plane-wise helpers (kernel.py), called
    as their plain versions call them: two algebraically equal
    realizations differ in the last ulp, which the near-photon-sphere
    trajectories grow into visible pixels."""
    max_angle, u_f, far_r2 = march_scalars(cfg)
    active = state.active
    s = _planes(state)

    # Far-field flat-space rule (frag:891-912): re-enter at the 1/u_f
    # sphere, or finish flat after the march.
    finish_flat = _far_field(s, u_f, far_r2)
    active = active & ~finish_flat
    flat_finish = state.flat_finish | finish_flat

    # RK4 step and its Cartesian segment (frag:914-928).
    seg, seg_len = _rk4_segment(s, i, r_s, cfg.max_steps, max_angle)
    escaped = active & (seg["u"] < 0.0)  # frag:921-922: dir stays pre-step
    add_bg = state.add_bg | escaped
    active = active & ~escaped
    new_pos, new_dir = _vec(seg, "p"), _vec(seg, "d")

    # Segment intersection and shading (frag:930-932).
    hit = intersect_scene(state.pos, new_dir, seg_len, sc, r_s, test_ray)
    rgba = shade(hit, -new_dir, sc, tex,
                 trilinear=cfg.texture_filter == "trilinear")
    color = state.color + torch.where((hit.valid & active)[..., None], rgba,
                                      0.0)
    opaque = active & hit.valid & (rgba[..., 3] == 1.0)
    active = active & ~opaque
    # Horizon captures, for the soft silhouette (cfg.horizon_softness).
    captured = state.captured | (opaque & (hit.obj_type
                                           == OBJECT_TYPE_SPECIAL))

    # Frozen rays keep their previous pos, dir, u, du and phi.
    moved = active | opaque
    return MarchState(
        active=active,
        u=torch.where(moved, seg["u"], state.u),
        du=torch.where(moved, seg["du"], state.du),
        phi=torch.where(moved, seg["phi"], state.phi),
        normal_vec=_vec(s, "n"),
        tangent_vec=_vec(s, "t"),
        pos=torch.where(moved[..., None], new_pos, state.pos),
        direction=torch.where(moved[..., None], new_dir, state.direction),
        color=color,
        captured=captured,
        flat_finish=flat_finish,
        add_bg=add_bg,
    )


def render(sc: Scene, cam, cfg: RenderConfig, background: Texture,
           tex: Optional[TextureStack] = None, r_s=1.0,
           test_ray: Optional[TestRay] = None,
           rows=None, cols=None) -> torch.Tensor:
    """Render an (H, W, 4) RGBA image on the device of ``background``,
    differentiable in ``r_s``, the camera's tensors, the scene's tensors
    and the texels.

    ``rows=(r0, r1)`` renders only image rows [r0, r1) of the full
    cfg.height frame, equal to ``render(...)[r0:r1]`` (the grid quantities
    are built at full size and then selected); strips bound the peak
    memory of a large frame.  ``cols`` likewise selects columns; each of
    ``rows`` and ``cols`` may also be a range or an integer index tensor
    (a tile of a sharded frame, see ``sharding.make_tile_render``).
    ``test_ray`` draws the debug tubes.
    ``cfg.checkpoint_every`` (dividing ``max_steps``) runs the march in
    chunks under ``torch.utils.checkpoint``, which saves only each
    chunk's input state for the backward; the image is the same.

    ``cfg.texture_filter="trilinear"`` samples the textures' mips (built
    here where a texture carries none) at a screen-space LOD over the
    frame's grid; with ``rows=`` that grid is the strip, so the LOD of a
    strip's first and last rows takes the strip's wrapped neighbours
    (``torch.roll``), as the JAX package's does, and can differ from the
    whole frame's there (a selection with a one-pixel halo, cropped
    after, gives the whole frame's)."""
    dev = background.data.device
    r_s = torch.as_tensor(r_s, dtype=torch.float32, device=dev)
    state, ctx = _prepare(sc, cam, cfg, background, tex, r_s, rows=rows,
                          cols=cols)
    if cfg.raytrace_type != FLAT:
        state = _run_march(state, sc, cfg, r_s, ctx.tex, test_ray)
    return _finalize(state, ctx, sc, cfg, r_s, test_ray)


def _prepare(sc, cam, cfg, background, tex, r_s, rows=None, cols=None):
    """Rays, dispatch masks and the initial march state (frag:850-887),
    with kernel.py's pixel setup and orbital-plane init; the mips of a
    trilinear frame."""
    px = pixel_setup(cam, cfg, background.data.device, rows=rows, cols=cols)
    if cfg.texture_filter == "trilinear":
        background, tex = ensure_mips(background, tex)
    origin, direction = px["origin"], px["direction"]
    s = _init_march(origin, direction, px["march_px"])
    batch = px["flat_px"].shape
    no = torch.zeros(batch, dtype=torch.bool, device=origin.device)
    state = MarchState(
        active=px["march_px"], u=s["u"], du=s["du"], phi=s["phi"],
        normal_vec=_vec(s, "n"), tangent_vec=_vec(s, "t"), pos=origin,
        direction=direction,
        color=torch.zeros(batch + (4,), device=origin.device),
        captured=no, flat_finish=no, add_bg=no)
    return state, RenderContext(base=px["base"], flat_px=px["flat_px"],
                                u0=s["u"], du0=s["du"],
                                background=background, tex=tex)


def _finalize(state: MarchState, ctx: RenderContext, sc, cfg, r_s,
              test_ray=None):
    """Composition after the march: the deferred flat pass, the
    background, the soft horizon (frag:874-877, 894-907, 935)."""
    batch = state.u.shape
    dev = state.u.device
    tex = ctx.tex
    add_bg = state.add_bg | state.active  # exhausted marchers (frag:935)

    # Deferred flat pass: initial flat pixels trace their camera ray,
    # far-field finishers their frozen (pos, dir).
    do_flat = ctx.flat_px | state.flat_finish
    flat_hit = intersect_scene(state.pos, state.direction,
                               torch.full(batch, -1.0, device=dev), sc, r_s,
                               test_ray)
    trilinear = cfg.texture_filter == "trilinear"
    flat_rgba = shade(flat_hit, -state.direction, sc, tex,
                      trilinear=trilinear)
    flat_color = torch.where((flat_hit.valid & do_flat)[..., None],
                             flat_rgba, 0.0)
    flat_needs_bg = do_flat & (flat_color[..., 3] != 1.0)
    bg = get_background(ctx.background, state.direction,
                        trilinear=trilinear)
    color = state.color + flat_color

    if cfg.horizon_softness > 0.0:
        # The soft silhouette: coverage alpha = sigmoid((b_crit - b) / s)
        # of the photon's conserved impact parameter b against the shadow
        # radius b_crit = 3 sqrt(3) / 2 r_s (the straight-line one against
        # r_s for flat-path pixels); every background contribution is
        # scaled by 1 - alpha, and captures add it instead of black.
        s_soft = torch.tensor(cfg.horizon_softness, dtype=torch.float32,
                              device=dev)
        u0, du0 = ctx.u0, ctx.du0
        e0 = du0 * du0 + u0 * u0 * (1.0 - r_s * u0)
        b_geo = 1.0 / torch.sqrt(torch.clamp_min(e0, 1e-20))
        b_crit = (torch.tensor(1.5, device=dev)
                  * torch.sqrt(torch.tensor(3.0, device=dev)) * r_s)
        b_flat = geo.safe_length(geo.cross(state.pos, state.direction))
        alpha = torch.where(do_flat, torch.sigmoid((r_s - b_flat) / s_soft),
                            torch.sigmoid((b_crit - b_geo) / s_soft))
        flat_captured = (flat_hit.valid & do_flat
                         & (flat_hit.obj_type == OBJECT_TYPE_SPECIAL)
                         & (flat_rgba[..., 3] == 1.0))
        bg_mask = flat_needs_bg | add_bg | state.captured | flat_captured
        color = color + torch.where(bg_mask[..., None],
                                    bg * (1.0 - alpha)[..., None], 0.0)
    else:
        color = color + torch.where((flat_needs_bg | add_bg)[..., None], bg,
                                    0.0)
    return ctx.base + color


def _run_march(state: MarchState, sc, cfg: RenderConfig, r_s, tex,
               test_ray) -> MarchState:
    """``cfg.max_steps`` march steps; with ``checkpoint_every`` below
    ``max_steps``, in chunks of that many steps, each under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes a
    chunk from its saved input state.  A step after every ray has stopped
    is the identity, so the loop ends there (the JAX package's scan runs
    them all).  The check reads the card once a step; the loop's host
    dispatch is slower than the card, so the reads cost no measured time
    (PERF.md, with the steps the check skips)."""

    def chunk(first, count, *fields):
        st = MarchState(*fields)
        for i in range(first, first + count):
            if not bool(st.active.any()):
                break
            st = _march_step(st, i, sc, cfg, r_s, tex, test_ray)
        return tuple(st)

    ck = cfg.checkpoint_every
    if not ck or ck >= cfg.max_steps:
        return MarchState(*chunk(0, cfg.max_steps, *state))
    if cfg.max_steps % ck:
        raise ValueError(
            f"checkpoint_every={ck} must divide max_steps={cfg.max_steps}")
    for first in range(0, cfg.max_steps, ck):
        state = MarchState(*checkpoint(chunk, first, ck, *state,
                                       use_reentrant=False))
    return state


def to_uint8(img):
    """Clamp and quantize like the display framebuffer."""
    return (torch.clamp(img[..., :3], 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(rgb_uint8, compress_level: int = 6) -> bytes:
    """An (H, W, 3) uint8 image (numpy or a tensor) as the bytes of an 8-bit
    RGB PNG file: every row with filter 0 (none), one zlib stream at
    ``compress_level`` (0-9; zlib releases the GIL while it compresses)."""
    if isinstance(rgb_uint8, torch.Tensor):
        rgb_uint8 = rgb_uint8.cpu().numpy()
    img = np.ascontiguousarray(rgb_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: the filter byte
    raw[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(),
                                                compress_level))
            + _png_chunk(b"IEND", b""))


def save_png(img, path, compress_level: int = 6):
    """Write an (H, W, 3+) float image, quantized by :func:`to_uint8`, as a
    PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img), compress_level))
