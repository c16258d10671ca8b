"""Phong shading, UV transforms, normal maps and the equirect background
(counterpart of ``schwarzschild_tpu.shading``), bilinear at level 0 or
trilinear over the mip pyramid at a screen-space LOD."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import geometry as geo
from .intersect import Hit
from .scene import (
    OBJECT_TYPE_PLANE,
    OBJECT_TYPE_SPECIAL,
    OBJECT_TYPE_TEST_RAY_CURVED,
    OBJECT_TYPE_TEST_RAY_FLAT,
    Scene,
)
from .textures import (
    Texture,
    TextureStack,
    sample_stack,
    sample_stack_trilinear,
    sample_texture,
    sample_texture_trilinear,
    screen_space_lod,
)

TEST_RAY_CURVED_COLOR = (1.0, 0.0, 0.0, 1.0)  # frag:191
TEST_RAY_FLAT_COLOR = (0.0, 1.0, 0.0, 1.0)  # frag:192


def _gather(table, idx):
    """Per-lane lookup in a small per-material or per-texture table."""
    return table[idx.to(torch.int64)]


def _concrete_none_negative(idx) -> bool:
    """True iff every entry of ``idx`` is < 0 (for example, no material
    uses a normal map): one read of the table, so callers skip the work
    that such entries would need."""
    return bool((idx < 0).all())


class TexelRequest(NamedTuple):
    """A batch of hits' texture-fetch request (see :func:`texel_request`)."""

    u: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor  # int32 stack index
    use_tex: torch.Tensor  # bool: base colour comes from the texture
    uv: torch.Tensor  # (..., 2) post-swap/invert uv (normal-map input)
    cont_u: torch.Tensor  # continuous (before the plane's mod) uv, the
    cont_v: torch.Tensor  # input of the trilinear LOD


def texel_request(hit: Hit, sc: Scene, tex: TextureStack) -> TexelRequest:
    """shade()'s uv pipeline without the fetch: swap/invert (frag:373-380),
    size rescale (frag:384), plane tiling window (frag:387-400)."""
    m = sc.materials
    mi = torch.clamp(hit.mat_idx, 0, m.color.shape[0] - 1)
    texture_index = _gather(m.texture_index, mi)
    invert_uv_x = _gather(m.invert_uv_x, mi)
    invert_uv_y = _gather(m.invert_uv_y, mi)
    swap_uvs = _gather(m.swap_uvs, mi)

    uv = hit.uv
    uv = torch.where(swap_uvs[..., None], torch.flip(uv, [-1]), uv)
    is_plane = hit.obj_type == OBJECT_TYPE_PLANE
    inv_extent = torch.where(is_plane[..., None], hit.plane_tex_size,
                             torch.ones_like(hit.plane_tex_size))
    ux = torch.where(invert_uv_x, inv_extent[..., 0] - uv[..., 0], uv[..., 0])
    uy = torch.where(invert_uv_y, inv_extent[..., 1] - uv[..., 1], uv[..., 1])
    uv = torch.stack([ux, uy], dim=-1)

    tex_sizes = _gather(tex.sizes,
                        torch.clamp(texture_index, 0, tex.sizes.shape[0] - 1))
    rescaled_uv = uv * tex_sizes / tex.max_size
    plane_uv_src = rescaled_uv - hit.plane_tex_offset
    size = torch.clamp_min(hit.plane_tex_size, 1e-12)
    plane_window_uv = plane_uv_src / size
    plane_tiled = torch.remainder(plane_uv_src, hit.plane_tex_size) / size
    in_window = ((plane_window_uv[..., 0] >= 0.0)
                 & (plane_window_uv[..., 0] <= 1.0)
                 & (plane_window_uv[..., 1] >= 0.0)
                 & (plane_window_uv[..., 1] <= 1.0))
    render_color = torch.where(is_plane, hit.plane_repeat | in_window, True)
    sample_uv = torch.where(is_plane[..., None], plane_tiled, rescaled_uv)
    use_tex = (texture_index >= 0) & render_color
    cont_uv = torch.where(is_plane[..., None], plane_uv_src / size,
                          rescaled_uv)
    return TexelRequest(sample_uv[..., 0], sample_uv[..., 1], texture_index,
                        use_tex, uv, cont_uv[..., 0], cont_uv[..., 1])


def shade_from_base(hit: Hit, view_dir, sc: Scene, base_color):
    """Phong lighting and the special-type colours for an already resolved
    ``base_color`` (material colour or fetched texel): :func:`shade`
    without its texture fetches and normal maps."""
    return _shade_lit(hit, view_dir, sc, base_color, nm_rgb=None)


def _shade_lit(hit: Hit, view_dir, sc: Scene, base_color, nm_rgb):
    """Lighting core: flip/cull, optional normal map (``nm_rgb`` raw rgb in
    [0, 1] or None), ambient + per-light Phong, special-type overrides
    (frag:365-438)."""
    m = sc.materials
    mi = torch.clamp(hit.mat_idx, 0, m.color.shape[0] - 1)
    ambient = _gather(m.ambient, mi)
    diffuse_k = _gather(m.diffuse, mi)
    specular_k = _gather(m.specular, mi)
    shininess = _gather(m.shininess, mi)
    double_sided = _gather(m.double_sided_normals, mi)
    flip_normals = _gather(m.flip_normals, mi)

    normal = torch.where(flip_normals[..., None], -hit.normal, hit.normal)
    culled = (~double_sided) & (geo.dot(normal, view_dir) < 0.0)

    if nm_rgb is not None:
        normal_map_index = _gather(m.normal_map_index, mi)
        ts_normal = (nm_rgb[..., 0:1] * hit.tangent
                     + nm_rgb[..., 1:2] * hit.bitangent
                     + nm_rgb[..., 2:3] * normal)
        mapped = geo.safe_normalize(ts_normal)
        normal = torch.where((normal_map_index >= 0)[..., None], mapped,
                             normal)

    final_rgb = ambient[..., None] * base_color[..., :3]  # frag:406

    lt = sc.lights
    for i in range(lt.pos.shape[0]):
        to_light = lt.pos[i] - hit.point
        distance = geo.safe_length(to_light)
        light_dir = to_light / distance[..., None]
        attenuation = 1.0 / (
            lt.attenuation_constant[i]
            + lt.attenuation_linear[i] * distance
            + lt.attenuation_quadratic[i] * distance * distance)
        diff = torch.clamp_min(geo.dot(normal, light_dir), 0.0)
        diffuse = (diffuse_k[..., None] * diff[..., None] * lt.color[i]
                   * base_color[..., :3])
        reflect_dir = geo.reflect(-light_dir, normal)
        spec_dot = torch.clamp_min(geo.dot(view_dir, reflect_dir), 0.0)
        spec = torch.where(spec_dot > 0.0,
                           torch.clamp_min(spec_dot, 1e-30) ** shininess, 0.0)
        specular = specular_k[..., None] * spec[..., None] * lt.color[i]
        final_rgb = final_rgb + (diffuse + specular) * (
            attenuation * lt.intensity[i])[..., None]

    lit = torch.cat([final_rgb, base_color[..., 3:4]], dim=-1)
    out = torch.where(culled[..., None], torch.zeros_like(lit), lit)
    dev = out.device
    for code, rgba in ((OBJECT_TYPE_SPECIAL, (0.0, 0.0, 0.0, 1.0)),
                       (OBJECT_TYPE_TEST_RAY_CURVED, TEST_RAY_CURVED_COLOR),
                       (OBJECT_TYPE_TEST_RAY_FLAT, TEST_RAY_FLAT_COLOR)):
        out = torch.where((hit.obj_type == code)[..., None],
                          torch.tensor(rgba, device=dev), out)
    return out


def shade(hit: Hit, view_dir, sc: Scene,
          tex: Optional[TextureStack] = None,
          trilinear: bool = False) -> torch.Tensor:
    """RGBA (..., 4) lighting for a batch of hits.  ``view_dir`` points
    from the surface to the camera; callers mask by ``hit.valid``.

    ``trilinear``: sample ``tex.mips`` at a screen-space LOD, which needs
    the batch to be an (H, W) image grid; False, or a stack without mips,
    samples level 0 bilinearly, as the reference does."""
    m = sc.materials
    mi = torch.clamp(hit.mat_idx, 0, m.color.shape[0] - 1)
    color = _gather(m.color, mi)
    base_color = color
    nm_rgb = None
    if tex is not None:
        req = texel_request(hit, sc, tex)
        use_mips = trilinear and len(tex.mips) > 0
        if use_mips:
            # LOD from same-object neighbours only (GL's quad derivatives).
            same_key = hit.obj_type * 65536 + mi
            lod = screen_space_lod(req.cont_u * tex.max_size[0],
                                   req.cont_v * tex.max_size[1],
                                   valid=hit.valid, key=same_key)
            sampled = sample_stack_trilinear(tex, req.index, req.u, req.v,
                                             lod)
        else:
            sampled = sample_stack(tex, req.index, req.u, req.v)
        base_color = torch.where(req.use_tex[..., None], sampled, color)
        # Normal map (frag:408-413): the raw rgb in [0, 1], as the
        # reference uses it.  Skipped when no material has one.
        if not _concrete_none_negative(m.normal_map_index):
            normal_map_index = _gather(m.normal_map_index, mi)
            nm_sizes = _gather(
                tex.sizes,
                torch.clamp(normal_map_index, 0, tex.sizes.shape[0] - 1))
            nm_uv = req.uv * nm_sizes / tex.max_size
            if use_mips:
                nm_lod = screen_space_lod(nm_uv[..., 0] * tex.max_size[0],
                                          nm_uv[..., 1] * tex.max_size[1],
                                          valid=hit.valid, key=same_key)
                nm_rgb = sample_stack_trilinear(
                    tex, normal_map_index, nm_uv[..., 0], nm_uv[..., 1],
                    nm_lod)[..., :3]
            else:
                nm_rgb = sample_stack(tex, normal_map_index, nm_uv[..., 0],
                                      nm_uv[..., 1])[..., :3]
    return _shade_lit(hit, view_dir, sc, base_color, nm_rgb)


def equirect_uv(direction):
    """Equirectangular (u, v) of a unit direction (frag:829-835)."""
    u = geo.true_div(torch.atan2(direction[..., 2], direction[..., 0]),
                     math.pi)
    u = torch.where(u < 0.0, u + 2.0, u) * 0.5
    v = geo.true_div(
        torch.asin(torch.clamp(direction[..., 1], -1.0 + 1e-7, 1.0 - 1e-7)),
        math.pi) + 0.5
    return u, v


def get_background(bg: Texture, direction,
                   trilinear: bool = False) -> torch.Tensor:
    """Equirectangular sky sample of a unit direction (frag:829-837);
    ``trilinear`` as in :func:`shade`, over the image grid."""
    u, v = equirect_uv(direction)
    if trilinear and len(bg.mips) > 0:
        h, w = bg.data.shape[-3], bg.data.shape[-2]
        return sample_texture_trilinear(bg, u, v, screen_space_lod(u * w,
                                                                   v * h))
    return sample_texture(bg, u, v)


# Crosshair overlay constants (frag:25-28).
CROSSHAIR_LENGTH = 10.0
CROSSHAIR_WIDTH = 2.0
CROSSHAIR_SPACE = 5.0
CROSSHAIR_COLOR = (0.5, 0.5, 0.5, 0.5)


def crosshair_mask(u, v, width, height):
    """Pixel-space crosshair test (frag:845-855); u, v are NDC."""
    px = torch.abs(u * width / 2.0)
    py = torch.abs(v * height / 2.0)
    vertical = ((px < CROSSHAIR_WIDTH / 2.0) & (py > CROSSHAIR_SPACE)
                & (py < CROSSHAIR_LENGTH + CROSSHAIR_SPACE))
    horizontal = ((py < CROSSHAIR_WIDTH / 2.0) & (px > CROSSHAIR_SPACE)
                  & (px < CROSSHAIR_LENGTH + CROSSHAIR_SPACE))
    return vertical | horizontal
