"""Tile sharding of a frame over the ranks of ``torch.distributed``, and
frame parallelism across processes (counterpart of
``schwarzschild_tpu.sharding``).

The reference's only parallelism is the GPU rasterizer running the
fragment shader per pixel.  Here the H x W image is cut into tiles over
a mesh of ranks, one card each: mesh axis "x" splits image rows, axis "y"
columns.  Every rank holds the scene, camera and textures whole, renders
its own tile, and ``all_gather`` assembles the full image on every rank,
as the JAX package's ``shard_map`` returns a global array.  Pixel tiles
need no halo, except for the trilinear LOD of the dense renderer (one
pixel, see :func:`make_tile_render`).  Where H or W does not divide the
mesh, the planes are padded to the next multiple (padded lanes are
inactive or march nothing, and are cropped).

Gradients run through a pair of ``autograd.Function``s: the replicated
inputs pass through :class:`_Replicated` (identity forward; the backward
sums each cotangent over the ranks) and the tiles through
:class:`_GatherTiles` (``all_gather`` forward; the backward takes the
rank's own tile of the replicated cotangent).  So a loss computed alike on
every rank from the full image gives every rank the exact gradient in
r_s, the camera, the scene's tensors and the texels: no world-size factor
and no hand-written sum.

The tile functions (:func:`tile_of`, :func:`march_tile`,
:func:`make_tile_render`, :func:`assemble`) need no process group: one
process can render every tile of a mesh in turn and assemble them, which
is how a single card checks the meshes it cannot hold.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_flatten, tree_unflatten

from .config import RenderConfig, resolve_device
from .textures import build_atlas_cached

# What a padded lane of each plane holds: an inert ray (radial, so the
# frames' own rule takes it off the march), no noise, no pixel position.
_PAD = dict(origin=(1.0, 0.0, 0.0), direction=(1.0, 0.0, 0.0), u_ndc=0.0,
            v_ndc=0.0, rnd=0.0)


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, device=None):
    """Join a process group of ``num_processes`` ranks; a no-op for one
    process or fewer.  NCCL for the card (each rank takes the card of its
    local rank, ``LOCAL_RANK`` or ``process_id`` modulo the cards), gloo
    for ``device="cpu"``.  ``coordinator`` is "host:port" (TCP), any
    ``init_method`` URL (e.g. "file:///..."), or None for torchrun's
    environment (``env://``); ``process_id`` None reads ``RANK``."""
    if num_processes is None or num_processes <= 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        local = (int(local) if local is not None
                 else (process_id or 0) % torch.cuda.device_count())
        torch.cuda.set_device(local)
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=num_processes,
        rank=-1 if process_id is None else process_id)


def make_mesh(devices=None, shape=None, axis_names=("x", "y")):
    """A ``DeviceMesh`` over every rank of the default process group.
    ``shape`` defaults to (world, 1): all ranks split image rows.
    ``devices`` is the mesh's device type, by default the group's: "cuda"
    under NCCL, "cpu" under gloo."""
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(devices, tuple(shape),
                            mesh_dim_names=tuple(axis_names[:len(shape)]))


def mesh_shape(mesh):
    """(row tiles, column tiles) of a mesh."""
    shape = tuple(mesh.shape)
    return shape[0], shape[1] if len(shape) > 1 else 1


def _mesh_coord(mesh):
    c = mesh.get_coordinate()
    return c[0], c[1] if len(c) > 1 else 0


def tile_size(height: int, width: int, shape):
    """(tile rows, tile columns): the image padded to the next multiple of
    the mesh shape, divided by it."""
    return -(-height // shape[0]), -(-width // shape[1])


def tile_of(x, height: int, width: int, shape, coord, fill=0.0):
    """The tile at ``coord`` of an (H, W, ...) plane, (th, tw, ...) and
    contiguous, its lanes past the image's edge set to ``fill`` (a number
    or, for an (H, W, 3) plane, a 3-vector).  Differentiable."""
    th, tw = tile_size(height, width, shape)
    r0, c0 = coord[0] * th, coord[1] * tw
    part = x[r0:r0 + th, c0:c0 + tw]
    if part.shape[:2] == (th, tw):
        return part.contiguous()
    out = torch.empty((th, tw) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    out[...] = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    out[:part.shape[0], :part.shape[1]] = part
    return out


def assemble(tiles, height: int, width: int, shape):
    """The (H, W, ...) plane of a mesh's tiles, listed by coordinate in
    row-major order, cropped to the image."""
    rows = [torch.cat(tiles[i * shape[1]:(i + 1) * shape[1]], dim=1)
            for i in range(shape[0])]
    return torch.cat(rows, dim=0)[:height, :width]


class _Replicated(torch.autograd.Function):
    """Inputs every rank holds whole: identity forward; the backward sums
    each cotangent over the ranks (a rank's holds only its tile's part)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous().clone()
            dist.all_reduce(g)
            out.append(g)
        return tuple(out)


def _replicate(tree):
    """``tree`` with its tensors that require grad passed through one
    :class:`_Replicated`; returns (tree, those tensors)."""
    leaves, spec = tree_flatten(tree)
    at = [i for i, x in enumerate(leaves)
          if torch.is_tensor(x) and x.requires_grad]
    if not at:
        return tree, ()
    outs = _Replicated.apply(*(leaves[i] for i in at))
    for i, x in zip(at, outs):
        leaves[i] = x
    return tree_unflatten(leaves, spec), outs


class _GatherTiles(torch.autograd.Function):
    """Every rank's tiles -> the full planes on every rank (``all_gather``
    over the default group, assembled by the ranks' mesh coordinates).
    The backward takes the rank's own tile of each cotangent.  The
    replicated inputs ride along as ``anchors`` with zero gradients, so
    that :class:`_Replicated`'s backward, which holds the collective, runs
    on every rank even where a tile does not depend on them."""

    @staticmethod
    def forward(ctx, layout, n_tiles, *args):
        height, width, shape, _, order = layout
        ctx.layout = layout
        ctx.anchors = [(a.shape, a.dtype, a.device) for a in args[n_tiles:]]
        world = dist.get_world_size()
        outs = []
        for t in args[:n_tiles]:
            send = t.contiguous()
            if send.dtype == torch.bool:  # gloo gathers no bools
                send = send.to(torch.uint8)
            got = [torch.empty_like(send) for _ in range(world)]
            dist.all_gather(got, send)
            full = assemble([got[r] for r in order], height, width, shape)
            outs.append(full.to(t.dtype))
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        height, width, shape, coord, _ = ctx.layout
        tiles = [None if g is None or not g.is_floating_point()
                 else tile_of(g, height, width, shape, coord)
                 for g in grads]
        zeros = [torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.anchors]
        return (None, None) + tuple(tiles) + tuple(zeros)


def _gather(mesh, height, width, tiles, anchors=()):
    """The full planes of this rank's ``tiles`` on every rank."""
    order = [int(r) for r in mesh.mesh.flatten().tolist()]
    layout = (height, width, mesh_shape(mesh), _mesh_coord(mesh), order)
    return _GatherTiles.apply(layout, len(tiles), *tiles, *anchors)


def march_tile(march_fn, shape, coord, origin, direction, active, r_s,
               *rep_args):
    """``march_fn`` on the tile at ``coord`` of the (H, W) rays: padded
    lanes are inactive, with a zero origin and a unit-x direction."""
    H, W = active.shape
    return march_fn(tile_of(origin, H, W, shape, coord, 0.0),
                    tile_of(direction, H, W, shape, coord, _PAD["direction"]),
                    tile_of(active, H, W, shape, coord, False), r_s,
                    *rep_args)


def shard_march(mesh, march_fn):
    """Wrap a march (a partial of ``kernel.march_bh``,
    ``kernel_scene.march_scene`` or their ``_diff`` twins) to run on this
    rank's tile of the mesh and return the full planes on every rank.

    The wrapped function takes (origin (H, W, 3), direction (H, W, 3),
    active (H, W), r_s, *replicated_args); ``march_fn`` must return a
    nest of tuples, lists and dicts whose tensor leaves are (h, w)- or
    (h, w, ...)-shaped planes of its tile (slots stacked on a leading axis
    are not).  Each rank launches the kernel once, on its tile.  A
    differentiable march keeps its adjoint kernel as the backward, run on
    the rank's tile (the JAX package replays the march with a scan under a
    mesh instead)."""
    shape = mesh_shape(mesh)
    coord = _mesh_coord(mesh)

    def wrapped(origin, direction, active, r_s, *rep_args):
        H, W = active.shape
        r_s = torch.as_tensor(r_s, dtype=torch.float32, device=origin.device)
        (origin, direction, r_s), anchors = _replicate(
            (origin, direction, r_s))
        leaves, spec = tree_flatten(march_tile(
            march_fn, shape, coord, origin, direction, active, r_s,
            *rep_args))
        at = [i for i, x in enumerate(leaves) if torch.is_tensor(x)]
        full = _gather(mesh, H, W, [leaves[i] for i in at], anchors)
        for i, x in zip(at, full):
            leaves[i] = x
        return tree_unflatten(leaves, spec)

    return wrapped


def make_tile_render(cfg: RenderConfig, renderer: str = "jnp",
                     n_slots: int = 4, shape=(1, 1),
                     differentiable: bool = False):
    """``tile(coord, sc, cam, background, tex, r_s)`` -> the (th, tw, 4)
    tile at ``coord`` of a mesh of ``shape``, padded past the image's edge
    with zeros; every kept pixel equals the unsharded frame's.

    * "fast": ``kernel_scene.render_fast`` on the tile's part of the
      frame's grid quantities (``precomputed=``), built on the full grid;
      its padded lanes are radial rays, which the frame takes off the
      march.  The tile's composition compacts its own 8 x 128 tiles.
      ``tile`` takes the fetch atlas as ``atlas=`` (default: render_fast
      builds or reuses it).  Bilinear only: a trilinear frame composes on
      the full grid (``make_sharded_render`` marches it with
      ``render_fast(mesh=)``).  ``differentiable`` as render_fast's.
    * "jnp": the dense ``render.render`` of the tile's rows and columns.
      A trilinear tile renders with a one-pixel halo, wrapped modulo H and
      W as ``torch.roll`` wraps, on each axis the mesh splits, and is then
      cropped, so its LOD takes the full frame's neighbours."""
    H, W = cfg.height, cfg.width
    th, tw = tile_size(H, W, shape)
    trilinear = cfg.texture_filter == "trilinear"
    if renderer == "fast":
        if trilinear:
            raise ValueError("a trilinear fast frame composes on the full "
                             "grid: it has no tile function")
        from .kernel import grid_planes
        from .kernel_scene import render_fast

        def tile(coord, sc, cam, background, tex=None, r_s=1.0,
                 atlas=None):
            planes = grid_planes(cam, cfg, background.data.device)
            part = {k: tile_of(v, H, W, shape, coord, _PAD[k])
                    for k, v in planes.items()}
            return render_fast(sc, None, cfg, background, tex, r_s,
                               n_slots=n_slots, overflow="ignore",
                               differentiable=differentiable,
                               precomputed=part, atlas=atlas)
    elif renderer == "jnp":
        from .render import render

        def span(start, stop, n, halo):
            if not halo:
                return range(start, stop)
            return torch.tensor([(start - 1) % n, *range(start, stop),
                                 stop % n])

        def tile(coord, sc, cam, background, tex=None, r_s=1.0):
            r0, c0 = coord[0] * th, coord[1] * tw
            r1, c1 = min(r0 + th, H), min(c0 + tw, W)
            dev = background.data.device
            out = torch.zeros((th, tw, 4), device=dev)
            if r1 <= r0 or c1 <= c0:
                return out
            halo = (trilinear and shape[0] > 1, trilinear and shape[1] > 1)
            img = render(sc, cam, cfg, background, tex, r_s,
                         rows=span(r0, r1, H, halo[0]),
                         cols=span(c0, c1, W, halo[1]))
            img = img[int(halo[0]):img.shape[0] - int(halo[0]),
                      int(halo[1]):img.shape[1] - int(halo[1])]
            out[:r1 - r0, :c1 - c0] = img
            return out
    else:
        raise ValueError(f"unknown renderer {renderer!r}")
    return tile


def make_sharded_render(mesh, cfg: RenderConfig, renderer: str = "jnp",
                        n_slots: int = 4, differentiable: bool = False):
    """``render(sc, cam, background, tex=None, r_s=1.0)`` -> the (H, W, 4)
    frame on every rank, each rank rendering its tile of ``mesh``.

    ``renderer``: "jnp" (the dense differentiable ``render.render``) or
    "fast" (``render_fast``; ``differentiable`` routes its march through
    the adjoint kernel).  Bilinear, both run tile-local (see
    :func:`make_tile_render`); trilinear "fast" marches through
    ``render_fast(mesh=)`` and composes on the full grid on every rank,
    which needs H and W to divide the mesh.  The image stays connected to
    autograd through the gather."""
    H, W = cfg.height, cfg.width
    shape = mesh_shape(mesh)
    if renderer == "fast" and cfg.texture_filter == "trilinear":
        if H % shape[0] or W % shape[1]:
            raise ValueError(f"trilinear fast path: image {H}x{W} must "
                             f"divide mesh {shape[0]}x{shape[1]}")
        from .kernel_scene import render_fast

        def sharded(sc, cam, background, tex=None, r_s=1.0):
            return render_fast(sc, cam, cfg, background, tex, r_s,
                               n_slots=n_slots, overflow="ignore",
                               differentiable=differentiable, mesh=mesh)
        return sharded

    tile = make_tile_render(cfg, renderer, n_slots, shape, differentiable)
    coord = _mesh_coord(mesh)

    def sharded(sc, cam, background, tex=None, r_s=1.0):
        r_s = torch.as_tensor(r_s, dtype=torch.float32,
                              device=background.data.device)
        (sc, cam, background, tex, r_s), anchors = _replicate(
            (sc, cam, background, tex, r_s))
        extra = {}
        if renderer == "fast":
            # The fetch atlas of the replicated textures, built once for a
            # pair of textures (each call, differentiably, for texels that
            # require grad) and handed to the tile's render_fast.
            extra["atlas"] = build_atlas_cached(background, tex)
        img = tile(coord, sc, cam, background, tex, r_s, **extra)
        return _gather(mesh, H, W, [img], anchors)[0]

    return sharded


def gather_image(img):
    """The image on the host as a numpy array.  Sharded frames are whole
    on every rank already (gathered by the renderers), so every rank gets
    the same array."""
    return img.detach().cpu().numpy()


def _process_group():
    """(rank, world size) of the default process group, or (0, 1) when
    torch.distributed is not initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def frame_range_for_process(n_frames: int, process_id=None,
                            n_processes=None):
    """The contiguous slab of a trajectory's frames that one process
    renders: ceil(n_frames / n_processes) frames each, the last slabs
    shorter or empty."""
    rank, world = _process_group()
    pid = rank if process_id is None else process_id
    n = world if n_processes is None else n_processes
    per = -(-n_frames // n)
    lo = min(pid * per, n_frames)
    hi = min(lo + per, n_frames)
    return range(lo, hi)
