"""The yardstick's work counts: the card's peaks, the f32 operations of a
march step, and the bytes each kernel must at least move.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.  A share is
stated against them with the card's power limit beside it.

Operations per executed step, counted from the CUDA sources of the
program's march kernels (``csrc/march_common.cuh`` and ``csrc/march.cu``)
and frozen here as ``chip_smoke.py`` lists them (lines 191-220 there):
the scene step is RK4 and its segment (91), the far-field, escape and
capture tests and the horizon entry (27), the window and select (3) and the
hit logic (4), 125 in all, with no table tests, so that a better cull can
never read above 100%.  The adjoint's step is its forward once (92) and its
reverse once (184), and each ray pays the init (56) and its reverse (120);
what the kernel recomputes by design is left out.

The executed steps come from the benchmark's own plain march
(``reference.render.march_counts``) at the cell's inputs, with the march
stopping at a ray's first opaque hit: the least any implementation needs.
"""

from __future__ import annotations

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

OPS_SCENE_STEP = 125
OPS_BWD_STEP = 92 + 184
OPS_BWD_RAY = 56 + 120

# Bytes per marched ray.  In: origin and direction (f32 x 3 each) and the
# active flag.  Out: final direction and position (f32 x 3 each), status
# and hit count (f32), and per slot its segment's start, direction (f32 x 3
# each) and length; with events, the end step and each slot's step.
MARCH_IN = 12 + 12 + 1


def march_out(n_slots: int, events: bool) -> int:
    return 12 + 12 + 4 + 4 + n_slots * 28 + ((4 + 4 * n_slots) if events
                                              else 0)


# The adjoint reads the rays, the cotangents of the final direction and
# position and of every slot's segment, and the events; it writes the
# gradients of origin and direction and a per-ray r_s partial.
def bwd_in(n_slots: int) -> int:
    return 24 + 24 + n_slots * 28 + 4 + 4 * n_slots


BWD_OUT = 24 + 4


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def march_bound_s(steps: int, rays: int, n_slots: int,
                  events: bool = False) -> float:
    return bound_s(steps * OPS_SCENE_STEP,
                   rays * (MARCH_IN + march_out(n_slots, events)))


def bwd_bound_s(steps: int, rays: int, n_slots: int) -> float:
    return bound_s(steps * OPS_BWD_STEP + rays * OPS_BWD_RAY,
                   rays * (bwd_in(n_slots) + BWD_OUT))
