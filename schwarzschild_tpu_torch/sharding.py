"""Frame parallelism across processes (the part of
``schwarzschild_tpu.sharding`` that the animation module needs).

The multi-GPU tile sharding of a frame is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch.distributed as dist


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
