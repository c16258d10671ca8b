"""Build management (counterpart of ``schwarzschild_tpu.compile_cache``;
the analog of the reference's shader_utils, shader_utils.cpp:7-32).

nvcc is this package's compiler: ``_ext.build`` compiles csrc/ into a
library named after a digest of its sources and flags, so a build is
reused until a source or flag changes.  These helpers give the two
affordances the reference had: keep compiled artifacts across runs, and
compile up front, with errors surfaced at a defined point, not on the
first frame.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import torch

from . import _ext


def enable_persistent_cache(directory: Optional[str] = None) -> Path:
    """Build and look up the CUDA library in ``directory`` (created if
    missing); None keeps the default, ``_build/`` beside the package.
    Returns the directory."""
    path = (_ext.DEFAULT_BUILD_DIR if directory is None
            else Path(directory).expanduser())
    path.mkdir(parents=True, exist_ok=True)
    _ext.BUILD_DIR = path
    return path


def aot_compile(fn, *example_args, **example_kwargs):
    """Build every CUDA extension now (where a card is present), then run
    ``fn`` once on the example arguments; returns ``(fn, stats)``.

    Build errors surface here, as compileShader's log does, instead of
    mid-frame.  ``stats``: ``build_seconds`` (0.0 when the library was
    built before or no card is present: the CPU runs the plain versions),
    ``first_call_seconds`` (synchronized on the card) and ``peak_bytes``,
    the device memory the first call took above its resting level (None
    without a card)."""
    cuda = torch.cuda.is_available()
    build_seconds = 0.0
    if cuda:
        t0 = time.perf_counter()
        _ext.build()
        _ext.library()
        build_seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn(*example_args, **example_kwargs)
    if cuda:
        torch.cuda.synchronize()
    stats = dict(build_seconds=build_seconds,
                 first_call_seconds=time.perf_counter() - t0,
                 peak_bytes=(torch.cuda.max_memory_allocated() - resting
                             if cuda else None))
    return fn, stats
