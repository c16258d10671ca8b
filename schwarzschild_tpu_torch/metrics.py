"""Structured per-frame metrics (counterpart of ``schwarzschild_tpu.metrics``).

A :class:`MetricsLogger` keeps every record in memory and, given a path,
appends it to a JSONL file; the render loops log through it, with the JAX
package's event names and fields, so one reader serves both packages.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics log with wall-clock timestamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._path = Path(path) if path else None
        self._echo = echo
        self._records = []
        if self._path:
            self._path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields):
        rec = {"event": event, "t": time.time(), **fields}
        self._records.append(rec)
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._echo:
            print(json.dumps(rec), flush=True)
        return rec

    @property
    def records(self):
        return list(self._records)

    def to_csv(self, path):
        keys = sorted({k for r in self._records for k in r})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for r in self._records:
                w.writerow(r)


class FrameTimer:
    """Context manager timing one frame on the host clock; logs a "frame"
    event with rays/s and the nominal RK4 steps.

    ``rk4_steps_nominal`` counts the full step budget (frag:914-915), not
    the steps executed: the march stops each ray at its own end (the
    kernels' ``count_steps`` counts those).  Extra fields (host_fetch_ms,
    device_ms_est) ride along through :meth:`add_fields`.
    """

    def __init__(self, logger: MetricsLogger, frame: int, n_rays: int,
                 max_steps: int):
        self._logger = logger
        self._frame = frame
        self._n_rays = n_rays
        self._max_steps = max_steps
        self._extra = {}

    def add_fields(self, **fields):
        self._extra.update(fields)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._logger.log(
            "frame",
            frame=self._frame,
            seconds=dt,
            rays_per_s=self._n_rays / dt,
            rk4_steps_nominal=self._n_rays * self._max_steps,
            nominal_steps_per_s=self._n_rays * self._max_steps / dt,
            **self._extra,
        )
        return False
