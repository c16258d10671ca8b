"""Reading the profiler's trace of the traced window: the device's busy
time, its idle gaps and what the host was doing in them, and the kernels
that per-layer metrics read.

The window runs under ``torch.profiler`` (CPU and CUDA activities) with a
span of the benchmark's own around each frame or step
(``portbench.frame``, ``portbench.step``).  The trace is exported to a
temporary file in the run's temporary directory, read back and deleted.
The traced window is the first span's start to the last span's end; the
device is busy where any kernel, copy or fill ran in it (the union of
their intervals), and idle elsewhere.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def export(prof) -> list:
    """The profiler's events, through a temporary chrome-trace file."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str, n: int = 64) -> str:
    return name if len(name) <= n else name[:n]


def summarize(events: list, span_prefix: str = "portbench.") -> dict:
    """The traced window's kernels (name, start us, duration us), its
    length and busy time in seconds, the spans in it, and the breakdown:
    the ten device operations that took most time and the ten longest
    idle gaps, each named by the host operation that launched the device
    work ending it."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(span_prefix)]
    if not spans:
        return dict(kernels=[], window_s=0.0, busy_s=0.0, spans=0,
                    breakdown=dict(device_ops=[], idle_gaps=[]))
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev
               if e.get("cat") == "kernel"]
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                              w1)) for e in dev]
    busy = _union(clipped)
    busy_us = sum(e - s for s, e in busy)

    by_name = defaultdict(float)
    for e in dev:
        by_name[_short(e["name"])] += float(e["dur"]) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # Idle gaps, each named by the host op that launched the device work
    # that ends it (the innermost op around its runtime call).
    gaps = []
    prev = w0
    starts = {}
    for e in dev:
        starts.setdefault(max(float(e["ts"]), w0), e)
    for s, e in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    gaps.sort(reverse=True)
    runtime = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                runtime[c] = float(e["ts"])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    str(e["name"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS),
                  key=lambda x: x[0])
    host_starts = [h[0] for h in host]

    def host_at(t):
        best = None
        i = bisect.bisect_right(host_starts, t)
        for s, e, name in reversed(host[max(0, i - 2000):i]):
            if e >= t and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else "idle host"

    idle = []
    for length, s, e in gaps[:10]:
        nxt = starts.get(e)
        c = (nxt.get("args") or {}).get("correlation") if nxt else None
        t = runtime.get(c, s)
        idle.append([_short(host_at(t)), length * 1e-6])
    return dict(kernels=kernels, window_s=(w1 - w0) * 1e-6,
                busy_s=busy_us * 1e-6,
                spans=sum(1 for e in spans if w0 <= float(e["ts"]) < w1),
                breakdown=dict(device_ops=[[k, v] for k, v in top_ops],
                               idle_gaps=idle))


def kernel_seconds(summary: dict, pick) -> float:
    """Device seconds of the window's kernels whose name ``pick`` takes."""
    return sum(d for n, _, d in summary["kernels"] if pick(n)) * 1e-6


def kernel_count(summary: dict) -> int:
    return len(summary["kernels"])


def is_march(name: str) -> bool:
    return "march_scene_kernel" in name


def is_march_bwd(name: str) -> bool:
    return "march_scene_bwd_kernel" in name
