"""Animation: the hyperbolic flyby, frame by frame (counterpart of
``schwarzschild_tpu.animation``; BASELINE config 4).

The camera pose is a pure function of frame time
(:func:`camera.hyperbolic_trajectory`), replacing the reference's key-H
controller (main.cpp:404-410).  Frames are written as PNG files; a run
that was killed resumes, since a frame whose file exists is skipped; with
several processes each renders its own contiguous slab of frames
(:func:`sharding.frame_range_for_process`).

On the card the loop keeps frames in flight: each frame is rendered and
quantized on the current stream, a non-blocking copy moves its uint8
pixels into pinned host memory, and a CUDA event marks its end; the host
waits on the oldest event only when ``prefetch`` frames are ahead of it,
and PNG encoding runs on worker threads.
"""

from __future__ import annotations

import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import camera as cam_mod
from .config import RenderConfig
from .kernel_scene import render_fast
from .metrics import FrameTimer, MetricsLogger
from .render import encode_png, render, to_uint8
from .sharding import frame_range_for_process
from .textures import build_atlas_cached


def _to_host(img):
    """Start moving a rendered frame to the host: (host tensor, CUDA event
    that marks the copy's end, or None on the CPU)."""
    if img.device.type != "cuda":
        return img, None
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(img, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _cuda_frame_ms(render_one, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one frame, after one
    warm-up frame."""
    render_one()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render_one()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def render_trajectory(
    sc,
    cfg: RenderConfig,
    background,
    tex=None,
    times: Optional[Sequence[float]] = None,
    n_frames: int = 60,
    initial_distance: float = 30.0,
    closest_distance: float = 10.0,
    r_s: float = 1.0,
    out_dir: Optional[str] = None,
    logger: Optional[MetricsLogger] = None,
    overwrite: bool = False,
    all_frames_local: bool = False,
    renderer: str = "jnp",
    prefetch: int = 2,
    png_compress_level: int = 1,
    measure_device_ms: bool = False,
    encode_workers: int = 2,
):
    """Render the hyperbolic flyby on the device of ``background``.

    ``times``: normalized trajectory times in [0, 1] (default ``n_frames``
    uniform ones; the reference sweeps [0, 1] over
    HYPERBOLIC_TRAJECTORY_DURATION seconds, main.cpp:408-410).  Returns a
    list of (frame index, PNG path) with ``out_dir``, else of (frame index,
    float image as a CPU tensor), in frame order.

    ``renderer="jnp"`` (the default, as in the JAX package) renders each
    frame with the dense renderer :func:`render.render`, ``"fast"`` with
    :func:`render_fast` (``overflow="ignore"``) and the fetch atlas of
    (background, tex), built once here and passed to every frame.

    With ``out_dir`` frames are quantized on the device (:func:`to_uint8`),
    so 3 bytes a pixel cross to the host, and written as
    ``frame_{idx:05d}.png``; an existing file is skipped (logged as
    ``frame_skipped``) unless ``overwrite``.  ``all_frames_local`` renders
    every frame here instead of this process's slab.

    ``prefetch`` frames stay in flight ahead of the host's wait; 0 renders
    and fetches one frame at a time.  A frame event's ``seconds`` runs from
    its render call to the end of its fetch (with ``prefetch`` > 0 frames
    overlap: wall time over frames is the throughput), ``host_fetch_ms`` is
    the wait for its copy.  ``encode_workers`` > 0 encodes PNGs on that
    many threads (zlib releases the GIL), logging ``png`` events with
    ``png_ms`` as they are collected; 0 encodes in the loop.
    ``png_compress_level`` is zlib's level (0-9).

    ``measure_device_ms`` (CUDA only) times the frame-0 render once up
    front, the median of 3 CUDA-event timings after one warm-up (logged as
    ``device_ms_estimate``), and adds it to every frame event as
    ``device_ms_est``.
    """
    if renderer not in ("jnp", "fast"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if times is None:
        times = np.linspace(0.0, 1.0, n_frames)
    times = np.asarray(times, np.float64)
    logger = logger or MetricsLogger()
    out_path = Path(out_dir) if out_dir else None
    quantize = out_path is not None
    dev = background.data.device
    base_cam = cam_mod.make_camera((0.0, 2.0, 15.0), device=dev)

    def pose(idx):
        return cam_mod.hyperbolic_trajectory(
            base_cam, initial_distance, closest_distance, float(times[idx]))

    atlas = (build_atlas_cached(background, tex) if renderer == "fast"
             else None)

    def render_one(cam):
        if renderer == "jnp":
            img = render(sc, cam, cfg, background, tex, r_s)
        else:
            img = render_fast(sc, cam, cfg, background, tex, r_s,
                              overflow="ignore", atlas=atlas)
        return to_uint8(img) if quantize else img

    frame_ids = (range(len(times)) if all_frames_local
                 else frame_range_for_process(len(times)))
    if out_path:
        out_path.mkdir(parents=True, exist_ok=True)

    device_ms_est = None
    if measure_device_ms:
        if dev.type != "cuda":
            raise ValueError("measure_device_ms times the card: the frames "
                             f"are on {dev}")
        cam0 = pose(0)
        device_ms_est = _cuda_frame_ms(lambda: render_one(cam0))
        logger.log("device_ms_estimate", device_ms=device_ms_est,
                   method="median of 3 CUDA-event timings of the frame-0 "
                          "render after one warm-up")

    executor = (ThreadPoolExecutor(max_workers=encode_workers)
                if encode_workers and out_path else None)
    encode_futures = []
    pending = []  # (idx, png path or None, host tensor, event, FrameTimer)
    out = []

    def encode(idx_, f_, img):
        t0 = time.perf_counter()
        data = encode_png(img, png_compress_level)
        tmp = f_.with_name(f_.name + ".part")
        tmp.write_bytes(data)
        os.replace(tmp, f_)  # a killed run leaves no truncated frame
        return idx_, (time.perf_counter() - t0) * 1e3

    def drain_one():
        idx_, f_, host, done, timer = pending.pop(0)
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        timer.add_fields(host_fetch_ms=(time.perf_counter() - t0) * 1e3)
        if device_ms_est is not None:
            timer.add_fields(device_ms_est=device_ms_est)
        timer.__exit__(None, None, None)
        if f_ is None:
            out.append((idx_, host))
            return
        img = host.numpy()
        if executor is not None:
            encode_futures.append(executor.submit(encode, idx_, f_, img))
        else:
            _, png_ms = encode(idx_, f_, img)
            logger.log("png", frame=idx_, png_ms=png_ms)
        out.append((idx_, str(f_)))

    try:
        for idx in frame_ids:
            f = None
            if out_path:
                f = out_path / f"frame_{idx:05d}.png"
                if f.exists() and not overwrite:
                    while pending:  # keep ``out`` in frame order
                        drain_one()
                    out.append((idx, str(f)))
                    logger.log("frame_skipped", frame=idx)
                    continue
            timer = FrameTimer(logger, idx, cfg.width * cfg.height,
                               cfg.max_steps)
            timer.__enter__()
            host, done = _to_host(render_one(pose(idx)))
            pending.append((idx, f, host, done, timer))
            if len(pending) > max(0, prefetch):
                drain_one()
        while pending:
            drain_one()
        for fut in encode_futures:
            idx_, png_ms = fut.result()
            logger.log("png", frame=idx_, png_ms=png_ms)
    finally:
        if executor is not None:
            executor.shutdown()
    return out


def write_video(frame_paths: Sequence[str], out_path: str, fps: int = 24,
                **writer_kw):
    """Assemble PNG frames into a video with imageio, or raise RuntimeError
    when it is not installed (the frames stay usable as files).  GIF works
    with imageio's Pillow backend; mp4 needs ffmpeg.  ``writer_kw`` goes to
    ``imageio.get_writer`` (e.g. ``loop=0`` for a GIF that repeats)."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError(
            "imageio not available; frames are on disk as PNGs") from e
    with imageio.get_writer(out_path, fps=fps, **writer_kw) as w:
        for p in frame_paths:
            w.append_data(imageio.imread(p))
