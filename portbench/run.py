"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell, its configuration file, its traffic file and its metrics come
from ``BENCHMARK.json`` by name: ``portbench/traffic/<traffic>.json`` is
read by the driver that its ``kind`` names, ``portbench/kinds/<kind>.py``,
and each metric is the reader ``portbench/metrics/<metric>.py``.  With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` the window runs under the profiler and the line carries its
per-layer metrics, the device's busy and window seconds, and the
breakdown.  The numbers the check
compared, each beside its limit, come last: on standard error and under
``checks`` in the line.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "schwarzschild_tpu")


class Cell(NamedTuple):
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest, with its configuration and
    traffic files and the metrics it reports."""
    with open(root / "BENCHMARK.json") as f:
        man = json.load(f)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    with open(root / cfgs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)

    def mine(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in man["end_to_end"] if mine(m) in (True, None)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if mine(m) or (mine(m) is None and m["moves"] in reported)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def kind(name: str, root: Path = ROOT):
    """The module ``portbench/kinds/<name>.py`` of a traffic ``kind``: its
    ``load`` (set-up and the window's unit), ``work`` (the traced units'
    executed steps), ``check`` and ``readings``."""
    path = root / "portbench" / "kinds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.kinds.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             device, scale=None, fault=None, control=None,
             t0: float = _T0) -> dict:
    """Set up, run the window, check; the result dict (without printing).
    ``scale``, ``fault`` and ``control`` serve the tests and the control
    runs only."""
    import torch

    from . import trace
    from .window import Window, mark

    K = kind(cell.traffic["kind"])
    prof = None
    if trace_on:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    load = K.load(cell, seed, seconds, device, profiler=prof, scale=scale,
                  fault=fault, control=control)
    mark("load")
    work = K.work(cell, load, device, scale) if trace_on else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    mark("setup")
    setup_s = time.perf_counter() - t0
    window_s = min(seconds, float(cell.traffic["trace_seconds"])) \
        if trace_on else seconds
    win = Window(window_s)
    if prof is not None:
        with prof:
            win.run(load["unit"])
    else:
        win.run(load["unit"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    mark("window")
    summary = trace.summarize(trace.export(prof)) if prof is not None \
        else None
    del prof
    load.pop("unit")
    load.pop("state")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    nums, failed = K.check(cell, load, device, scale=scale)
    mark("check")
    correct = all(v <= lim for v, lim in nums.values())

    ctx = dict(window=win, peak_bytes=peak, setup_s=setup_s, trace=summary)
    if summary is not None:
        ctx["work"] = [work[k % len(work)] for k in range(summary["spans"])]
    metrics = {}
    defs = cell.per_layer if trace_on else cell.end_to_end
    for m in defs:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    dev_info = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=cell.chips, memory_peak_bytes=int(peak))
    if summary is not None:
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    if device.type == "cuda":
        dev_info["power_limit_w"] = power_limit()
    out = dict(correct=correct, attempted=win.count, failed=failed,
               metrics=metrics, device=dev_info)
    if summary is not None:
        out["breakdown"] = summary["breakdown"]
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in nums.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        fail(f"cannot load the cell: {e}")
    import torch

    from .window import PHASES, mark

    mark("import_torch")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        fail(f"needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count()} available")
    mark("cuda_count")
    try:
        import schwarzschild_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is missing: {e}", 3)
    mark("import_program")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        fail(f"modules of the JAX package or JAX were loaded: {bad}", 4)
    print("portbench: phases (s from start): " + ", ".join(
        f"{k} {v - _T0:.3f}" for k, v in PHASES.items()), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
