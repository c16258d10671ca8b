"""Full-size parity of the port against the native float64 oracle.

    python3 tools/parity_oracle.py [--device cuda|cpu] [--out FILE]

The method of benchmarks/parity_r05.py, on this package alone (no JAX):
configs 2 (horizon + sky, 512 x 512) and 3 (the planets scene, 1024 x
1024) at full size, percent_black -1, each rendered by the native oracle
(``native/oracle.cpp`` through ``schwarzschild_tpu_torch.oracle.native``)
and by the port's renderers: ``render_horizon_sky`` (config 2), ``render_fast``
and the dense ``render`` (in strips of rows).  On the card the frames run
through the CUDA kernels; on the CPU through their plain versions, which
equal the kernels bit for bit.

Each disagreement is classified by its distance to the oracle image's
discontinuities (3 x 3 max - min of the oracle's rgb above CONTRAST = 0.02),
dilated by r = 0..3 pixels.  Every pixel more than one display count
(1/255) off at r0 gets the marginality probe: the renderer at fault
renders again with r_s x (1 +- 2 ulp), the camera pushed 2 ulp along its
position and the fov x (1 +- 2 ulp); a pixel that any of these moves by
more than a display count sits on a discrete decision (capture, escape,
far field) within an ulp, a boundary of f32 itself.  The gate, per
renderer: ``nonboundary_gt_display_r0_nonmarginal == 0``.

The run is written into FILE (default PARITY_TORCH_r06.json) under
``runs[<device type>]``; other runs in the file are kept.  Exits 1 when a
gate fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from schwarzschild_tpu_torch.oracle.native import (  # noqa: E402
    CONTRAST,
    DISPLAY_COUNT,
    TOL,
    ULP2,
    classify,
    parity,
)

STRIP_ROWS = 128


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def renderers(name, conf, device):
    """{renderer: f(cam, r_s) -> (H, W, 4) numpy} for one config."""
    import torch

    import schwarzschild_tpu_torch as sp

    sc, bg, tex, cfg = (conf["scene"], conf["background"], conf.get("tex"),
                        conf["cfg"])

    def sky(cam, r_s):
        return sp.render_horizon_sky(cam, cfg, bg, r_s)

    def fast(cam, r_s):
        return sp.render_fast(sc, cam, cfg, bg, tex, r_s, n_slots=4,
                              overflow="ignore")

    def dense(cam, r_s):
        return torch.cat([sp.render(sc, cam, cfg, bg, tex, r_s,
                                    rows=(r, min(r + STRIP_ROWS, cfg.height)))
                          for r in range(0, cfg.height, STRIP_ROWS)])

    out = {"render_fast": fast, "render": dense}
    if name.startswith("config2"):
        out = {"render_horizon_sky": sky, **out}

    def numpy_of(f):
        def run(cam, r_s):
            with torch.no_grad():
                r = torch.tensor(r_s, dtype=torch.float32, device=device)
                return f(cam, r).cpu().numpy()
        return run

    return {k: numpy_of(f) for k, f in out.items()}


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def run_config(name, conf, device):
    from schwarzschild_tpu_torch.oracle import native as oracle

    cam, cfg = conf["camera"], conf["cfg"]
    t0 = time.perf_counter()
    osc = oracle.OracleScene.from_scene(conf["scene"], conf["background"],
                                        conf.get("tex"))
    gold = oracle.render_image(osc, cam.pos, cam.axes, cam.fov, cfg.width,
                               cfg.height, max_steps=cfg.max_steps,
                               percent_black=-1.0).astype(np.float32)
    log(f"{name}: oracle {time.perf_counter() - t0:.1f} s")
    results = {"oracle_seconds": time.perf_counter() - t0}
    frames = {}
    for rname, render in renderers(name, conf, device).items():
        t0 = time.perf_counter()
        res, img = parity(gold, render, cam)
        res["seconds_with_probe"] = time.perf_counter() - t0
        results[rname] = res
        log(f"{name} {rname}: within {res['frac_within_tol']:.6f}, r0 "
            f"display {res['nonboundary_gt_display_r0']}, non-marginal "
            f"{res['nonboundary_gt_display_r0_nonmarginal']}")
        frames[rname] = img
    if "render_fast" in frames and "render" in frames:
        results["render_fast_vs_render"], _ = classify(frames["render"],
                                                       frames["render_fast"])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default="PARITY_TORCH_r06.json")
    args = ap.parse_args(argv)

    import torch

    from schwarzschild_tpu_torch import configs
    from schwarzschild_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("parity_oracle: no CUDA device; pass --device cpu for the "
              "plain versions", file=sys.stderr)
        return 1
    builders = {"config2_512": configs.config2_curved,
                "config3_1024": configs.config3_full_scene}
    run = {"script": "tools/parity_oracle.py", "device": device.type,
           "card": card_line() if device.type == "cuda" else None,
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else "cpu (plain versions)"),
           "torch": torch.__version__, "tol": TOL, "contrast": CONTRAST,
           "display_count": DISPLAY_COUNT, "ulp2": ULP2, "results": {}}
    for name, build in builders.items():
        run["results"][name] = run_config(name, build(device=device), device)
    gates = {f"{c}/{r}": v["nonboundary_gt_display_r0_nonmarginal"]
             for c, res in run["results"].items()
             for r, v in res.items() if isinstance(v, dict)
             and "nonboundary_gt_display_r0_nonmarginal" in v}
    run["gate"] = {"nonboundary_gt_display_r0_nonmarginal": gates,
                   "passed": all(v == 0 for v in gates.values())}
    path = Path(args.out)
    doc = json.loads(path.read_text()) if path.exists() else {
        "metric": "native f64 oracle parity at full size "
                  "(benchmarks/parity_r05.py's method); runs by device"}
    doc.setdefault("runs", {})[device.type] = run
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    log(f"wrote {path}: gate passed {run['gate']['passed']}")
    return 0 if run["gate"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
