"""Time the forward march kernels of two checkouts of this repository in
turns on one CUDA card: pairs of runs, A then B, then B then A, and so on.

    python3 tools/ab_march.py PATH_A PATH_B [PAIRS]   # PAIRS defaults to 5

Each run imports one checkout's schwarzschild_tpu_torch in a subprocess of
its own (both packages have the same name), builds its kernels from its own
csrc/, and times march_scene on the demo scene at 1280x720 (4 slots,
opaque stop on) and march_bh on config-2 rays at 512x512: CUDA-event
medians of 20 launches after 3 warm-up launches.  The rays, the timing and
the card line are this repository's chip_smoke.py's, whichever checkout is
timed.  It prints one JSON line per run, then the card's name and power
limit.  Two versions compare only inside one such call: cards and hosts
differ from call to call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

RUN = r"""
import importlib.util, json, os, torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              os.environ["AB_CHIP_SMOKE"])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu_torch import configs, kernel, kernel_scene

dev = torch.device("cuda", 0)
cam = configs.demo_camera(device=dev)
sc = configs.demo_scene(device=dev)
tex = configs.demo_texture_stack(device=dev)
cfg = sp.RenderConfig(width=1280, height=720, percent_black=-1.0)
o, d, act = smoke.rays(cam, 1280, 720, dev)
scene_ms = smoke.cuda_ms(lambda: kernel_scene.march_scene(
    o, d, act, 1.0, sc, cfg, 4, tex), warmup=3, reps=20)
c2 = configs.config2_curved(device=dev)
o2, d2, act2 = smoke.rays(c2["camera"], 512, 512, dev)
bh_ms = smoke.cuda_ms(lambda: kernel.march_bh(o2, d2, act2, 1.0, c2["cfg"]),
                      warmup=3, reps=20)
print(json.dumps(dict(march_scene_1280x720_ms=scene_ms,
                      march_bh_512_ms=bh_ms)))
"""


def run(path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(path),
               AB_CHIP_SMOKE=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=path, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{path}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:3]
    pairs = int(sys.argv[3]) if len(sys.argv) == 4 else 5
    for k in range(pairs):
        order = (("A", a), ("B", b)) if k % 2 == 0 else (("B", b), ("A", a))
        for label, path in order:
            print(json.dumps({"pair": k, "run": label, "path": path,
                              **run(path)}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
