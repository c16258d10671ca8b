"""Compare the scene kernel's two ray mappings on one CUDA card: a warp of
32 pixels of one row against a warp of a 4 x 8 pixel tile.

    python3 tools/warp_mapping.py

On the demo scene at 1280x720 with 4 slots (chip_smoke.py's march_scene
inputs) it prints one JSON line:
  * lane_efficiency: executed lane-steps over 32 x each warp's longest ray,
    summed over warps (the share of a warp's issue slots its lanes use),
    from the kernel's own t_end plane (a ray runs min(t_end + 1, max_steps)
    steps);
  * table_ops_per_step: the f32 operations of the table tests a step, per
    executed step: every row's exact test (the unculled design), the
    culled design per lane (chip_smoke.CullCount), and the culled design
    as a warp runs it under each mapping (a test that one live lane of a
    warp needs costs every live lane of that warp);
  * exact_row_tests_per_step: the exact row tests the cull lets through;
then the card's name and power limit.  The counts come from the plain
march on the card, which takes every decision the kernel takes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

MAPPINGS = {"rows": 1, "tiles_4x8": 4}


def warps(x, rows):
    """An (H, W) plane's lanes as (warps, 32), each warp a tile of rows x
    (32 / rows) pixels (rows = 1: 32 pixels of one row)."""
    H, W = x.shape
    cols = 32 // rows
    return x.reshape(H // rows, rows, W // cols, cols).permute(
        0, 2, 1, 3).reshape(-1, 32)


def lane_efficiency(steps, rows):
    w = warps(steps, rows)
    return (w.sum() / (32 * w.amax(1).sum())).item()


class WarpCount(chip_smoke.CullCount):
    """CullCount that also costs each step's tests per warp, per mapping."""

    def __init__(self, tables, bounds):
        super().__init__(tables, bounds)
        self.simt_ops = dict.fromkeys(MAPPINGS, 0)

    def work(self, live, *seg):
        tests, exact = super().work(live, *seg)
        for name, rows in MAPPINGS.items():
            n_live = warps(live, rows).sum(1)
            for need, ops in tests + exact:
                self.simt_ops[name] += int(
                    (warps(need, rows).any(1) * n_live).sum()) * ops
        return tests, exact


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("warp_mapping: no CUDA device", file=sys.stderr)
        return 1
    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs, kernel_scene

    dev = torch.device("cuda", 0)
    sc = configs.demo_scene(device=dev)
    tex = configs.demo_texture_stack(device=dev)
    cfg = sp.RenderConfig(width=1280, height=720, percent_black=-1.0)
    o, d, act = chip_smoke.rays(configs.demo_camera(device=dev), cfg.width,
                                cfg.height, dev)
    out = kernel_scene.march_scene(o, d, act, 1.0, sc, cfg, 4, tex,
                                   events=True, count_steps=True)
    steps = int(out[6])
    lane_steps = torch.clamp(out[5]["t_end"] + 1, 0, cfg.max_steps)
    tables = kernel_scene._pack_scene_smem(sc, tex)
    counted = WarpCount(tables, kernel_scene._row_bounds(
        tables, 6 * sc.boxes.mat_idx.shape[0]))
    kernel_scene._march_scene_planes_torch(o, d, act, 1.0, sc, cfg, 4, tex,
                                           on_segment=counted)
    full = sum(chip_smoke.OPS_ROW[name] * len(rows)
               for name, rows in tables.items())
    print(json.dumps(dict(
        shape=[cfg.height, cfg.width], executed_steps=steps,
        lane_efficiency={name: lane_efficiency(lane_steps, rows)
                         for name, rows in MAPPINGS.items()},
        table_ops_per_step=dict(
            full_table=full, culled_per_lane=counted.lane_ops / steps,
            **{f"culled_simt_{name}": ops / steps
               for name, ops in counted.simt_ops.items()}),
        exact_row_tests_per_step=counted.exact / steps)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
