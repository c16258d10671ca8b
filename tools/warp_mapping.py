"""Compare the march kernels' ray mappings on one CUDA card: a warp of 32
pixels of one row against a warp of a 4 x 8 pixel tile.

    python3 tools/warp_mapping.py

It prints one JSON line a kernel, then the card's name and power limit.

march_scene, on the demo scene at 1280x720 with 4 slots (chip_smoke.py's
march_scene inputs):
  * lane_efficiency: executed lane-steps over 32 x each warp's longest ray,
    summed over warps (the share of a warp's issue slots its lanes use),
    from the kernel's own t_end plane (a ray runs min(t_end + 1, max_steps)
    steps);
  * table_ops_per_step: the f32 operations of the table tests a step, per
    executed step: every row's exact test (the unculled design), the
    culled design per lane (chip_smoke.CullCount), and the culled design
    as a warp runs it under each mapping (a test that one live lane of a
    warp needs costs every live lane of that warp);
  * exact_row_tests_per_step: the exact row tests the cull lets through.
The counts come from the plain march on the card, which takes every
decision the kernel takes.

march_bh, on config-2 rays at 512x512 (chip_smoke.py's march_bh inputs):
  * lane_efficiency under each mapping, from the kernel's t_end plane;
  * warp_steps_per_block under each mapping, for blocks of the kernel's
    threads (_ext.DESIGN): a block's warp-steps are the sum of its warps'
    longest rays (the steps its warps issue), its span the longest ray;
    max, mean and 99th percentile over the blocks, which size the tail;
  * blocks_per_sm: the resident blocks an SM holds of the built kernel
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for each
    instantiation, and the waves the grid takes on this card;
  * sass: the SASS instructions of march_bh_kernel<false>'s step loop in
    the built library (cuobjdump -sass), the static count from the loop's
    head to its back-edge, by opcode, with the inner loops (sinf/cosf's
    slow argument reduction) and the calls (the IEEE division's and square
    root's slow paths) named apart, beside chip_smoke.OPS_BH_STEP, the f32
    operations the bound counts a step.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import torch  # noqa: E402

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


def block_steps(steps, rows, warps_per_block):
    """Per block of warps_per_block warps (consecutive warps of a row of
    tiles): (warp-steps, span) as two 1-D tensors."""
    longest = warps(steps, rows).amax(1).reshape(-1, warps_per_block)
    return longest.sum(1), longest.amax(1)


def spread(x):
    x = x.double()
    return dict(max=x.max().item(), mean=x.mean().item(),
                p99=x.quantile(0.99).item())


def sass_loop(lib_path, kernel="march_bh_kernel", instantiation="ILb0E"):
    """Static SASS instruction counts of the outermost loop of one kernel
    in a built library: the span from the loop head to its back-edge (the
    backward branch that spans the most), its opcodes, the inner loops'
    instructions and the calls."""
    import re
    import subprocess

    from schwarzschild_tpu_torch import _ext

    tool = Path(_ext._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", out)
    body = next(f for f in funcs if kernel in f.split("\n", 1)[0]
                and instantiation in f.split("\n", 1)[0])
    code = []  # (address, opcode text)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
        code.append((int(m.group(1), 16), m.group(2).strip()))
    back = []  # (head, edge) of each backward branch
    for addr, text in code:
        m = re.search(r"\bBRA\S*\s.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            back.append((int(m.group(1), 16), addr))
    head, edge = max(back, key=lambda b: b[1] - b[0])
    loop = [(a, t) for a, t in code if head <= a <= edge]
    inner = {a for h, e in back if (h, e) != (head, edge) and head <= h
             for a, _ in loop if h <= a <= e}
    ops = {}
    for _, text in loop:
        op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    return dict(function=body.split("\n", 1)[0].strip(),
                loop_instructions=len(loop),
                inner_loop_instructions=len(inner),
                calls=sum("CALL" in t for _, t in loop),
                mufu=ops.get("MUFU", 0),
                by_opcode=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
                counted_f32_ops_per_step=chip_smoke.OPS_BH_STEP)


def scene_mapping(dev):
    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs, kernel_scene

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
    return dict(
        kernel="march_scene", shape=[cfg.height, cfg.width],
        executed_steps=steps,
        lane_efficiency={name: lane_efficiency(lane_steps, rows)
                         for name, rows in MAPPINGS.items()},
        table_ops_per_step=dict(
            full_table=full, culled_per_lane=counted.lane_ops / steps,
            **{f"culled_simt_{name}": ops / steps
               for name, ops in counted.simt_ops.items()}),
        exact_row_tests_per_step=counted.exact / steps)


def bh_mapping(dev):
    from schwarzschild_tpu_torch import _ext, configs, kernel

    c2 = configs.config2_curved(device=dev)
    cfg = c2["cfg"]
    o, d, act = chip_smoke.rays(c2["camera"], cfg.width, cfg.height, dev)
    _, _, ev, steps = kernel.march_bh(o, d, act, 1.0, cfg, events=True,
                                      count_steps=True)
    lane_steps = torch.clamp(ev["t_end"] + 1, 0, cfg.max_steps)
    threads = _ext.DESIGN["BH_THREADS"]
    lib = _ext.library()
    per_sm = {"march_bh_kernel": lib.march_bh_blocks_per_sm(0),
              "march_bh_kernel<events>": lib.march_bh_blocks_per_sm(1)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = act.numel() // threads
    per_block = {}
    for name, rows in MAPPINGS.items():
        work, span = block_steps(lane_steps, rows, threads // 32)
        per_block[name] = dict(warp_steps=spread(work), span=spread(span))
    return dict(
        kernel="march_bh", shape=[cfg.height, cfg.width],
        executed_steps=int(steps), max_steps=cfg.max_steps,
        lane_efficiency={name: lane_efficiency(lane_steps, rows)
                         for name, rows in MAPPINGS.items()},
        threads=threads, blocks=blocks, warp_steps_per_block=per_block,
        blocks_per_sm=per_sm, sms=sms,
        waves=blocks / (sms * per_sm["march_bh_kernel"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_mapping: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(json.dumps(scene_mapping(dev)), flush=True)
    print(json.dumps(bh_mapping(dev)), flush=True)
    from schwarzschild_tpu_torch import _ext

    print(json.dumps(dict(kernel="march_bh", sass=sass_loop(
        _ext.build().path))), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
