"""Readings that set the check's limits: the program's numbers over many
seeds, and the control's, each in one process (not part of a benchmark
run).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --side program|control|<fault> [--seconds 2]

``program`` runs the cell as a benchmark run does, with a short window,
and prints the numbers its check compared; ``control`` puts the cell's
control in the program's place (frames: bfloat16 textures, the program's
own lower-precision path; the fit: the reference computed in bfloat16);
a fault's name plants that fault of the kind's driver
(``portbench/kinds/<kind>.py``).  Each seed prints one JSON line of
{number: value}.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .run import cache_dirs, kind, load_cell


def readings(cell, seed, device, side, seconds=2.0, scale=None) -> dict:
    """{number: value} of one seed, from the driver of the cell's kind."""
    return kind(cell.traffic["kind"]).readings(cell, seed, device, side,
                                               seconds, scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", required=True,
                    help="program, control, or a fault the kind plants")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cache_dirs()
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            r = readings(cell, seed, dev, args.side, args.seconds)
        except Exception as e:  # a control that crashes has failed
            r = dict(error=f"{type(e).__name__}: {e}")
        print(json.dumps(dict(workload=args.workload, side=args.side,
                              seed=seed, **r)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
