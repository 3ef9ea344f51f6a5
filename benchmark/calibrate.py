"""The readings a cell's limits are set from, over many seeds in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--seconds 2]
                                   [--out FILE]

For each seed: a run of the cell as ``benchmark.run`` makes it (weights,
clip, warm-up, a short window at the cell's own load, the sample of its
frames), the program's readings against the plain reference, and the
control's: the same reference with every conv's operands one precision below
the configuration's (``reference.layers.Operands``).  Prints one JSON line a
seed and a summary: the largest reading of the program (the lower end of a
limit) and the smallest of the control (the upper end).  Needs a CUDA device.
"""

import argparse
import json
import os
import sys

from benchmark import check
from benchmark.run import load_cell, run_cell


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    _, cell, config, traffic = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(config, traffic, seed=seed, seconds=args.seconds, control=True)
        row = {"seed": seed, "frames": out.window.frames, "sampled": out.sampled,
               "program": out.readings, "control": out.control}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell["name"], "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows) for k in check.NUMBERS},
               "control_min": {k: min(r["control"][k] for r in rows) for k in check.NUMBERS}}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
