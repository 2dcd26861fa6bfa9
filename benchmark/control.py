"""The control's readings and the program's, seed by seed, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds <s> [--out F]

For each seed: one run of the cell (set-up, a window of ``--seconds``),
then the check twice over what the window produced: once of the program's
outputs (the lower readings of the limits) and once of the control's, the
reference computed one precision below the configuration's, bfloat16 for
float32, along the same inputs (the upper readings).  One JSON line a
seed; ``--out`` also writes them there.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(args.workload, seed, args.seconds, trace=False, control=True)
        row = {"seed": seed, "correct": res["correct"], "rooms": res["attempted"],
               "program": {k: c["value"] for k, c in res["checks"].items()},
               "control": {k: c["value"] for k, c in res["control_checks"].items()},
               "metrics": {k: m["value"] for k, m in res["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
