"""Readings of a cell's check on many seeds, and its control's, in one
process on the card: the numbers the cell's limits are set from.

  python portbench/calibrate.py --workload <cell> --seconds <s> \
      --seeds 12 --control 3 [--first <seed>] [--out <file>]

Each seed is one run of the cell as `run.py` makes it (set-up, window,
check), with every reading of the check; the first `--control` seeds
also give the control's readings: the reference in a precision below
the one the configuration states, put in the program's place.  One JSON
line a seed, on standard output and in `--out`."""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=2_147_483_659)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             control=i < args.control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": r["correct"],
                           "readings": r.get("readings"),
                           "numbers": {k: v["value"]
                                       for k, v in r["numbers"].items()},
                           "control": r.get("control"),
                           "metrics": {k: v["value"]
                                       for k, v in r["metrics"].items()},
                           "seconds": r["seconds"],
                           "peak": r["device"]["memory_peak_bytes"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
