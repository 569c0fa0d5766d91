"""The host-bound launchers of two checkouts, alternated A, B, B, A in one
call on one card: the serve launcher's decode and prefill tokens/s
(phi4-mini-3.8B, olmoe-1b-7b and zamba2-2.7b at their published widths,
random weights, batch 4, 32 prompt + 32 generated tokens, pair packing)
and the train launcher's `mean_step_ms` (lm20m, 60 steps of 8 x 256).
Host dispatch sets these times, and host clocks vary between calls, so
two versions are compared only within one call.

    python -m repro_torch.launch.ab_launchers A_DIR B_DIR [--out DIR]

A_DIR and B_DIR are checkouts of the repository (each runs from its own
`src/` and builds its own kernels); each run prints one JSON line, and
`--out` keeps each launcher's full report there.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

SERVE = ["--no-smoke", "--batch", "4", "--prompt-len", "32", "--gen", "32",
         "--kv-packing", "pair"]
RUNS = {
    "serve_phi4": ["repro_torch.launch.serve", "--arch", "phi4_mini_3_8b",
                   *SERVE],
    "serve_olmoe": ["repro_torch.launch.serve", "--arch", "olmoe_1b_7b",
                    *SERVE],
    "serve_zamba2": ["repro_torch.launch.serve", "--arch", "zamba2_2_7b",
                     *SERVE],
    "train_lm20m": ["repro_torch.launch.train", "--preset", "lm20m",
                    "--steps", "60", "--batch", "8"],
}
# what each report gives for the comparison
KEYS = {"serve": ("tokens_per_s", "prefill_tokens_per_s"),
        "train": ("mean_step_ms", "wall_s")}


def run_one(tree: pathlib.Path, argv: list) -> dict:
    """One launcher run from `tree`; its JSON report (its output from the
    first line that is a lone "{")."""
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    out = subprocess.run([sys.executable, "-m", *argv], cwd=tree, env=env,
                         capture_output=True, text=True, check=True)
    lines = out.stdout.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=pathlib.Path)
    ap.add_argument("b", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    for i, who in enumerate("ABBA"):
        for name, run in RUNS.items():
            report = run_one(trees[who], run)
            keys = KEYS[name.split("_")[0]]
            print(json.dumps({"tree": who, "round": i, "run": name,
                              **{k: report[k] for k in keys}}), flush=True)
            if args.out is not None:
                args.out.mkdir(parents=True, exist_ok=True)
                (args.out / f"{who}{i}_{name}.json").write_text(
                    json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
