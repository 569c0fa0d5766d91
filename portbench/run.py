"""Run one cell of the port's benchmark once on this machine's card(s):

  python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Prints each number the check compared beside its limit as the last
lines on standard error, and as the last line of standard output one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device (and with
--trace 1 breakdown), numbers.  Exits non-zero, printing no result, when
there is no card or fewer than the cell asks for, or when JAX or the
JAX package was imported by the time the window closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
# every cache the program or torch may write stays in the checkout, at a
# fixed path, so that a second run finds what the first one built
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from portbench import harness

    cell = harness.load_json("workloads", args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the system under test, or exit here)

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START, cell=cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process imported {', '.join(bad)}: the benchmark runs "
              "the PyTorch port alone", file=sys.stderr)
        return 4
    for name, n in result["numbers"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
