"""§Perf hillclimbing (port of `repro.launch.perf`): run a cell
under several variants through the dry run, compare the roofline terms,
and append the hypothesis log.

  python -m repro_torch.launch.perf --arch qwen3_8b --shape train_4k \\
      --variants base no_fsdp bf16_params no_fsdp+bf16_params

Each variant's record comes from `dryrun.run_cell` (counted on fake
tensors in a fake world; `--device cpu` on a machine without a card);
the rows go to experiments/torch_perf_log.json.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .dryrun import run_cell

LOG = Path(__file__).resolve().parents[3] / "experiments" / \
    "torch_perf_log.json"


def compare(arch: str, shape: str, variants: list[str], multi_pod=False,
            force=False, *, device="cuda") -> list[dict]:
    rows = []
    for v in variants:
        rec = run_cell(arch, shape, multi_pod, v, force=force, device=device)
        if not rec.get("ok"):
            rows.append({"variant": v, "error": rec.get("error")})
            continue
        r = rec["roofline"]
        rows.append({
            "variant": v,
            "compute_s": r["compute_s"],
            "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "dominant": r["dominant"],
            "bound_s": max(r["compute_s"], r["memory_s"],
                           r["collective_s"]),
            "roofline_frac": r["compute_s"] / max(
                r["compute_s"], r["memory_s"], r["collective_s"]),
            "temp_bytes": rec.get("memory_analysis", {}).get(
                "temp_size_in_bytes"),
            "arg_bytes": rec.get("memory_analysis", {}).get(
                "argument_size_in_bytes"),
            "coll_by_type": rec.get("extrapolated", {}).get(
                "collective_bytes_by_type"),
        })
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", nargs="+", default=["base"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the dry run's fake tensors")
    args = ap.parse_args(argv)
    rows = compare(args.arch, args.shape, args.variants, args.multi_pod,
                   args.force, device=args.device)
    base = next((r for r in rows if r["variant"] == "base" and "error"
                 not in r), None)
    print(f"\n== {args.arch} {args.shape} ==")
    hdr = (f"{'variant':<28}{'bound_s':>10}{'comp':>9}{'mem':>9}"
           f"{'coll':>9}{'dom':>6}{'vs base':>9}")
    print(hdr + "\n" + "-" * len(hdr))
    for r in rows:
        if "error" in r:
            print(f"{r['variant']:<28}ERROR {str(r['error'])[:60]}")
            continue
        rel = (base["bound_s"] / r["bound_s"]
               if base and r["bound_s"] else float("nan"))
        print(f"{r['variant']:<28}{r['bound_s']:>10.3f}"
              f"{r['compute_s']:>9.3f}{r['memory_s']:>9.3f}"
              f"{r['collective_s']:>9.3f}{r['dominant'][:4]:>6}"
              f"{rel:>8.2f}x")
    LOG.parent.mkdir(parents=True, exist_ok=True)
    log = json.loads(LOG.read_text()) if LOG.exists() else []
    log.append({"arch": args.arch, "shape": args.shape, "rows": rows})
    LOG.write_text(json.dumps(log, indent=1))


if __name__ == "__main__":
    main()
