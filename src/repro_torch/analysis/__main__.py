"""CLI: `python -m repro_torch.analysis [paths...] [options]`.

Exit status:

  0  clean: no rule violation, and the launch audit (when asked for)
     meets its invariants and matches its golden
  1  violations found, or the launch audit drifted

Examples:

  python -m repro_torch.analysis                     # rules over the port
  python -m repro_torch.analysis --report json       # machine-readable
  python -m repro_torch.analysis --audit --device cpu   # + the launch audit
  python -m repro_torch.analysis --audit --device cpu --update-golden
  python -m repro_torch.analysis --rules r1,r3 path/  # subset, own roots
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import analyze, default_paths, iter_source_files, render_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant rules and its launch audit")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to scan (default: src/repro_torch, "
                         "chip_smoke.py)")
    ap.add_argument("--report", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (e.g. r1,r3)")
    ap.add_argument("--audit", action="store_true",
                    help="also run the launch audit")
    ap.add_argument("--device", default="cuda",
                    help="device of the launch audit (default cuda; the "
                         "golden is the cpu record)")
    ap.add_argument("--golden", type=Path, default=None,
                    help="audit golden (default tests/golden/"
                         "torch_launch_audit.json)")
    ap.add_argument("--update-golden", action="store_true",
                    help="rewrite the audit golden from this tree (cpu)")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON report to this file")
    args = ap.parse_args(argv)

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    paths = args.paths or default_paths()
    files_scanned = len(iter_source_files(paths))
    violations = analyze(paths, rules=rules)

    audit = None
    if args.audit or args.update_golden:
        from . import launch_audit
        audit = launch_audit.run(args.golden, update=args.update_golden,
                                 device=args.device)

    report = render_report(violations, files_scanned=files_scanned,
                           audit=audit)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=2) + "\n")

    if args.report == "json":
        print(json.dumps(report, indent=2))
    else:
        for v in violations:
            print(v)
        print(f"{len(violations)} violation(s) across {files_scanned} "
              "file(s)")
        if audit is not None:
            for m in audit["mismatches"]:
                print(f"launch-audit: {m}")
            state = ("updated golden" if audit["updated"] else
                     "drifted" if audit["mismatches"] else "matches golden")
            print(f"launch audit ({audit['device']}): "
                  f"{len(audit['entries'])} entries, {state}")

    bad = bool(violations) or bool(audit and audit["mismatches"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
