"""repro_torch.analysis: the port's invariant checks (port of
`repro.analysis`).

Two levels:

  * Level 1 — an AST rule engine (`analysis.rules`) over the port's tree
    (`src/repro_torch/` and `chip_smoke.py`): marker literals stay in
    `compression/framing.py`, in the Python sources and the CUDA sources
    alike (R1); codec implementations stay behind the `compression`
    registry (R2); hot paths do not sync the card (R3); seeding goes
    through explicit generators (R4); every tier crossing books a ledger
    event (R5); kernel wrappers never swallow errors or make float64
    (R6).  Fixtures under `tests/fixtures/torch_analysis/` prove each
    rule fires.

  * Level 2 — `analysis.launch_audit`: runs the hot entry points (engine
    chunk, fused decode, pack window, serve scatters, megastep, prefill,
    step booking, checkpoint pack) once under a TorchDispatchMode and pins
    the kernel wrapper calls, host syncs, float64 tensors, eager aten ops
    and in-place updates against `tests/golden/torch_launch_audit.json`.

CLI: `python -m repro_torch.analysis [--report json] [--audit]
[--update-golden] [paths...]`; exit 0 clean, non-zero on any violation.
"""

from .engine import Violation, analyze, default_paths, render_report

__all__ = ["Violation", "analyze", "default_paths", "render_report"]
