"""The benchmark's harness: finds a cell's files by name, runs the cell
once (set-up, a measured window, an optional traced window, the check of
what the window produced against the plain reference), and builds the
result line.

Everything that belongs to one configuration, traffic kind, cell or
per-layer metric is a file of its own, found by name:

  portbench/configs/<config>.json    sizes as run, source, cuts
  portbench/workloads/<cell>.json    config, driver, traffic, chips, why,
                                     and the limits of the check
  portbench/drivers/<driver>.py      one traffic kind: class Driver
  portbench/metrics/<metric>.py      one per-layer metric: read(record)

`BENCHMARK.json` at the checkout's root lists the cells and metrics;
the harness reports the end-to-end metrics it lists for the cell, and,
with `--trace 1`, each per-layer metric whose reader finds something to
read."""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import sys
import time

import torch

from . import trace as tr
from . import yardstick

ROOT = pathlib.Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    return json.loads((PB / kind / f"{name}.json").read_text())


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str) -> list[str]:
    """The names of a kind's files (configs, workloads, drivers,
    metrics)."""
    suffix = ".json" if kind in ("configs", "workloads") else ".py"
    return sorted(p.name[:-len(suffix)] for p in (PB / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) the cell reports: those
    whose `workloads` name it, and a per-layer metric without
    `workloads` wherever the metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in moved
                            else [])]
    return e2e, per


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_driver(cell_name: str, seed: int, device, cell=None, config=None):
    cell = cell or load_json("workloads", cell_name)
    config = config or load_json("configs", cell["config"])
    mod = load_module(PB / "drivers" / f"{cell['driver']}.py")
    return mod.Driver(config, cell, seed, torch.device(device)), cell, config


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, cell=None,
             config=None, bench=None, control: bool = False) -> dict:
    """One run of a cell: -> the result line's object, with "numbers"
    (each compared number beside its limit) as its last key.  The
    numbers compared are the check's readings that the cell's `limits`
    name; `control=True` adds the control's readings ("control") and all
    of the program's ("readings")."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or benchmark()
    drv, cell, config = make_driver(cell_name, seed, device, cell, config)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    drv.setup()
    drv.begin()
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    ends, tokens = [], 0
    while True:
        tokens += drv.step()
        sync(dev)
        t = time.perf_counter()
        ends.append(t)
        if t - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    gaps = [b - a for a, b in zip([t0] + ends[:-1], ends, strict=True)]
    e2e_values = {"decode_tokens_per_s": tokens / window_s,
                  "decode_step_ms_p95": yardstick.p95(gaps) * 1e3,
                  "setup_s": setup_s}
    traced = None
    if trace:
        traced = _traced_window(drv, dev, int(cell["traffic"]["trace_steps"]))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    drv.finish()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell["limits"]
    t_check = time.perf_counter()
    readings = drv.check()
    numbers = {k: readings[k] for k in limits if k in readings}
    over = sum(v > limits[k] for k, v in numbers.items())
    result = {"correct": over == 0 and len(numbers) == len(limits),
              "attempted": tokens, "failed": int(over)}
    e2e, per = cell_metrics(bench, cell_name)
    if trace:
        record = drv.record(traced)
        record.update({"cell": cell_name, "config": config["model"],
                       "trace": traced["trace"]})
        out = {}
        for m in per:
            val = load_module(PB / "metrics" / f"{m['name']}.py").read(record)
            if val is not None:
                out[m["name"]] = {"value": float(val), "unit": m["unit"]}
        result["metrics"] = out
    else:
        result["metrics"] = {m["name"]: {"value": float(e2e_values[m["name"]]),
                                         "unit": m["unit"]} for m in e2e}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        result["device"]["busy_s"] = traced["trace"]["busy_s"]
        result["device"]["window_s"] = traced["trace"]["window_s"]
        result["breakdown"] = {"device_ops": traced["trace"]["device_ops"],
                               "idle_gaps": traced["trace"]["idle_gaps"]}
    result["seconds"] = {"setup": setup_s, "window": window_s,
                         "check": time.perf_counter() - t_check}
    if control:
        result["readings"] = readings
        result["control"] = drv.check(control=True)
    result["numbers"] = {k: {"value": float(v), "limit": float(limits[k])}
                         for k, v in numbers.items()}
    return result


def _traced_window(drv, dev, steps: int) -> dict:
    """Two traced passes of `steps` steps each: the card alone (busy and
    idle time, time by operation), then the host too, with the traffic kind's
    spans around its calls into the program (time by span, idle gaps by
    what the host was doing)."""
    first = drv.steps_done
    with tr.profiler(host=False) as prof:
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            drv.step()
        sync(dev)
        window_s = time.perf_counter() - t0
    out = tr.reduce_device(prof, window_s)
    last = drv.steps_done
    with drv.spans(), tr.profiler(host=True) as prof:
        sync(dev)
        with tr.span(tr.WINDOW):
            for _ in range(steps):
                drv.step()
            sync(dev)
    out.update(tr.reduce_spans(prof))
    out["span_steps"] = steps
    return {"first": first, "last": last, "trace": out}
