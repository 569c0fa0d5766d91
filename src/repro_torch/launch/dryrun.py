"""Multi-pod dry run: count every (arch x shape x mesh) cell on fake
tensors in a fake world (port of `repro.launch.dryrun`).

The reference AOT-compiles each cell's step against `ShapeDtypeStruct`s
on 256 / 512 placeholder devices.  The port has no compiler to ask: it
runs the cell's step once, eagerly, on rank 0 of a world of fake ranks
(torch's "fake" process group: every collective returns at once, moving
nothing) with every argument a zero DTensor of `FakeTensor`s (shapes,
dtypes and devices, no storage) at the cell's placements, under
`hlo_analysis.analyze_step`.  Nothing is allocated and nothing is drawn
from a seed.  For each cell it records:
  * memory_analysis   argument, output and temp bytes of one device
                      (`peak_bytes` = argument + temp: proves the cell
                      fits a card's 80 GB, or that it does not)
  * flops, bytes_accessed   of one device, for the roofline terms
  * collectives       the bytes and counts of each type on rank 0
into experiments/torch_dryrun/<arch>__<shape>__<mesh>[__<variant>].json.

The top-level numbers count every op the step runs, remat's recompute
and every microbatch included, at the cell's own config; to keep a sweep
short they come from two depths of it (`depth_count`: exact for flops,
bytes and collectives, which are linear in depth).  The reference's come
from XLA's cost analysis of a scan, which counts the body once; its
`probe_costs` corrects that by two depth probes, and the port keeps the
probes and the roofline on their extrapolation, so the two records read
alike.  A dry run on fake tensors has no routing to count: an MoE cell
dispatches every (expert, capacity row) cell as full
(`models/moe.py:_moe_on_mesh`), so its all-to-all bytes are those of
full capacity.  The decode runs at index seq_len - 1.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] [--jobs 7]
  python -m repro_torch.launch.dryrun --arch ... --shape ... --variant no_fsdp
  python -m repro_torch.launch.dryrun --arch ... --shape ... --peak-tensors 12

The fake tensors live on `--device` (default "cuda", which raises without
a card; `--device cpu` counts on a machine without one).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from .. import configs
from ..models import SHAPES_BY_NAME, STANDARD_SHAPES, active_params, \
    count_params
from .hlo_analysis import analyze_step, argument_bytes
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS, make_production_mesh, \
    mesh_chip_count
from .steps import build_cell, place_zeros
from .variants import apply_variant

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch_dryrun"

# long_500k runs only for sub-quadratic (SSM/hybrid) archs; full-attention
# archs skip it (noted in DESIGN.md §Arch-applicability).
LONG_OK_FAMILIES = ("ssm", "hybrid")


def _with_supers(cfg, k: int, seq_len: int):
    """Config scaled to k super-blocks, one microbatch and no remat, for
    cost probes; the reference's, field for field.

    Attention/xent chunks are capped for long sequences as the reference
    caps them (it keeps its unrolled probe compilable; here they only cut
    the op count): the matmul volume (flops) is chunking-invariant, the
    bytes accessed of the bigger chunks differ a little.
    """
    kw = {"microbatches": 1, "unroll": True, "remat": False}
    if seq_len > 8192:
        kw.update(
            attn_q_chunk=max(cfg.attn_q_chunk, seq_len // 8),
            attn_k_chunk=max(cfg.attn_k_chunk, seq_len // 4),
            xent_chunk=max(cfg.xent_chunk, 4096),
            ssm_chunk=max(cfg.ssm_chunk, seq_len // 16),
        )
    return cfg.replace(**kw, **_depth(cfg, k))


def _depth(cfg, k: int) -> dict:
    """The config fields that make `cfg` k super-blocks deep."""
    from ..models.transformer import super_block_spec

    if cfg.family == "encdec":
        return {"n_layers": k, "enc_layers": k, "dec_layers": k}
    per = len([b for b in super_block_spec(cfg) if b != "shared"])
    return {"n_layers": k * per}


def _n_supers(cfg) -> int:
    from ..models.transformer import n_supers

    return cfg.enc_layers if cfg.family == "encdec" else n_supers(cfg)


def _line(p2, p4, ns: int):
    """The line through p(2) and p(4), at ns: an int where both are."""
    v = p2 + (p4 - p2) / 2.0 * (ns - 2)
    return round(v) if isinstance(p2, int) and isinstance(p4, int) else v


def count_cell(cfg, spec, mesh, rules=None, opts=None, *,
               device="cuda", peak_tensors: int = 0) -> dict:
    """One cell counted: built by `build_cell` on `mesh`, its arguments
    placed by `place_zeros` under a `FakeTensorMode` (any data-dependent
    op raises), its step run once under `analyze_step`.  Returns
    {flops, bytes_accessed, collectives, memory_analysis, peak_bytes,
    argument_bytes} (and when asked for, `peak_tensors`: the largest
    storages live at the peak, under the count's depth); the argument
    bytes are counted from the specs (`argument_bytes`), the decode's
    index (a Python int here) included."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn, specs, shards, _ = build_cell(cfg, spec, mesh, rules,
                                      fsdp=(opts or {}).get("fsdp", True))
    with FakeTensorMode():
        args = place_zeros(fn, specs, shards, index=spec.seq_len - 1,
                           device=device)
        info = analyze_step(fn, *args, peak_tensors=peak_tensors)
    del info["out"], args
    if peak_tensors:
        info["peak_tensors"] = {str(_n_supers(cfg)): info["peak_tensors"]}
    held = argument_bytes(specs, shards)
    info["argument_bytes"] = held
    info["memory_analysis"]["argument_size_in_bytes"] = held
    info["peak_bytes"] = held + info["memory_analysis"]["temp_size_in_bytes"]
    return info


def probe_costs(cfg, spec, mesh, rules, opts=None, *, device="cuda") -> dict:
    """Per-step flops / bytes / collective bytes extrapolated from depth
    probes, with the reference's semantics: every per-step quantity is
    linear in the super-block count NS, p(NS) = a + b * NS; the cell is
    counted at NS = 2 and 4 (`_with_supers`: one microbatch, no remat),
    (a, b) solved, and p evaluated at the real NS.  Exact for everything
    that scales with depth, including the ZeRO optimizer update."""
    def measure(k):
        info = count_cell(_with_supers(cfg, k, spec.seq_len), spec, mesh,
                          rules, opts, device=device)
        return (info["flops"], float(info["bytes_accessed"]),
                {t: float(n) for t, n in
                 info["collectives"]["bytes_by_type"].items()})

    ns_full = _n_supers(cfg)
    f2, b2, c2 = measure(2)
    f4, b4, c4 = measure(4)

    def lin(p2, p4):
        return _line(p2, p4, ns_full)

    coll = {k: lin(c2.get(k, 0), c4.get(k, 0)) for k in set(c2) | set(c4)}
    mb = max(1, cfg.microbatches) if spec.kind == "train" else 1
    return {
        "ns_full": ns_full,
        "flops": lin(f2, f4),
        "bytes_accessed": lin(b2, b4),
        "collective_bytes_by_type": coll,
        # mb > 1 repeats the fwd/bwd FSDP gathers per microbatch
        "collective_bytes_total": sum(coll.values()),
        "collective_bytes_total_mb_scaled": sum(coll.values()) * mb,
        "microbatches": mb,
    }


def depth_count(cfg, spec, mesh, rules=None, opts=None, *,
                device="cuda", peak_tensors: int = 0) -> dict:
    """The cell counted as `count_cell` counts it, but from two depths
    of its own config (its microbatches, remat and chunks): the counts
    at NS = 2 and 4 super-blocks, each quantity on the line through them
    at the real NS (`counted_at` [2, 4]); a cell of at most 4
    super-blocks is counted at its depth (`counted_at` [NS]).  A count's
    cost is about its op count, so a full-depth train cell takes minutes
    on a host CPU; flops, bytes accessed and collectives are linear in
    NS, so the line gives them exactly, and the temp and output bytes of
    a stack of equal super-blocks are linear too (held against a
    full-depth count in PERF.md).  The argument bytes are the full
    cell's, counted from its specs.  `peak_tensors` (the largest storages
    live at the peak) are those of each depth counted, by depth."""
    ns = _n_supers(cfg)
    if ns <= 4:
        return {**count_cell(cfg, spec, mesh, rules, opts, device=device,
                             peak_tensors=peak_tensors),
                "counted_at": [ns]}
    at = [count_cell(cfg.replace(**_depth(cfg, k)), spec, mesh, rules, opts,
                     device=device, peak_tensors=peak_tensors)
          for k in (2, 4)]
    tops = {k: v for c in at for k, v in c.pop("peak_tensors", {}).items()}

    def line(a, b):
        if isinstance(a, dict):
            return {k: line(a[k], b[k]) for k in a}
        return _line(a, b, ns)

    out = line(*at)
    _, specs, shards, _ = build_cell(cfg, spec, mesh, rules,
                                     fsdp=(opts or {}).get("fsdp", True))
    held = argument_bytes(specs, shards)
    out["argument_bytes"] = out["memory_analysis"][
        "argument_size_in_bytes"] = held
    out["peak_bytes"] = held + out["memory_analysis"]["temp_size_in_bytes"]
    out["counted_at"] = [2, 4]
    if tops:
        out["peak_tensors"] = tops
    return out


def cell_applicable(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.family in LONG_OK_FAMILIES
    return True


def fake_world(size: int) -> None:
    """Make the process's default group a fake world of `size` ranks,
    this process rank 0 (torch's "fake" backend over a `FakeStore`): a
    fake world of another size is replaced, and a real one refused, so
    that a dry run never runs a step on real ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(f"a dry run needs a fake world; this "
                               f"process's default group is a real one "
                               f"({backend}, {dist.get_world_size()} ranks)")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "base", force: bool = False, *,
             device="cuda", full_depth: bool = False,
             peak_tensors: int = 0) -> dict:
    """Count one cell on the production mesh ((32, 8), or (2, 32, 8)
    with `multi_pod`) in a fake world of its 256 / 512 ranks, write its
    record and return it; a record already written is returned as it is
    unless `force`.  The count is `depth_count`'s, or with `full_depth`
    `count_cell`'s at the cell's own depth (what `depth_count` is held
    against).  With `peak_tensors` the record also lists that many of
    the largest storages live at the peak, by depth counted.  A failure
    is recorded (ok false, the error and its traceback), never raised; a
    probe failure is recorded as `probe_error` and the roofline then
    reads the count."""
    from ..device import resolve_device

    mesh_name = "2x32x8" if multi_pod else "32x8"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        f"__{variant}" if variant != "base" else "")
    out_path = OUT_DIR / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    dev = resolve_device(device)
    cfg = configs.get(arch)
    spec = SHAPES_BY_NAME[shape_name]
    if not cell_applicable(cfg, shape_name):
        rec = {"tag": tag, "skipped": True,
               "reason": "full-attention arch: long_500k needs "
                         "sub-quadratic attention (DESIGN.md)"}
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    cfg, rules, opts = apply_variant(cfg, spec, variant)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    chips = mesh_chip_count(mesh)
    rec = {
        "tag": tag, "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "chips": chips, "family": cfg.family,
        "params": count_params(cfg), "active_params": active_params(cfg),
        "seq_len": spec.seq_len, "global_batch": spec.global_batch,
        "kind": spec.kind, "device": dev.type,
    }
    try:
        t0 = time.time()
        if full_depth:
            rec.update(count_cell(cfg, spec, mesh, rules, opts, device=dev,
                                  peak_tensors=peak_tensors),
                       counted_at=[_n_supers(cfg)])
        else:
            rec.update(depth_count(cfg, spec, mesh, rules, opts,
                                   device=dev, peak_tensors=peak_tensors))
        rec["count_s"] = round(time.time() - t0, 2)
        rec["ok"] = True
        try:
            probe = probe_costs(cfg, spec, mesh, rules, opts, device=dev)
        except Exception as pe:  # the count stands; the roofline is flagged
            rec["probe_error"] = repr(pe)[:300]
            probe = {
                "flops": rec["flops"],
                "bytes_accessed": rec["bytes_accessed"],
                "collective_bytes_total_mb_scaled": rec["collectives"][
                    "total_bytes"],
                "collective_bytes_by_type": rec["collectives"][
                    "bytes_by_type"],
                "note": "probe failed: the full-depth count's numbers",
            }
        rec["extrapolated"] = probe
        terms = {
            "compute_s": probe["flops"] / PEAK_FLOPS,
            "memory_s": probe["bytes_accessed"] / HBM_BW,
            "collective_s": probe["collective_bytes_total_mb_scaled"]
            / NVLINK_BW,
        }
        terms["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                                key=lambda k: terms[k])
        rec["roofline"] = terms
    except Exception as e:
        rec["ok"] = False
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    status = "OK" if rec.get("ok") else "FAIL"
    roof = rec.get("roofline", {})
    print(f"[{status}] {tag} count={rec.get('count_s')}s "
          f"peak={rec.get('peak_bytes')} flops={rec.get('flops')} "
          f"bytes={rec.get('bytes_accessed')} coll="
          f"{rec.get('collectives', {}).get('total_bytes')} "
          + " ".join(f"{k}={roof.get(k)}" for k in (
              "compute_s", "memory_s", "collective_s", "dominant")),
          flush=True)
    return rec


def _sweep_in_processes(cells, variant: str, argv: list, jobs: int) -> list:
    """Each (arch, shape, multi_pod) cell of `cells` counted by this
    module at `variant` in a process of its own with the flags `argv`
    (the default process group is global, so a process counts one mesh),
    `jobs` at a time in the given order; each process's "[OK]" / "[FAIL]"
    line (all its output if it failed) printed as it ends.  Returns the
    records (a cell whose process wrote none: ok false)."""
    import subprocess
    import sys

    queue, running, recs = list(cells), {}, []
    while queue or running:
        while queue and len(running) < jobs:
            arch, shape, mp = cell = queue.pop(0)
            running[cell] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--variant", variant,
                 *(["--multi-pod"] if mp else []), *argv],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell, proc in list(running.items()):
            if proc.poll() is None:
                continue
            del running[cell]
            lines = proc.stdout.read().splitlines(keepends=True)
            proc.stdout.close()
            if proc.returncode == 0:
                lines = [ln for ln in lines
                         if ln.startswith(("[OK]", "[FAIL]"))]
            print("".join(lines), end="", flush=True)
            arch, shape, mp = cell
            tag = f"{arch}__{shape}__{'2x32x8' if mp else '32x8'}" + (
                f"__{variant}" if variant != "base" else "")
            path = OUT_DIR / f"{tag}.json"
            recs.append(json.loads(path.read_text()) if path.exists() else
                        {"tag": tag, "ok": False,
                         "error": f"exit {proc.returncode}"})
        time.sleep(0.2)
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda needs a card)")
    ap.add_argument("--full-depth", action="store_true",
                    help="count at the cell's own depth, not from two")
    ap.add_argument("--peak-tensors", type=int, default=0, metavar="N",
                    help="record the N largest storages live at the peak")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells counted in this many processes "
                         "at once")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(arch, spec.name, mp) for arch in configs.ARCHS
                 for spec in STANDARD_SHAPES for mp in meshes]
        if args.jobs > 1:
            flags = ["--device", args.device, "--peak-tensors",
                     str(args.peak_tensors)]
            flags += ["--force"] * args.force
            flags += ["--full-depth"] * args.full_depth
            recs = _sweep_in_processes(cells, args.variant, flags,
                                       args.jobs)
        else:
            recs = [run_cell(arch, shape, mp, args.variant, args.force,
                             device=args.device, full_depth=args.full_depth,
                             peak_tensors=args.peak_tensors)
                    for arch, shape, mp in cells]
        failures = sum(not (r.get("ok") or r.get("skipped")) for r in recs)
        print(f"dry-run sweep complete; failures={failures}")
        raise SystemExit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    for mp in meshes:
        rec = run_cell(configs.canonical(args.arch), args.shape, mp,
                       args.variant, args.force, device=args.device,
                       full_depth=args.full_depth,
                       peak_tensors=args.peak_tensors)
        if not (rec.get("ok") or rec.get("skipped")):
            print(rec.get("traceback", rec.get("error")))
            raise SystemExit(1)


if __name__ == "__main__":
    main()
