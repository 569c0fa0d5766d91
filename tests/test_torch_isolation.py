"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor the reference package, and every entry point defaults to the
card, raising on a machine without one instead of running on the CPU."""

import ast
import inspect
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch, repro_torch.launch.serve
        # the multi-device runtime
        import repro_torch.launch.mesh, repro_torch.runtime.sharding
        import repro_torch.runtime.pipeline, repro_torch.runtime.elastic
        import repro_torch.optim.grad_compress
        # the model cell
        import repro_torch.launch.steps, repro_torch.launch.variants
        import repro_torch.launch.hlo_analysis, repro_torch.models.zoo
        # the dry run
        import repro_torch.launch.dryrun, repro_torch.launch.perf
        for mod in pkgutil.walk_packages(repro_torch.__path__,
                                         "repro_torch."):
            importlib.import_module(mod.name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("ok", len([m for m in sys.modules
                         if m.startswith("repro_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 25


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for name in ("launch/mesh.py", "runtime/sharding.py",
                 "runtime/pipeline.py", "runtime/elastic.py",
                 "optim/grad_compress.py", "launch/steps.py",
                 "launch/variants.py", "launch/hlo_analysis.py",
                 "models/zoo.py", "launch/dryrun.py", "launch/perf.py"):
        assert PKG / name in files, name
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_default_to_cuda():
    from repro_torch import configs
    from repro_torch.bandwidth import device_totals
    from repro_torch.core import batchsim, engine, memsim
    from repro_torch.kv.cache import CRAMKVCache
    from repro_torch.launch import serve
    from repro_torch.models import build, init_lm, smoke_config
    from repro_torch.serving import ServeLoop, SlotKVCache

    init_state = engine.build_engine(engine.SimConfig()).init_state
    for fn in (ServeLoop.__init__, SlotKVCache.__init__,
               CRAMKVCache.__init__, build, init_lm, device_totals,
               memsim.simulate, memsim.run_workload, batchsim.sweep,
               batchsim.sweep_workloads, init_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert serve.build_parser().parse_args([]).device == "cuda"
    # the multi-device entries: a mesh on the card, devices from the cards
    from repro_torch.device import device_list
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.elastic import Grid
    from repro_torch.serving import shard_kv_attend
    assert inspect.signature(make_host_mesh).parameters[
        "device_type"].default == "cuda"
    assert inspect.signature(Grid.build).parameters[
        "device_type"].default == "cuda"
    assert inspect.signature(device_list).parameters["device"].default == \
        "cuda"
    for fn in (batchsim.sweep, batchsim.sweep_workloads, shard_kv_attend):
        assert inspect.signature(fn).parameters["devices"].default is None
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        device_list()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_list(["cpu", "cuda:0"], "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(slots=1, max_pages=4, page=4, n_kv=1, head_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotKVCache(4, 4, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--batch", "4", "--slots", "2", "--admit-rate", "4",
                    "--kv-policy", "auto", "--spill-pages", "64"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(slots=1, max_pages=4, page=4, n_kv=1, head_dim=8,
                  spill_packing="pair", spill_pages=8, async_spill=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(smoke_config(configs.get("phi4_mini_3_8b")),
                torch.Generator())
    trace = (np.zeros((1, 4), np.int32), np.zeros((1, 4), bool),
             *(np.zeros((1, 1 << 18), bool),) * 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        memsim.simulate("cram", *(x[0] for x in trace))
    with pytest.raises(RuntimeError, match="CUDA"):
        memsim.run_workload("libq", n_events=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        batchsim.sweep(["cram"], *trace)
    with pytest.raises(RuntimeError, match="CUDA"):
        batchsim.sweep_workloads(["libq"], n_events=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(np.zeros((1, engine.N_PARAMS), np.int32))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, the script prints no result
    and exits non-zero."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
