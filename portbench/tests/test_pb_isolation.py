"""The benchmark's isolation, its contract and its discovery by name:

  * no module under portbench/ imports a module whose top-level name is
    jax, jaxlib, flax or repro (whole names: repro_torch is the port);
  * the plain reference imports nothing of the program;
  * BENCHMARK.json keeps the contract's shape, names and limits, and
    every name in it has its file;
  * a configuration, a cell and a per-layer metric dropped in as new
    files are found without editing a file that is there;
  * run.py prints no result and exits non-zero without a card.

  PYTHONPATH=src python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _imports(path: pathlib.Path) -> set[str]:
    """Full names of the modules a file imports (absolute imports; a
    relative import inside portbench/ is named from the package)."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(ROOT).parent.parts)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.rsplit(".", node.level - 1)[0] if node.level > 1 \
                    else pkg
                out.add(f"{base}.{node.module}" if node.module else base)
            else:
                out.add(node.module)
    return out


def _files():
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_nor_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def _closure(path: pathlib.Path) -> set[str]:
    """Every module name reached from `path` through portbench's own
    modules."""
    seen, todo, names = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for m in _imports(p):
            names.add(m)
            if m.split(".", 1)[0] == "portbench":
                f = ROOT.joinpath(*m.split(".")).with_suffix(".py")
                if f.exists():
                    todo.append(f)
    return names


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in _closure(path)}
    assert "repro_torch" not in tops, tops
    assert tops <= {"__future__", "math", "numpy", "torch", "portbench"}, tops


def test_benchmark_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["chips"], cell["why"]) == (
            w["config"], w["chips"], w["why"])
        assert (PB / "drivers" / f"{cell['driver']}.py").exists()
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers: dict = {}
    cell_names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cell_names
        assert (PB / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], set()).add(m["name"])
    every = e2e.keys() | {m["name"] for m in b["per_layer"]}
    assert all(NAME.match(n) for n in every)
    assert len(every) == len(b["end_to_end"]) + len(b["per_layer"])
    for w in cell_names:
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


def _copy(tmp_path) -> pathlib.Path:
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    return root


def test_new_files_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "phi4_mini_3_8b.json").read_text())
    cfg["name"] = "probe_model"
    (pb / "configs" / "probe_model.json").write_text(json.dumps(cfg))
    cell = json.loads((pb / "workloads" / "phi4_mini.decode_ctx2k.json")
                      .read_text())
    cell.update(name="probe_model.decode", config="probe_model")
    (pb / "workloads" / "probe_model.decode.json").write_text(
        json.dumps(cell))
    (pb / "metrics" / "probe.share.py").write_text(
        "def read(record):\n    return record.get('probe')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "probe.share", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device",
                               "moves": "decode_tokens_per_s",
                               "workloads": ["probe_model.decode"]})
    bench["workloads"].append({"name": "probe_model.decode",
                               "config": "probe_model", "traffic": "decode",
                               "chips": 1, "why": "probe"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from portbench import harness\n"
        "e2e, per = harness.cell_metrics(harness.benchmark(), "
        "'probe_model.decode')\n"
        "m = harness.load_module(harness.PB / 'metrics' / 'probe.share.py')\n"
        "drv, cell, cfg = harness.make_driver('probe_model.decode', 1, 'cpu')\n"
        "print(json.dumps([harness.names('configs'), "
        "harness.names('workloads'), harness.names('metrics'), "
        "[x['name'] for x in per], m.read({'probe': 7.0}), "
        "cfg['name'], type(drv).__module__]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, check=True).stdout
    configs, cells, metrics, per, val, cfg_name, mod = json.loads(out)
    assert "probe_model" in configs and "probe_model.decode" in cells
    assert "probe.share" in metrics and per == ["probe.share"]
    assert val == 7.0 and cfg_name == "probe_model"
    assert mod.endswith("decode")


def test_run_without_a_card_prints_no_result(tmp_path):
    root = _copy(tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "phi4_mini.decode_ctx2k", "--seed", "2147483659",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=root)
    assert r.returncode != 0 and r.stdout == ""
