"""The port's analyzer on its fixtures and on the port's tree, and the
launch audit against its golden (port of `tests/test_analysis.py`).

Contracts:

  * each rule FIRES on its known-bad fixture under
    `tests/fixtures/torch_analysis/` (torch idiom; a CUDA source for R1;
    `repro_torch/...` subtrees for the path-scoped R3 strict scope, R5
    and R6), each finding names its own rule, and the CLI exits non-zero
    on it;
  * the rule engine is CLEAN on today's `src/repro_torch/` (its Python
    and CUDA sources) and `chip_smoke.py`;
  * the launch audit meets its hard invariants on the CPU, matches
    `tests/golden/torch_launch_audit.json`, and `compare` detects drift.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import analyze, default_paths, render_report
from repro_torch.analysis import launch_audit
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.rules.r1_marker_literals import (
    cuda_int_literals, protected_constants)

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures" / "torch_analysis"
ROOT = Path(__file__).resolve().parents[1]

RULE_FIXTURES = {
    "r1": FIXTURES / "r1_bad.py",
    "r1_cuda": FIXTURES / "r1_bad.cu",
    "r2": FIXTURES / "r2_bad.py",
    "r3": FIXTURES / "r3_bad.py",
    "r3_prefill": FIXTURES / "r3_prefill_bad.py",
    "r3_strict": FIXTURES / "repro_torch" / "serving" / "slots.py",
    "r4": FIXTURES / "r4_bad.py",
    "r5": FIXTURES / "repro_torch" / "r5_bad.py",
    "r6": FIXTURES / "repro_torch" / "kernels" / "r6_bad.py",
}

# every fixture encodes this many distinct violations of its rule
FINDINGS = {"r1": 1, "r1_cuda": 3, "r2": 3, "r3": 6, "r3_prefill": 5,
            "r3_strict": 4, "r4": 4, "r5": 2, "r6": 5}


def _rule(case: str) -> str:
    return case.split("_")[0]


@pytest.mark.parametrize("case", sorted(RULE_FIXTURES))
def test_rule_fires_on_fixture(case):
    rule = _rule(case)
    found = analyze([RULE_FIXTURES[case]], rules=[rule])
    assert len(found) == FINDINGS[case], \
        f"{case} found {len(found)} on its bad fixture: {found}"
    assert all(v.rule == rule for v in found)
    assert all(v.line > 0 for v in found)


@pytest.mark.parametrize("case", sorted(RULE_FIXTURES))
def test_cli_exits_nonzero_on_fixture(case, capsys):
    assert cli_main([str(RULE_FIXTURES[case])]) == 1
    assert f"[{_rule(case)}]" in capsys.readouterr().out


def test_fixture_findings_are_rule_scoped():
    """A fixture only has to be bad its OWN way: with all rules on, each
    fixture (the path-scoped ones too) still reports its own rule, and
    every finding names a registered rule."""
    for case, path in RULE_FIXTURES.items():
        found = analyze([path])
        assert any(v.rule == _rule(case) for v in found), (case, found)
        assert {v.rule for v in found} <= set(render_report(
            [], files_scanned=0)["rules"])


def test_r1_reads_cuda_literals_and_skips_comments():
    src = ("// 0x9E3779B1 in a comment\n"
           "const char* s = \"0x85EBCA6B\";\n"
           "int a = 0x27D4EB2FU, b = 24301, c = 0x5EEDull, d = 1'000;\n")
    got = list(cuda_int_literals(src))
    assert got == [(0x27D4EB2F, 3), (24301, 3), (0x5EED, 3), (1000, 3)]
    assert {0x9E3779B1, 0x85EBCA6B, 0x27D4EB2F, 0x5EED,
            0x9E3779B9} <= protected_constants()


def test_compress_scan_takes_framing_multipliers_as_defines():
    """K7's source holds no marker literal: the build passes framing's
    multipliers, and the values it passes are framing's."""
    from repro_torch.compression import framing
    from repro_torch.kernels import cuda_lib

    src = ROOT / "src" / "repro_torch" / "csrc" / "compress_scan.cu"
    assert analyze([src], rules=["r1"]) == []
    text = src.read_text()
    for name in cuda_lib.FRAMING_DEFINES:
        assert f"CRAM_{name}" in text
    assert cuda_lib.framing_defines() == tuple(
        f"-DCRAM_{n}={getattr(framing, n):#x}u"
        for n in ("M2_MULT", "M4_MULT", "IL_MULT"))


def test_tree_is_clean():
    violations = analyze(default_paths())
    assert violations == [], "\n".join(str(v) for v in violations)


def test_cli_clean_tree_exit_zero(tmp_path):
    out = tmp_path / "report.json"
    assert cli_main(["--report", "json", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True
    assert report["counts"] == {}
    assert report["files_scanned"] > 100
    assert any(p.suffix == ".cu" for p in
               (ROOT / "src" / "repro_torch" / "csrc").iterdir())
    assert set(report["rules"]) == {f"r{i}" for i in range(1, 7)}


def test_render_report_shape():
    found = analyze([RULE_FIXTURES["r4"]], rules=["r4"])
    report = render_report(found, files_scanned=1)
    assert report["ok"] is False
    assert report["counts"]["r4"] == len(found)
    assert report["violations"][0]["rule"] == "r4"


def test_r3_strict_scope_follows_the_audit():
    """The strict scope is the functions the launch audit names, found
    by path and qualname: the fixture's `helper` is neither audited nor
    hot-named, and `megastep` elsewhere is only hot-named."""
    from repro_torch.analysis.rules.r3_host_sync import audited

    scopes = audited()
    assert "SlotKVCache.megastep" in scopes["repro_torch/serving/slots.py"]
    assert "build_engine.run_chunk" in scopes["repro_torch/core/engine.py"]
    found = analyze([RULE_FIXTURES["r3_strict"]], rules=["r3"])
    assert all("'megastep'" in v.message for v in found)


# ------------------------------------------------------------ launch audit


@pytest.fixture(scope="module")
def audit_report():
    return launch_audit.audit("cpu")


def test_audit_hard_invariants(audit_report):
    golden = json.loads(launch_audit.GOLDEN_PATH.read_text())
    assert launch_audit.hard_violations(
        audit_report, launch_audit.known_syncs(golden)) == []
    # E1's host entry no longer waits: no entry syncs, golden or not
    assert launch_audit.hard_violations(audit_report) == []
    # a sync is a violation unless a pinned reason allows its count
    report = json.loads(json.dumps(audit_report))
    report["engine_chunk"]["pinned"]["host_syncs"] = 1
    bad = launch_audit.hard_violations(report)
    assert len(bad) == 1 and bad[0].startswith("engine_chunk: 1 host sync")
    assert launch_audit.hard_violations(report, {"engine_chunk": 1}) == []


def test_audit_matches_golden(audit_report):
    golden = json.loads(launch_audit.GOLDEN_PATH.read_text())
    assert launch_audit.compare(audit_report, golden) == []
    assert set(golden["entries"]) == set(launch_audit.ENTRIES)


@pytest.mark.parametrize("entry,key,value", [
    ("fused_decode_pair", "kernel_calls", {"decode_attention_pair": 2}),
    ("serve_megastep", "aten_ops", 1),
    ("serve_prefill", "host_syncs", 1),
])
def test_audit_compare_detects_drift(audit_report, entry, key, value):
    golden = json.loads(json.dumps(launch_audit.golden_view(audit_report)))
    golden["entries"][entry]["pinned"][key] = value
    drift = launch_audit.compare(audit_report, golden)
    assert any(entry in m and key in m for m in drift), drift
    golden["entries"]["serve_scatters"]["inplace"] = False
    assert any("serve_scatters: inplace" in m
               for m in launch_audit.compare(audit_report, golden))


def test_audit_golden_pins_the_kernel_budget():
    """The committed golden itself: one kernel call per fused decode,
    serve step and prompt ingest; no host sync (E1's launch no longer
    waits: nothing is pinned with a reason); no float64; state in place
    where the reference donates it; a host-only checkpoint pack."""
    entries = json.loads(launch_audit.GOLDEN_PATH.read_text())["entries"]
    for name in launch_audit.ONE_KERNEL:
        assert sum(entries[name]["pinned"]["kernel_calls"].values()) == 1
    for name, entry in entries.items():
        assert entry["f64"] is False
        want = entry.get("known_syncs", {}).get("count", 0)
        assert entry["pinned"]["host_syncs"] == want, name
    assert "known_syncs" not in entries["engine_chunk"]
    assert entries["engine_chunk"]["pinned"]["host_syncs"] == 0
    for name in ("serve_scatters", "serve_megastep", "serve_prefill",
                 "kv_step_booking"):
        assert entries[name]["inplace"] is True
    assert entries["serve_scatters"]["pinned"]["scatter_tokens_inplace"]
    ck = entries["ckpt_pack_batch"]["pinned"]
    assert ck["torch_tensors_created"] == 0 and ck["codecs_audited"] == 4


def test_audit_update_keeps_pinned_reasons(tmp_path, audit_report):
    path = tmp_path / "golden.json"
    path.write_text(launch_audit.GOLDEN_PATH.read_text())
    rep = launch_audit.run(path, update=True, device="cpu")
    assert rep["mismatches"] == [] and rep["updated"]
    assert json.loads(path.read_text()) == json.loads(
        launch_audit.GOLDEN_PATH.read_text())
    assert cli_main(["--audit", "--device", "cpu", "--golden", str(path),
                     str(RULE_FIXTURES["r4"])]) == 1     # the r4 fixture


def test_audit_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_audit.audit()
