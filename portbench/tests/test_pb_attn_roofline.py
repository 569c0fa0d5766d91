"""`attn.roofline_share`'s counts: the yardstick's step counts less a step
with no position attended leave the decode attention alone, for both
decode configurations.

  PYTHONPATH=src python -m pytest portbench/tests -q
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import yardstick  # noqa: E402


def _metric():
    path = ROOT / "portbench" / "metrics" / "attn.roofline_share.py"
    spec = importlib.util.spec_from_file_location("attn_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(cfg, contexts_by_step, device_s):
    b = len(contexts_by_step[0])
    return {"config": cfg, "steps": len(contexts_by_step),
            "tokens": len(contexts_by_step) * b,
            "flops": sum(yardstick.decode_step_flops(cfg, c)
                         for c in contexts_by_step),
            "min_bytes": sum(yardstick.decode_step_min_bytes(cfg, c)
                             for c in contexts_by_step),
            "trace": {"device_s": device_s}}


@pytest.mark.parametrize("config", ["phi4_mini_3_8b", "olmoe_1b_7b"])
def test_attention_counts_are_the_kv_rows_and_attention_flops(config):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json")
                     .read_text())["model"]
    b = 6
    steps = [[2049 + s] * b for s in range(3)]
    rec = _record(cfg, steps, {})
    kv_bytes, flops = _metric().attention_counts(rec)
    hd = yardstick.head_dim(cfg)
    positions = sum(sum(c) for c in steps)
    row = 2 * cfg["n_kv_heads"] * hd * 2 * cfg["n_layers"]   # K and V, bf16
    assert kv_bytes == pytest.approx(row * positions, rel=1e-12)
    assert flops == pytest.approx(sum(
        yardstick.attention_flops(c, cfg["n_heads"], hd, cfg["n_layers"])
        for c in steps), rel=1e-12)


def test_reads_the_kernels_time_and_nothing_without_them():
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "phi4_mini_3_8b.json").read_text())["model"]
    m = _metric()
    steps = [[2304] * 48] * 2
    assert m.read(_record(cfg, steps, {"void at::elementwise_kernel": 1.0})) \
        is None
    rec = _record(cfg, steps, {
        "void (anonymous namespace)::gqa_decode_split_kernel<...>": 0.006,
        "gqa_decode_merge_kernel": 0.002, "ampere_bf16_gemm": 1.0})
    kv_bytes, _ = m.attention_counts(rec)
    assert m.read(rec) == pytest.approx(
        100 * kv_bytes / yardstick.PEAK_HBM_BYTES_PER_S / 0.008)
