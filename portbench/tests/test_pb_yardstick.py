"""The yardstick's counts against counts worked out by hand at small
shapes, its seeded inputs, and its statistics.

  PYTHONPATH=src python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import yardstick  # noqa: E402
from portbench.reference import kv as kvref  # noqa: E402

DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 32,
         "mlp_act": "swiglu", "dtype": "bfloat16", "param_dtype": "bfloat16"}
MOE = dict(DENSE, family="moe", n_experts=4, top_k=2, moe_every=1,
           d_ff=6, capacity_factor=1.25)


def test_dense_step_flops_by_hand():
    # a layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8, w1 8x16, w2 16x8, w3 8x16
    per_layer = 64 + 32 + 32 + 64 + 128 + 128 + 128
    per_token = 2 * per_layer + 32 * 8                  # + the tied head
    contexts = [5, 9, 3]
    attn = 4 * (5 + 9 + 3) * 2 * 4 * 2                  # 4 ctx Hq hd L
    assert yardstick.decode_step_flops(DENSE, contexts) == \
        2 * per_token * 3 + attn


def test_moe_step_flops_and_bytes_by_hand():
    # attention 64+32+32+64, router 8x4, experts 4 x (8x6 + 6x8 + 8x6)
    attn, router, expert = 192, 32, 48 * 3
    per_token = 2 * (attn + router + 2 * expert) + 32 * 8
    assert yardstick.decode_step_flops(MOE, [4]) == \
        2 * per_token + 4 * 4 * 2 * 4 * 2
    # one token routes to 2 of 4 experts; T = 3 tokens reach
    # 4 (1 - (1/2)^3) = 3.5 experts in expectation
    assert yardstick.expected_experts(MOE, 3) == pytest.approx(3.5)
    read = 2 * (attn + router + 3.5 * expert) + 32 * 8
    row = 2 * 1 * 4 * 2 * 2              # K and V, bf16, 2 layers
    want = (read * 2 + row * (4 + 6 + 2) + 3 * 8 * 2 + 3 * 32 * 4)
    assert yardstick.decode_step_min_bytes(MOE, [4, 6, 2]) == \
        pytest.approx(want)


def test_slot_and_k3_bytes_by_hand():
    # phi4's KV geometry: a page of 16 rows of 8 heads x (128 K + 128 V)
    # bf16, a strip of 8 x (256 + 2) int16
    assert yardstick.slot_bytes(16, 8, 128) == (65536, 4128)
    assert yardstick.k3_bytes(1000.0, 2, 3, 4) == 1000 + 2 * 2 * 3 * 4 * 4


def test_weights_match_the_ports_layout_and_scales():
    from repro_torch.models import init_lm

    from portbench.drivers.decode import model_config

    for cfg in (DENSE, MOE):
        cfg = dict(cfg, name="t", head_dim=4)
        w = yardstick.make_weights(cfg, 5, "cpu")
        want = {k: tuple(v.shape) for k, v in
                init_lm(model_config(cfg), None, "meta").items()}
        assert {k: tuple(v.shape) for k, v in w.items()} == want
        assert all(v.dtype == torch.bfloat16 for v in w.values())
        again = yardstick.make_weights(cfg, 5, "cpu")
        assert all(torch.equal(w[k], again[k]) for k in w)
    big = dict(DENSE, d_model=256, d_ff=512, n_heads=4, head_dim=64,
               vocab=4096)
    w = yardstick.make_weights(big, 1, "cpu")
    assert float(w["blocks.0.mlp.w2"].float().std()) == pytest.approx(
        512 ** -0.5, rel=0.05)
    assert float(w["embed"].float().std()) == pytest.approx(0.02, rel=0.05)


def test_kv_stream_is_seeded_chunked_and_packs_as_stated():
    kw = dict(chunk=64, compressible=True)
    k, v = yardstick.kv_tokens("cpu", 9, 3, 10, 150, 2, 16, **kw)
    k2, v2 = yardstick.kv_tokens("cpu", 9, 3, 0, 192, 2, 16, **kw)
    assert torch.equal(k, k2[10:150]) and torch.equal(v, v2[10:150])
    assert k.dtype == torch.bfloat16 and k.shape == (140, 2, 16)
    slot, strip = yardstick.slot_bytes(16, 2, 16)
    lay = kvref.Layout(k2, v2, page=16, slot=slot, strip=strip)
    assert lay.prefix_fit[:, -1].all()                   # every group packs
    assert lay.bytes(192) == 6 * (slot + strip)
    ki, vi = yardstick.kv_tokens("cpu", 9, 4, 0, 192, 2, 16, chunk=64,
                                 compressible=False)
    lay = kvref.Layout(ki, vi, page=16, slot=slot, strip=strip)
    assert not lay.prefix_fit[:, -1].any()               # none does
    # 70 tokens: 2 raw groups of 2 pages, and a partial group of one page
    assert lay.bytes(70) == 5 * (slot + strip)
    assert lay.raw_bytes(70) == 5 * slot


def test_statistics():
    vals = list(range(1, 101))
    assert yardstick.p95(vals) == 95
    assert yardstick.sub_seed(2**40 + 3, "a", 1) == \
        yardstick.sub_seed(2**40 + 3, "a", 1)
    assert yardstick.sub_seed(1, "a") != yardstick.sub_seed(1, "b")


def test_configs_hold_the_published_widths():
    for path in sorted((ROOT / "portbench" / "configs").glob("*.json")):
        c = json.loads(path.read_text())
        m, p = c["model"], c["published"]
        assert m["d_model"] == p["hidden_size"]
        assert m["n_layers"] == p["num_hidden_layers"]
        assert m["n_heads"] == p["num_attention_heads"]
        assert m["n_kv_heads"] == p["num_key_value_heads"]
        assert m["d_ff"] == p["intermediate_size"]
        assert m["vocab"] == p["vocab_size"]
        assert m.get("n_experts", 0) == p.get("num_experts", 0)
        assert m.get("top_k", 1) == p.get("num_experts_per_tok", 1)
        assert c["reduced"] == []
