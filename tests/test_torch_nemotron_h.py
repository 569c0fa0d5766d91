"""The pattern family (Nemotron-H: Mamba-2, MoE-only and attention-only
blocks in a layer pattern) against the benchmark's plain float32
reference, `portbench/reference/nemotron_h.py` (loaded by path), at a
small size on the CPU: stepwise decode logits, cache rows and Mamba-2
state, the training forward, the grouped gated norm, the sigmoid router
with its correction bias, `routed_scale`, `rope=False` and the untied
head; the hybrid decode driver's counts by hand; and the new config
fields at their defaults, which leave every existing family's decode
logits as they were, bit for bit.

  PYTHONPATH=src python -m pytest tests/test_torch_nemotron_h.py -q
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, obs
from repro_torch.models import (ModelConfig, active_params, build,
                                count_params, init_lm, smoke_config)
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference imports its helpers
    sys.path.insert(0, str(ROOT))


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "nemotron_h_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("portbench/reference/nemotron_h.py")
hd = _load("portbench/drivers/hybrid_decode.py")
dec = sys.modules["portbench.reference.decoder"]

# every kind twice, 2 norm groups, GQA group 4, 8 experts top-2 and a
# shared expert; float32 on both sides, so they agree to rounding
CFG = {"name": "tiny-nemotron-h", "family": "pattern",
       "layer_pattern": "ME*MEM*E", "n_layers": 8, "d_model": 128,
       "n_heads": 8, "n_kv_heads": 2, "head_dim": 16, "d_ff": 32,
       "shared_expert_ff": 48, "mlp_act": "relu2", "n_experts": 8,
       "top_k": 2, "router": "sigmoid_bias", "routed_scale": 2.5,
       "capacity_factor": 4.0, "rope": False, "rope_theta": 10000.0,
       "norm_eps": 1e-5, "ssm_inner": 192, "ssm_headdim": 16, "ssm_state": 8,
       "ssm_ngroups": 2, "ssm_norm_groups": 2, "ssm_conv": 4,
       "ssm_conv_bias": True, "ssm_chunk": 8, "tie_embeddings": False,
       "vocab": 256, "dtype": "float32", "param_dtype": "float32",
       "attn_q_chunk": 8, "attn_k_chunk": 8}
B, PREFIX, STEPS, CACHE = 4, 8, 5, 16


def _port_cfg(cfg: dict) -> ModelConfig:
    kw = dict(cfg)
    for key in ("dtype", "param_dtype"):
        kw[key] = getattr(torch, kw[key])
    return ModelConfig(**kw)


def _context(cfg: dict, model, seed: int = 1):
    """A seeded context: prefix K/V of each attention block and the state
    of each Mamba-2 block, written into a fresh cache; -> (cache, prefix
    by layer, state by layer, tokens (B, STEPS))."""
    g = torch.Generator().manual_seed(seed)
    cache = model.init_cache(B, CACHE)
    pre, st = {}, {}
    for i, c in enumerate(cfg["layer_pattern"]):
        if c == "*":
            kv = cache[f"b{i}"]["attn"]
            pre[i] = tuple(torch.randn((B, PREFIX, cfg["n_kv_heads"],
                                        cfg["head_dim"]), generator=g)
                           for _ in range(2))
            kv["k"][0, :, :PREFIX], kv["v"][0, :, :PREFIX] = pre[i]
        elif c == "M":
            leaves = cache[f"b{i}"]["ssm"]
            st[i] = {k: torch.randn(tuple(v.shape[1:]), generator=g)
                     * (0.1 if k == "h" else 1.0) for k, v in leaves.items()}
            for k, v in st[i].items():
                leaves[k][0].copy_(v)
    tokens = torch.randint(0, cfg["vocab"], (B, STEPS), generator=g)
    return cache, pre, st, tokens


def _decode_both(cfg: dict):
    """The port's stepwise decode from the seeded context and the
    reference's one pass over the same tokens: -> (port logits, ref
    logits (B, STEPS, V), port cache, ref's new K/V rows, ref's h)."""
    w = hd.make_weights(cfg, 3, "cpu")
    model = build(_port_cfg(cfg), device="cpu", params=w)
    cache, pre, st, tokens = _context(cfg, model)
    got = torch.stack([model.decode_step(tokens[:, t:t + 1], cache,
                                         PREFIX + t)
                       for t in range(STEPS)], 1)
    rows, hs = {}, {}
    h = ref.forward(cfg, w, lambda i: pre[i], lambda i: st[i], tokens,
                    PREFIX, on_layer=lambda i, k, v: rows.__setitem__(
                        i, (k, v)), on_state=hs.__setitem__)
    want = dec.linear(h, ref.head(w).t(), False)
    return got, want, cache, rows, hs


def test_weights_match_init_lm():
    for dtype in ("float32", "bfloat16"):
        cfg = dict(CFG, dtype=dtype, param_dtype=dtype)
        w = hd.make_weights(cfg, 5, "cpu")
        want = {k: tuple(v.shape) for k, v in
                init_lm(_port_cfg(cfg), None, "meta").items()}
        assert {k: tuple(v.shape) for k, v in w.items()} == want
        assert all(v.dtype == getattr(torch, dtype) for v in w.values())
        again = hd.make_weights(cfg, 5, "cpu")
        assert all(torch.equal(w[k], again[k]) for k in w)
    a_log = w["blocks.0.ssm.A_log"].float()
    assert torch.allclose(a_log.exp(), torch.arange(1.0, 13.0), rtol=1e-2)
    dt = torch.nn.functional.softplus(w["blocks.0.ssm.dt_bias"].float())
    assert float(dt.min()) >= 0.9e-3 and float(dt.max()) <= 0.11


BASE = {}
# each departure from the base config, which the comparison has to see
CHANGES = [{"routed_scale": 1.0}, {"rope": True}, {"tie_embeddings": True},
           {"ssm_norm_groups": 1}, {"ssm_conv_bias": False},
           {"router": "softmax", "routed_scale": 1.0}, {"norm_eps": 0.5}]


@pytest.mark.parametrize("change", [BASE] + CHANGES,
                         ids=lambda c: "-".join(map(str, c.items()))
                         or "base")
def test_decode_steps_equal_the_reference(change):
    cfg = dict(CFG, **change)
    got, want, cache, rows, hs = _decode_both(cfg)
    assert float((got - want).abs().max()) < 2e-5 * float(want.abs().max())
    sl = slice(PREFIX, PREFIX + STEPS)
    for i, (k, v) in rows.items():
        kv = cache[f"b{i}"]["attn"]
        assert torch.allclose(kv["k"][0, :, sl], k, atol=1e-5)
        assert torch.allclose(kv["v"][0, :, sl], v, atol=1e-5)
    assert sorted(hs) == [0, 3, 5]
    for i, h in hs.items():
        assert torch.allclose(cache[f"b{i}"]["ssm"]["h"][0], h, atol=1e-5)
    if change:      # the change moves the logits: the check can see it
        base = _decode_both(CFG)[0]
        assert float((got - base).abs().max()) > 1e-3


def test_forward_equals_the_reference():
    """The training forward (the chunked SSD, blockwise attention, the
    MoE over a whole sequence) from an empty context."""
    w = hd.make_weights(CFG, 4, "cpu")
    model = build(_port_cfg(CFG), device="cpu", params=w)
    tokens = torch.randint(0, CFG["vocab"], (B, 16),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.forward({"tokens": tokens})
    empty = torch.zeros((B, 0, CFG["n_kv_heads"], CFG["head_dim"]))
    cache = model.init_cache(B, 1)

    def zero_state(i):
        return {k: torch.zeros(tuple(v.shape[1:]))
                for k, v in cache[f"b{i}"]["ssm"].items()}

    # capacity 4.0 drops no choice: not of the forward's B x 16 tokens,
    # nor of the reference's steps of B
    want = ref.forward(CFG, w, lambda i: (empty, empty), zero_state,
                       tokens, 0)
    assert torch.allclose(got, want, atol=2e-5)


def test_grouped_gated_norm():
    g = torch.Generator().manual_seed(3)
    v = torch.randn((3, 12), generator=g) * torch.arange(1.0, 13.0)
    w = torch.randn((12,), generator=g)
    got = ssm_mod._gated_norm(v, w, 2)
    halves = [x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
              for x in v.split(6, -1)]
    assert torch.allclose(got, torch.cat(halves, -1) * w, atol=1e-6)
    assert not torch.allclose(got, ssm_mod._gated_norm(v, w, 1), atol=1e-2)
    assert torch.equal(ssm_mod._gated_norm(v, w, 1),
                       ssm_mod.rms_norm(v, w))
    # the config's eps reaches the norm
    wide = ssm_mod._gated_norm(v, w, 2, 0.5)
    halves = [x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 0.5)
              for x in v.split(6, -1)]
    assert torch.allclose(wide, torch.cat(halves, -1) * w, atol=1e-6)


def test_correction_bias_picks_experts_not_gates():
    cfg = _port_cfg(dict(CFG, n_experts=4, top_k=2))
    xf = torch.eye(4, 128)
    router = torch.zeros((128, 4))
    router[:4] = torch.tensor([[2.0, 1.0, 0.9, -1.0]]).repeat(4, 1)
    bias = torch.tensor([0.0, 0.0, 0.1, 0.0])
    probs, gates, eidx = moe_mod._choose(cfg, xf, {"router": router,
                                                  "bias": bias})
    s = torch.sigmoid(torch.tensor([2.0, 1.0, 0.9, -1.0]))
    # sigmoid(0.9) + 0.1 beats sigmoid(1.0)
    assert eidx[0].tolist() == [0, 2]
    want = s[[0, 2]] / s[[0, 2]].sum() * 2.5   # unbiased, renormalised
    assert torch.allclose(gates[0], want)
    rg, re = ref.choose(dict(CFG, n_experts=4, top_k=2),
                        {"router": router, "bias": bias}, xf)
    assert torch.equal(re, eidx) and torch.allclose(rg, gates)
    unbiased = moe_mod._choose(cfg, xf, {"router": router,
                                         "bias": torch.zeros(4)})[2]
    assert unbiased[0].tolist() == [0, 1]
    # ties go to the lower expert, as the softmax router's do
    router[:4, 2] = 1.0
    tie = moe_mod._choose(cfg, xf, {"router": router,
                                    "bias": torch.zeros(4)})[2]
    assert tie[0].tolist() == [0, 1]


def test_hybrid_counts_by_hand():
    cfg = {"family": "pattern", "layer_pattern": "ME*", "d_model": 8,
           "n_heads": 4, "n_kv_heads": 2, "head_dim": 2, "d_ff": 3,
           "shared_expert_ff": 5, "mlp_act": "relu2", "n_experts": 4,
           "top_k": 2, "router": "sigmoid_bias", "ssm_inner": 8,
           "ssm_headdim": 4, "ssm_state": 2, "ssm_ngroups": 2,
           "ssm_norm_groups": 2, "ssm_conv": 4, "ssm_conv_bias": True,
           "tie_embeddings": False, "vocab": 16, "dtype": "bfloat16",
           "param_dtype": "bfloat16"}
    # per token: attention wq 64 + wk 32 + wv 32 + wo 64 = 192; MoE router
    # 32 + 2 of 4 experts x (24 + 24) = 96 + shared 40 + 40 = 208; SSM wz
    # 64 + wx 64 + wB 32 + wC 32 + wdt 16 + out 64 = 272; head 128
    per_token = 192 + 208 + 272 + 128
    # SSM: conv 2 x 4 x (8 + 2 x 2 x 2) = 128, state 5 x 2 x 2 x 4 = 80
    assert hd.ssm_token_flops(cfg) == 208
    attn = 4 * (5 + 9) * 4 * 2                # 4 ctx Hq hd, one block
    assert hd.step_flops(cfg, [5, 9]) == 2 * per_token * 2 + attn + 2 * 208
    # bytes: blocks with ln1 8: attention 200; MoE 8 + router 32 + 3 of 4
    # experts (4 (1 - 1/2^2)) x 48 + bias 4 + shared 80 = 268; SSM 8 +
    # matrices 272 + conv 64 + conv biases 16 + A_log, dt_bias, D 6 +
    # norm 8 = 374; final_ln 8, head 128: 978 bf16
    weights = 2 * (200 + 268 + 374 + 8 + 128)
    kv = 2 * 2 * 2 * 2 * (5 + 9)              # K and V rows, one block
    state = 4 * (2 * 2 * 4 + 3 * (8 + 8))     # h and conv, a sequence
    assert hd.step_min_bytes(cfg, [5, 9]) == pytest.approx(
        weights + kv + 2 * 2 * state + 2 * 8 * 2 + 2 * 16 * 4)
    assert hd.ssm_min_bytes(cfg, 2) == pytest.approx(
        2 * (374 - 8) + 2 * 2 * state)


CELL = {"name": "small", "config": "small", "driver": "hybrid_decode",
        "chips": 1, "limits": {"own_gap": 0},
        "traffic": {"batch": 8, "prefix": 40, "tokens": 12, "cache_len": 64,
                    "trace_steps": 3}}
SMALL_BENCH = {"end_to_end": [{"name": "decode_tokens_per_s",
                               "unit": "tokens/s"},
                              {"name": "setup_s", "unit": "s"}],
               "per_layer": []}


def _cell_run(dtype: str) -> tuple[dict, dict]:
    """One CPU run of a small hybrid decode cell through the harness ->
    the check's readings and the control's."""
    from portbench import harness

    model = dict(CFG, dtype=dtype, param_dtype=dtype)
    r = harness.run_cell("small", 2147483659, 0.2, False, device="cpu",
                         cell=CELL, config={"model": model},
                         bench=SMALL_BENCH, control=True)
    return r["readings"], r["control"]


PROBE = ("probe_ssm_err", "probe_ssm_h_err", "probe_moe_err",
         "probe_moe_err_p50", "probe_attn_o_err", "probe_attn_err",
         "probe_attn_rows_err", "probe_logits_err")


def test_probe_step_holds_each_block_to_the_reference():
    """The check's probe step: in float32 every block of the program
    equals the reference's on the program's input; in bf16 each reads
    its own rounding, which the float8 control exceeds several times."""
    exact, _ = _cell_run("float32")
    assert all(exact[k] < 1e-5 for k in PROBE), exact
    sound, control = _cell_run("bfloat16")
    for k in PROBE:
        assert 0 < sound[k] < 0.02 and control[k] > 1.5 * sound[k], \
            (k, sound[k], control[k])


def _short_attention(fn):
    def short(q, k, v, length, k_chunk):
        return fn(q, k, v, length=length - 1, k_chunk=k_chunk)
    return short


def _unscaled(fn):
    def unscaled(cfg, xf, p):
        probs, gates, eidx = fn(cfg, xf, p)
        return probs, gates / cfg.routed_scale, eidx
    return unscaled


def _unbiased(fn):
    def unbiased(cfg, xf, p):
        return fn(cfg, xf, dict(p, bias=torch.zeros_like(p["bias"])))
    return unbiased


def _one_group(fn):
    def one_group(v, w, groups, eps=1e-6):
        return fn(v, w, 1, eps)
    return one_group


def _no_conv_bias(fn):
    def no_bias(x, w, state=None, bias=None):
        return fn(x, w, state, None)
    return no_bias


# a fault of each part the probe holds, and the reading that must see it
FAULTS = {
    "attention-misses-a-row": ("attention", "chunked_decode_attention",
                               _short_attention, "probe_attn_o_err"),
    "routed-scale-dropped": ("moe", "_choose", _unscaled, "probe_moe_err"),
    "correction-bias-dropped": ("moe", "_choose", _unbiased,
                                "probe_moe_err"),
    "norm-over-one-group": ("ssm", "_gated_norm", _one_group,
                            "probe_ssm_err"),
    "conv-bias-dropped": ("ssm", "_causal_conv", _no_conv_bias,
                          "probe_ssm_err"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_probe_step_sees_a_fault_of_each_part(monkeypatch, fault):
    from repro_torch.models import attention

    mod, name, make, reading = FAULTS[fault]
    mod = {"attention": attention, "moe": moe_mod, "ssm": ssm_mod}[mod]
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    got, _ = _cell_run("float32")
    assert got[reading] > 1e-2, (reading, got)


def test_the_benchmark_config_counts_the_published_size():
    """The cell's configuration at full size: 31.6 B parameters, 3.2 B
    active a token (the catalog's "31.6B-A3.2B", the embedding lookup
    not counted as active), 23 / 23 / 6 blocks of the three kinds."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "nemotron3_nano_30b_a3b.json").read_text())["model"]
    full = _port_cfg(cfg)
    assert count_params(full) == pytest.approx(31.6e9, rel=2e-3)
    active = active_params(full) - full.vocab * full.d_model
    assert active == pytest.approx(3.2e9, rel=1e-2)
    assert [full.layer_pattern.count(c) for c in "ME*"] == [23, 23, 6]
    assert (full.d_inner, full.ssm_heads) == (4096, 64)


def test_smoke_config_keeps_every_kind():
    cfg = _port_cfg(dict(CFG, layer_pattern="MEMEM*EMEME", n_layers=11,
                         n_experts=128, top_k=6, ssm_inner=4096))
    small = smoke_config(cfg)
    assert small.layer_pattern == "ME*" and small.n_layers == 3
    assert small.d_inner % small.ssm_norm_groups == 0
    model = build(small, device="cpu", seed=0)
    cache = model.init_cache(2, 8)
    out = model.decode_step(torch.zeros((2, 1), dtype=torch.long), cache, 0)
    assert out.shape == (2, small.vocab) and torch.isfinite(out).all()


def test_ssm_decode_span_and_counter():
    w = hd.make_weights(CFG, 6, "cpu")
    model = build(_port_cfg(CFG), device="cpu", params=w)
    cache, _, _, tokens = _context(CFG, model)
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(2):
            model.decode_step(tokens[:, t:t + 1], cache, PREFIX + t)
    snap = obs.snapshot()
    obs.reset()
    n_ssm = CFG["layer_pattern"].count("M")
    assert "ssm.decode" not in snap["counts"]
    assert snap["spans"]["ssm.decode"]["n"] == 2 * n_ssm
    assert snap["spans"]["moe.apply"]["n"] == 2 * CFG[
        "layer_pattern"].count("E")


# sha256 of the float32 logits of 4 decode steps of each family's smoke
# config (`build(seed=0)`, batch 2, tokens from `manual_seed(1)`) before
# the pattern family's fields were added
DIGESTS = {
    "phi4_mini_3_8b":
        "40b6976d3627cb46b23c823f48f7939542562031d742b3aef0e21e3e96236da9",
    "olmoe_1b_7b":
        "2674273c8085adecb94a37338ff6653a14046f1ff92bc49a9038879302a6791f",
    "mamba2_130m":
        "6dc5a92a48880363113a8e43204a1e18091be844d7b5fd76ec218de7b5886fec",
    "zamba2_2_7b":
        "78c9cdee884ba318b48669489e80bd4a57085d44e0d379d32e594f9b58d9ebfd",
}


@pytest.mark.parametrize("arch", sorted(DIGESTS))
def test_default_fields_leave_decode_logits_bit_identical(arch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = configs.get_smoke(arch)
        model = build(cfg, device="cpu", seed=0)
        cache = model.init_cache(2, 16)
        tok = torch.randint(0, cfg.vocab, (2, 4),
                            generator=torch.Generator().manual_seed(1))
        out = torch.stack([model.decode_step(tok[:, i:i + 1], cache, i)
                           for i in range(4)])
    finally:
        torch.set_num_threads(threads)
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == \
        DIGESTS[arch]
