"""Port parity for the model zoo's decoder families (moe, ssm, hybrid,
vlm) and the eight configs beside phi4-mini-3.8B: the same numpy-seeded
inputs and the reference's weights (carried across by
`repro_torch.convert.params_from_jax`) go through both packages.

Smoke configs compute in float32, so outputs agree within
atol = rtol = 1e-4 (different matmul and reduction orders), greedy tokens
are equal, and the MoE routing (experts, kept rows, dispatch rows) is
equal, dropped contributions included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import active_params as r_active
from repro.models import build as r_build
from repro.models import count_params as r_count
from repro.models.attention import attention_apply as r_attention
from repro.models.attention import attention_init as r_attention_init
from repro.models.common import Initializer as RInit
from repro.models.common import split_tree
from repro.models.moe import moe_apply as r_moe_apply
from repro.models.moe import moe_init as r_moe_init
from repro.models.ssm import ssm_decode_step as r_ssm_step
from repro.models.ssm import ssm_init as r_ssm_init
from repro.models.ssm import ssm_init_cache as r_ssm_cache
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.models import active_params as t_active
from repro_torch.models import build as t_build
from repro_torch.models import count_params as t_count
from repro_torch.models.attention import cross_attention
from repro_torch.models.moe import capacity, moe_apply, moe_route
from repro_torch.models.ssm import ssm_decode_step, ssm_init_cache

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
# the decoder families; whisper's encdec has tests/test_torch_whisper.py
DECODER_ARCHS = [a for a in t_configs.ARCHS if a != "whisper_base"]
NEW_ARCHS = [a for a in DECODER_ARCHS if a != "phi4_mini_3_8b"]


def _tree(init, cfg, seed=0):
    """A reference sub-tree from its init function, as numpy leaves."""
    values, _ = split_tree(init(RInit(jax.random.key(seed)), cfg))
    return jax.tree.map(np.asarray, values)


def _torch(tree):
    """numpy leaves -> torch tensors, nesting kept (the compute-dtype
    dicts the port's block functions take; float32 here)."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _reference_routing(probs, k, cap):
    """The routing lines of the reference's `moe_apply` (its
    repro/models/moe.py:49-64) on given probabilities: (eidx, keep,
    dest)."""
    T, E = probs.shape
    _, eidx = jax.lax.top_k(probs, k)
    flat_e = eidx.reshape(T * k)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    offsets = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - offsets[sorted_e]
    keep = rank < cap
    dest = sorted_e * cap + jnp.where(keep, rank, 0)
    return [np.asarray(a) for a in (eidx, keep, dest)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p for k, v in tree.items()
                for p in _paths(v, f"{prefix}/{k}")}
    return {prefix}


MOE_CASES = {
    # olmoe's 64 experts top-8 at decode batch 4: capacity 1
    "olmoe-decode": (dict(n_experts=64, top_k=8), 4, 1),
    "olmoe-prefill": (dict(n_experts=64, top_k=8), 96, 15),
    # maverick's 128 experts top-1 with its shared expert
    "maverick-decode": (dict(n_experts=128, top_k=1, shared_expert_ff=48),
                        4, 1),
    "maverick-prefill": (dict(n_experts=128, top_k=1, shared_expert_ff=48),
                         96, 1),
}


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_apply_matches_reference(case):
    over, tokens, cap = MOE_CASES[case]
    base = dict(family="moe", d_model=64, d_ff=32, dtype=jnp.float32,
                param_dtype=jnp.float32, **over)
    cfg_r = r_configs.get("olmoe_1b_7b").replace(**base)
    cfg_t = t_configs.get("olmoe_1b_7b").replace(
        **{**base, "dtype": torch.float32, "param_dtype": torch.float32})
    assert capacity(cfg_t, tokens) == cap
    tree = _tree(r_moe_init, cfg_r)
    # a router of scale 1 spreads the choices, so that experts collide
    tree["router"] = tree["router"] * 50.0
    x = np.random.default_rng(1).standard_normal(
        (tokens // 4, 4, 64)).astype(np.float32)
    y_r, aux_r = r_moe_apply(tree, cfg_r, jnp.asarray(x))
    p = _torch(tree)
    y_t, aux_t = moe_apply(p, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **TOL)

    probs = np.array(jax.nn.softmax(
        (jnp.asarray(x).reshape(tokens, 64) @ tree["router"]), axis=-1))
    eidx, keep, dest = _reference_routing(jnp.asarray(probs), cfg_t.top_k,
                                          cap)
    r = moe_route(torch.from_numpy(probs), cfg_t.top_k, cap)
    assert np.array_equal(r.eidx.numpy(), eidx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.dest.numpy(), dest)
    if case == "olmoe-decode":
        assert not keep.all()       # the capacity of 1 drops contributions


def test_moe_route_breaks_ties_by_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.2, 0.2, 0.2]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    r = moe_route(torch.from_numpy(probs), 2, 2)
    assert np.array_equal(r.eidx.numpy(), np.asarray(want))
    assert r.eidx.tolist() == [[1, 2], [0, 1], [0, 1]]


def test_ssm_decode_step_matches_reference():
    cfg_r = r_configs.get_smoke("mamba2_130m")
    cfg_t = t_configs.get_smoke("mamba2_130m")
    tree = _tree(r_ssm_init, cfg_r)
    # non-trivial A and dt so that decay and softplus are exercised
    rng = np.random.default_rng(2)
    tree["A_log"] = rng.standard_normal(tree["A_log"].shape).astype(
        np.float32)
    tree["dt_bias"] = rng.standard_normal(tree["dt_bias"].shape).astype(
        np.float32)
    p = _torch(tree)
    b = 3
    cache_r = r_ssm_cache(cfg_r, b)
    cache_t = ssm_init_cache(cfg_t, b, "cpu")
    for step in range(8):
        x = rng.standard_normal((b, 1, cfg_r.d_model)).astype(np.float32)
        y_r, cache_r = r_ssm_step(tree, cfg_r, jnp.asarray(x), cache_r)
        y_t = ssm_decode_step(p, cfg_t, torch.from_numpy(x), cache_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r),
                                   err_msg=f"step {step}", **TOL)
        for key in ("h", "conv_x", "conv_B", "conv_C"):
            np.testing.assert_allclose(cache_t[key].numpy(),
                                       np.asarray(cache_r[key]),
                                       err_msg=f"{key} step {step}", **TOL)
            assert cache_t[key].dtype == torch.float32


@pytest.mark.parametrize("with_images", [False, True],
                         ids=["launcher-no-images", "image-embeds"])
def test_cross_attention_matches_reference(with_images):
    cfg_r = r_configs.get_smoke("llama_3_2_vision_90b")
    cfg_t = t_configs.get_smoke("llama_3_2_vision_90b")
    tree = _tree(r_attention_init, cfg_r)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, cfg_r.d_model)).astype(np.float32)
    img = rng.standard_normal((2, cfg_r.n_image_tokens, cfg_r.d_model)
                              ).astype(np.float32) if with_images else None
    want, _ = r_attention(tree, cfg_r, jnp.asarray(x),
                          kv_x=None if img is None else jnp.asarray(img),
                          causal=False, rope=False)
    got = cross_attention(_torch(tree), cfg_t, torch.from_numpy(x),
                          kv_x=None if img is None else torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_cases():
    for arch in NEW_ARCHS:
        yield arch
        if arch == "llama_3_2_vision_90b":
            yield arch + "+images"


@pytest.mark.parametrize("case", list(_decode_cases()))
def test_decode_steps_match_reference(case):
    arch, _, images = case.partition("+")
    cfg_r, cfg_t = r_configs.get_smoke(arch), t_configs.get_smoke(arch)
    model_r = r_build(cfg_r)
    params, _ = model_r.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    if cfg_r.family == "vlm":       # open the cross blocks' gates
        tree["blocks"]["b4"]["gate"] = np.full_like(
            tree["blocks"]["b4"]["gate"], 0.7)
    model_t = t_build(cfg_t, device="cpu", params=params_from_jax(tree))
    b, steps = 2, 4
    rng = np.random.default_rng(0)
    kw_r, kw_t = {}, {}
    if images:
        img = rng.standard_normal((b, cfg_r.n_image_tokens, cfg_r.d_model)
                                  ).astype(np.float32)
        kw_r["image_embeds"] = jnp.asarray(img)
        kw_t["image_embeds"] = torch.from_numpy(img)
    tokens = rng.integers(0, cfg_r.vocab, (b, 1)).astype(np.int32)
    cache_r = model_r.init_cache(b, 8)
    cache_t = model_t.init_cache(b, 8)
    assert _paths(cache_t) == _paths(jax.tree.map(np.asarray, cache_r))
    step_r = jax.jit(lambda p, t, c, i: model_r.decode_step(p, t, c, i,
                                                            **kw_r))
    tok_r, tok_t = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    for i in range(steps):
        logits_r, cache_r = step_r(tree, tok_r, cache_r, jnp.int32(i))
        logits_t = model_t.decode_step(tok_t, cache_t, i, **kw_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_r),
                                   err_msg=f"step {i}", **TOL)
        next_r = np.asarray(jnp.argmax(logits_r, -1))
        next_t = torch.argmax(logits_t, -1).numpy()
        assert np.array_equal(next_r, next_t), i
        tok_r = jnp.asarray(next_r[:, None].astype(np.int32))
        tok_t = torch.from_numpy(next_t[:, None]).long()
    for key, blk in cache_t.items():
        for sub, leaves in blk.items():
            for name, t in leaves.items():
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(cache_r[key][sub][name]),
                    err_msg=f"cache {key}.{sub}.{name}", **TOL)


def _dtype_name(v):
    return getattr(v, "__name__", None) or str(v).replace("torch.", "")


def test_configs_match_reference():
    assert t_configs.ARCHS == r_configs.ARCHS
    assert t_configs.all_configs().keys() == set(t_configs.ARCHS)
    for arch in t_configs.ARCHS:
        for full_r, full_t in ((r_configs.get(arch), t_configs.get(arch)),
                               (r_configs.get_smoke(arch),
                                t_configs.get_smoke(arch))):
            for f in dataclasses.fields(full_t):
                if not hasattr(full_r, f.name):
                    # a field of the port's alone (the pattern family's):
                    # every reference config leaves it at its default
                    assert getattr(full_t, f.name) == f.default, \
                        (arch, f.name)
                    continue
                want, got = getattr(full_r, f.name), getattr(full_t, f.name)
                if f.name.endswith("dtype"):
                    want, got = _dtype_name(want), _dtype_name(got)
                assert got == want, (arch, f.name)
            for prop in ("hd", "d_inner", "ssm_heads"):
                assert getattr(full_t, prop) == getattr(full_r, prop)
        cfg = t_configs.get(arch)
        assert t_count(cfg) == r_count(r_configs.get(arch)), arch
        assert t_active(cfg) == r_active(r_configs.get(arch)), arch
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get("no_such_arch")


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_params_from_jax_places_every_leaf(arch):
    cfg = r_configs.get_smoke(arch)
    params, _ = r_build(cfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    out = params_from_jax(tree)
    assert sum(t.numel() for t in out.values()) == sum(
        a.size for a in jax.tree.leaves(tree))
    model = t_build(t_configs.get_smoke(arch), device="cpu", params=out)
    assert set(model.state_dict()) == set(out)
    for name, t in model.state_dict().items():
        assert torch.equal(t, out[name]), name
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(bad)
    short = dict(out)
    short.pop(next(iter(k for k in out if k.startswith("blocks.1."))))
    with pytest.raises(ValueError, match="layout"):
        t_build(t_configs.get_smoke(arch), device="cpu", params=short)
