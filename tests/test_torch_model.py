"""Port parity for the model and the serve launcher: the smoke-size
phi4-mini-3.8B config runs in both packages on the same weights (the
reference's init, carried across by `repro_torch.convert.params_from_jax`).

The smoke config computes in float32, so logits agree within
atol = rtol = 1e-4 (different matmul and reduction orders) and the greedy
tokens are equal.  The launcher reports carry the same keys, and the serve
tier's counts and traffic rows are equal, as they depend only on shapes
and on which page groups pack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch import serve as r_serve
from repro.models import build as r_build
from repro.models import smoke_config as r_smoke
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.models import build as t_build
from repro_torch.models import smoke_config as t_smoke

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _reference_params(cfg, seed=0):
    model = r_build(cfg)
    params, _ = model.init(jax.random.key(seed))
    return model, jax.tree.map(np.asarray, params)


def test_config_matches_reference():
    full_r = r_configs.get("phi4_mini_3_8b")
    full_t = t_configs.get("phi4_mini_3_8b")
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab", "mlp_act", "rope_theta", "qk_norm"):
        assert getattr(full_r, name) == getattr(full_t, name), name
    smoke_r, smoke_t = r_smoke(full_r), t_smoke(full_t)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab", "attn_k_chunk"):
        assert getattr(smoke_r, name) == getattr(smoke_t, name), name


def test_decode_steps_match_reference():
    cfg_r = r_smoke(r_configs.get("phi4_mini_3_8b"))
    cfg_t = t_smoke(t_configs.get("phi4_mini_3_8b"))
    model_r, tree = _reference_params(cfg_r)
    model_t = t_build(cfg_t, device="cpu", params=params_from_jax(tree))
    b, steps = 2, 6
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_r.vocab, (b, 1)).astype(np.int32)
    cache_r = model_r.init_cache(b, 16)
    cache_t = model_t.init_cache(b, 16)
    tok_r, tok_t = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    for i in range(steps):
        logits_r, cache_r = model_r.decode_step(tree, tok_r, cache_r,
                                                jnp.int32(i))
        logits_t = model_t.decode_step(tok_t, cache_t, i)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_r),
                                   err_msg=f"step {i}", **TOL)
        next_r = np.asarray(jnp.argmax(logits_r, -1))
        next_t = torch.argmax(logits_t, -1).numpy()
        assert np.array_equal(next_r, next_t), i
        tok_r = jnp.asarray(next_r[:, None].astype(np.int32))
        tok_t = torch.from_numpy(next_t[:, None]).long()
    np.testing.assert_allclose(
        cache_t["b0"]["attn"]["k"].numpy(),
        np.asarray(cache_r["b0"]["attn"]["k"]), **TOL)


@pytest.mark.parametrize("extra", [
    [], ["--slots", "1", "--admit-rate", "2", "--kv-policy", "auto"]],
    ids=["one-lane-per-sequence", "spill-churn-auto"])
def test_launcher_report_matches_reference(capsys, extra):
    argv = ["--batch", "2", "--prompt-len", "12", "--gen", "6"] + extra
    ref = r_serve.main(argv)
    cfg = r_smoke(r_configs.get("phi4_mini_3_8b"))
    _, tree = _reference_params(cfg, seed=0)
    got = t_serve.main(argv + ["--device", "cpu"],
                       params=params_from_jax(tree))
    capsys.readouterr()
    assert got.keys() == ref.keys()
    assert got["serve_tier"].keys() == ref["serve_tier"].keys()
    st_r, st_t = ref["serve_tier"], got["serve_tier"]
    assert st_t["admitted"] == st_t["retired"] == 2
    for key, want in st_r.items():
        assert st_t[key] == want, key
    if extra:
        assert st_t["evicted"] > 0 and st_t["woken"] > 0
        assert st_t["policy_choice"]["hot"]["basis"] == "probe"
    assert got["traffic"] == ref["traffic"]
    assert got["sample"] == ref["sample"]
    assert got["tokens_per_s"] > 0 and got["prefill_tokens_per_s"] > 0
