"""Port parity for the training path: the decoder families' forward and
loss with every parameter's gradient, remat, the chunked cross-entropy,
the chunked SSD forward, AdamW, the cosine schedule, the train step with
microbatches, the prefill step and a decode after training.  The same
numpy-seeded inputs and the reference's weights (carried across by
`repro_torch.convert.params_from_jax`) go through both packages; the
reference runs under `jax.jit` / `jax.value_and_grad` on the CPU.  The
`cuda` tests (one train step of each family on the card against the CPU,
an async save during the next step against a blocking save) need no JAX.

Smoke configs compute in float32, so losses and gradients agree within
rtol = 1e-4 / atol = 1e-5 (different matmul and reduction orders);
optimizer arithmetic on identical gradients within 1e-6."""

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_prefill_step
from repro_torch.launch.train import PRESETS as T_PRESETS
from repro_torch.models import build as t_build
from repro_torch.models.layers import chunked_softmax_xent
from repro_torch.models.ssm import ssm_apply, ssm_decode_step, ssm_init_cache
from repro_torch.optim import adamw as t_adamw

try:        # the reference; absent where only the `cuda` tests run
    import jax
    import jax.numpy as jnp

    from repro import configs as r_configs
    from repro.launch.steps import make_prefill_step as r_prefill_step
    from repro.launch.train import PRESETS as R_PRESETS
    from repro.models import build as r_build
    from repro.models.common import Initializer as RInit
    from repro.models.common import split_tree
    from repro.models.layers import chunked_softmax_xent as r_xent
    from repro.models.ssm import ssm_apply as r_ssm_apply
    from repro.models.ssm import ssm_init as r_ssm_init
    from repro.optim import adamw as r_adamw
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# one arch of each decoder family
FAMILIES = {"dense": "phi4_mini_3_8b", "moe": "olmoe_1b_7b",
            "ssm": "mamba2_130m", "hybrid": "zamba2_2_7b",
            "vlm": "llama_3_2_vision_90b"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch=None, *, cfg_r=None, cfg_t=None, seed=0, open_gates=False):
    """(reference model, its params as numpy, port model on the same
    weights).  `open_gates` sets the vlm's cross gates to 0.7 in both, so
    the cross blocks' attention reaches the loss."""
    cfg_r = cfg_r or r_configs.get_smoke(arch)
    cfg_t = cfg_t or t_configs.get_smoke(arch)
    model_r = r_build(cfg_r)
    params = _np(model_r.init(jax.random.key(seed))[0])
    if open_gates:
        for blk in params["blocks"].values():
            if "gate" in blk:
                blk["gate"] = np.full_like(blk["gate"], 0.7)
    model_t = t_build(cfg_t, device="cpu", params=params_from_jax(params))
    return model_r, params, model_t


def _batch(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _grads_t(model):
    return {k: p.grad for k, p in model.named_parameters()}


def _assert_tree_close(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **tol)


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(family):
    model_r, params, model_t = _pair(FAMILIES[family], open_gates=True)
    batch = _batch(model_r.config, 2, 64)
    loss_r, grads_r = jax.jit(jax.value_and_grad(model_r.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t = model_t.loss(batch)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_r),
                               **GRAD_TOL)
    _assert_tree_close(_grads_t(model_t), params_from_jax(_np(grads_r)),
                       **GRAD_TOL)
    if family == "moe":     # the router's aux loss enters the loss
        h, aux = model_t.hidden(torch.from_numpy(batch["tokens"]).long())
        assert float(aux.detach()) > 0


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_matches_no_remat(family):
    arch = FAMILIES[family]
    cfg = t_configs.get_smoke(arch)
    params = t_build(cfg, device="cpu", seed=3).state_dict()
    batch = _batch(cfg, 2, 64)
    out = []
    for remat in (False, True):
        model = t_build(cfg.replace(remat=remat), device="cpu",
                        params={k: v.clone() for k, v in params.items()})
        loss = model.loss(batch)
        loss.backward()
        out.append((loss.detach(), _grads_t(model)))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=0, atol=0,
                                   msg=k)


def test_bf16_cross_attention_promotes_float32_image_embeds():
    """Under a bf16 config the reference multiplies float32 image
    embeddings by bf16 weights, which JAX promotes to float32: K/V in
    float32, the output back in bf16.  Compared in bf16 (1e-2)."""
    from repro.models.attention import attention_apply as r_attention
    from repro.models.attention import attention_init as r_attention_init
    from repro_torch.models.attention import cross_attention

    cfg_r = r_configs.get_smoke("llama_3_2_vision_90b").replace(
        dtype=jnp.bfloat16)
    cfg_t = t_configs.get_smoke("llama_3_2_vision_90b").replace(
        dtype=torch.bfloat16)
    tree = _np(split_tree(r_attention_init(RInit(jax.random.key(4)),
                                           cfg_r))[0])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, cfg_r.d_model)).astype(np.float32)
    img = rng.standard_normal((2, cfg_r.n_image_tokens, cfg_r.d_model)
                              ).astype(np.float32)
    w_r = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in tree.items()}
    want, _ = r_attention(w_r, cfg_r, jnp.asarray(x, jnp.bfloat16),
                          kv_x=jnp.asarray(img), causal=False, rope=False)
    w_t = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
           for k, v in tree.items()}
    got = cross_attention(w_t, cfg_t, torch.from_numpy(x).to(torch.bfloat16),
                          kv_x=torch.from_numpy(img))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_chunked_xent_remainder_and_mask():
    rng = np.random.default_rng(4)
    b, s, d, v = 2, 45, 16, 37
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    emb = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)

    def ref(h, e):
        return r_xent(h, e, jnp.asarray(labels), chunk=16,
                      label_mask=jnp.asarray(mask))

    loss_r, (gh_r, ge_r) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    loss_t = chunked_softmax_xent(ht, et, torch.from_numpy(labels), chunk=16,
                                  label_mask=torch.from_numpy(mask))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_r),
                               **GRAD_TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_r), **GRAD_TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge_r), **GRAD_TOL)


def test_ssm_apply_matches_reference_and_decode_steps():
    cfg_r = r_configs.get_smoke("zamba2_2_7b")
    cfg_t = t_configs.get_smoke("zamba2_2_7b")
    p_np = _np(split_tree(r_ssm_init(RInit(jax.random.key(2)), cfg_r))[0])
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_np.items()}
    s = 2 * cfg_t.ssm_chunk
    x = np.random.default_rng(5).standard_normal(
        (2, s, cfg_t.d_model)).astype(np.float32)
    y_r = np.asarray(r_ssm_apply(p_np, cfg_r, jnp.asarray(x)))
    y_t = ssm_apply(p_t, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), y_r, rtol=1e-4, atol=1e-4)
    cache = ssm_init_cache(cfg_t, 2, "cpu")
    steps = torch.cat([ssm_decode_step(p_t, cfg_t,
                                       torch.from_numpy(x[:, i:i + 1]),
                                       cache) for i in range(s)], dim=1)
    np.testing.assert_allclose(steps.numpy(), y_t.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    rng = np.random.default_rng(6)
    shapes = {"a": (33, 17), "b": (5,), "c": (4, 3, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    st_r = r_adamw.adamw_init({k: jnp.asarray(v) for k, v in params.items()},
                              getattr(jnp, moment_dtype))
    st_t = t_adamw.adamw_init({k: torch.from_numpy(v.copy())
                               for k, v in params.items()},
                              getattr(torch, moment_dtype))
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        st_r = r_adamw.adamw_update(
            st_r, {k: jnp.asarray(v) for k, v in g.items()},
            lr=jnp.float32(lr))
        st_t = t_adamw.adamw_update(
            st_t, {k: torch.from_numpy(v) for k, v in g.items()},
            lr=torch.tensor(lr, dtype=torch.float32))
    assert int(st_t.step) == int(st_r.step) == 3
    for k in shapes:
        np.testing.assert_allclose(st_t.params[k].numpy(),
                                   np.asarray(st_r.params[k]), rtol=1e-6,
                                   atol=1e-6)
        for f in ("m", "v"):
            got = getattr(st_t, f)[k]
            assert got.dtype == getattr(torch, moment_dtype)
            want = np.asarray(getattr(st_r, f)[k]).astype(np.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                       atol=1e-6)


def test_cosine_lr_and_global_norm():
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 12000):
        want = float(r_adamw.cosine_lr(jnp.int32(step)))
        got = float(t_adamw.cosine_lr(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    rng = np.random.default_rng(7)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("a", (40, 3)), ("b", (7,)), ("c", ()))}
    want = float(r_adamw.global_norm({k: jnp.asarray(v)
                                      for k, v in tree.items()}))
    got = float(t_adamw.global_norm({k: torch.from_numpy(v)
                                     for k, v in tree.items()}))
    assert got == pytest.approx(want, rel=1e-6)


def _lm2m_pair(seed=0):
    return _pair(cfg_r=R_PRESETS["lm2m"], cfg_t=T_PRESETS["lm2m"], seed=seed)


def _train_both(steps, batch, *, microbatches=None, seed=0):
    """`steps` train steps of lm2m in both packages on one batch; returns
    (reference metrics, port metrics, reference state, port model)."""
    model_r, params, model_t = _lm2m_pair(seed)
    step_r = jax.jit(r_adamw.make_train_step(
        model_r, lr_peak=1e-2, microbatches=microbatches))
    step_t = t_adamw.make_train_step(model_t, lr_peak=1e-2,
                                     microbatches=microbatches)
    st_r = r_adamw.adamw_init(jax.tree.map(jnp.asarray, params))
    st_t = t_adamw.adamw_init(model_t)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    m_r, m_t = [], []
    for _ in range(steps):
        st_r, mr = step_r(st_r, jb)
        st_t, mt = step_t(st_t, batch)
        m_r.append({k: float(v) for k, v in mr.items()})
        m_t.append({k: float(v) for k, v in mt.items()})
    return m_r, m_t, st_r, model_t


def test_train_steps_match_reference():
    batch = _batch(T_PRESETS["lm2m"], 4, 32)
    m_r, m_t, st_r, model_t = _train_both(5, batch)
    for r, t in zip(m_r, m_t):
        for k in ("loss", "gnorm", "lr"):
            assert t[k] == pytest.approx(r[k], rel=1e-4, abs=1e-4), k
    assert m_t[-1]["loss"] < m_t[0]["loss"]
    _assert_tree_close(dict(model_t.state_dict()),
                       params_from_jax(_np(st_r.params)), rtol=1e-4,
                       atol=1e-5)


def test_microbatches_match_one_batch_and_reference():
    batch = _batch(T_PRESETS["lm2m"], 4, 32)
    m_r4, m_t4, _, _ = _train_both(1, batch, microbatches=4)
    _, m_t1, _, _ = _train_both(1, batch, microbatches=1)
    for k in ("loss", "gnorm"):
        assert m_t4[0][k] == pytest.approx(m_r4[0][k], rel=1e-4), k
    assert abs(m_t1[0]["loss"] - m_t4[0]["loss"]) < 1e-3
    assert m_t4[0]["gnorm"] == pytest.approx(m_t1[0]["gnorm"], rel=1e-2)


def test_prefill_step_matches_reference():
    model_r, params, model_t = _pair("olmoe_1b_7b")
    batch = _batch(model_r.config, 2, 32)
    del batch["labels"]
    want = np.asarray(jax.jit(r_prefill_step(model_r))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = make_prefill_step(model_t)(batch)
    assert got.shape == (2, model_t.config.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_decode_after_training_matches_reference():
    batch = _batch(T_PRESETS["lm2m"], 2, 32)
    _, _, st_r, model_t = _train_both(2, batch)
    model_r = r_build(R_PRESETS["lm2m"])
    tok = np.array([[3], [17]], np.int32)
    cache_r = model_r.init_cache(2, 4)
    cache_t = model_t.init_cache(2, 4)
    for i in range(3):
        logits_r, cache_r = jax.jit(model_r.decode_step)(
            st_r.params, jnp.asarray(tok), cache_r, jnp.int32(i))
        logits_t = model_t.decode_step(torch.from_numpy(tok).long(),
                                       cache_t, i)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_r),
                                   rtol=1e-4, atol=1e-4)
        tok = np.asarray(jnp.argmax(logits_r, -1))[:, None].astype(np.int32)


def test_decode_weights_follow_the_parameters():
    """The decode step's compute-dtype copy of the weights is cast again
    after train steps update the parameters in place, and a forward
    under autograd drops it."""
    cfg = t_configs.get_smoke("phi4_mini_3_8b").replace(
        dtype=torch.bfloat16)
    model = t_build(cfg, device="cpu", seed=0)
    tok = torch.tensor([[1], [2]])
    before = model.decode_step(tok, model.init_cache(2, 2), 0)
    state = t_adamw.adamw_init(model)
    step = t_adamw.make_train_step(model, lr_peak=1.0)
    for _ in range(2):        # the schedule's first step has lr 0
        state, _ = step(state, _batch(cfg, 2, 16))
    assert model._decode is None
    after = model.decode_step(tok, model.init_cache(2, 2), 0)
    fresh = t_build(cfg, device="cpu", params=model.state_dict())
    assert torch.equal(after, fresh.decode_step(tok, fresh.init_cache(2, 2),
                                                0))
    assert not torch.equal(before, after)
    with torch.no_grad():
        model.blocks[0].mlp.w2.mul_(3.0)
    assert not torch.equal(after, model.decode_step(
        tok, model.init_cache(2, 2), 0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_on_card_matches_cpu(card, family):
    cfg = t_configs.get_smoke(FAMILIES[family])
    params = t_build(cfg, device="cpu", seed=1).state_dict()
    batch = _batch(cfg, 2, 64)
    out = []
    for dev in ("cpu", card):
        model = t_build(cfg, device=dev,
                        params={k: v.clone() for k, v in params.items()})
        state = t_adamw.adamw_init(model)
        state, m = t_adamw.make_train_step(model, lr_peak=1e-2)(state, batch)
        out.append((float(m["loss"]), {k: p.detach().cpu()
                                       for k, p in model.named_parameters()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-4, abs=1e-4)
    for k, p in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], p, rtol=1e-4, atol=1e-4,
                                   msg=k)


@pytest.mark.cuda
def test_async_save_during_next_step_equals_blocking_save(card, tmp_path):
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint

    cfg = T_PRESETS["lm2m"]
    model = t_build(cfg, device=card, seed=0)
    state = t_adamw.adamw_init(model)
    step = t_adamw.make_train_step(model, lr_peak=1e-2)
    batch = _batch(cfg, 4, 32)
    state, _ = step(state, batch)
    save_checkpoint(tmp_path / "blocking", 1, state, codec="cram")
    mgr = CheckpointManager(tmp_path / "async", codec="cram")
    mgr.save_async(1, state)
    state, _ = step(state, batch)          # updates the tensors in place
    mgr.wait()
    a = sorted((tmp_path / "blocking" / "step_00000001").iterdir())
    b = sorted((tmp_path / "async" / "step_00000001").iterdir())
    assert [p.name for p in a] == [p.name for p in b]
    for pa, pb in zip(a, b):
        assert pa.read_bytes() == pb.read_bytes(), pa.name
