"""Port parity for whisper-base, the encoder-decoder family, at smoke size
(2 + 2 layers, d 128, float32): the reference's initial weights drawn
without JAX, the encoder, the teacher-forced decoder, the loss and every
gradient, with and without remat, the cross K/V prefill and 4 decode
steps, the parameter count, the weight conversion both ways, and both
launchers' reports against the reference's (`--arch whisper_base`).

The same numpy-seeded inputs and the reference's weights (carried across
by `repro_torch.convert.params_from_jax`) go through both packages; the
reference runs under `jax.jit` on the CPU.  Values agree within rtol =
1e-4 / atol = 1e-5 (different matmul and reduction orders).  The initial
weights are drawn by `models/threefry.py`, which equals JAX's draws bit
for bit for most values and within 3 ulps elsewhere (its float32 erfinv
rounds `log1p` differently from XLA's)."""

import json

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.checkpoint.ckpt import read_manifest
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import build as t_build
from repro_torch.models import count_params as t_count
from repro_torch.models import whisper as t_wh
from repro_torch.models.layers import layer_norm, sinusoidal_positions
from repro_torch.optim import adamw as t_adamw

try:        # the reference; absent where only the `cuda` test runs
    import jax
    import jax.numpy as jnp

    from repro import configs as r_configs
    from repro.launch import serve as r_serve
    from repro.launch import train as r_train
    from repro.models import build as r_build
    from repro.models import count_params as r_count
    from repro.models import layers as r_layers
    from repro.models import whisper as r_wh
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(1)

ARCH = "whisper_base"
TOL = dict(rtol=1e-4, atol=1e-5)
B, S_DEC, S_ENC = 2, 16, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(*, remat=False, seed=0):
    """(reference model, its params as numpy, port model on the same
    weights) at smoke size."""
    cfg_r = r_configs.get_smoke(ARCH).replace(remat=remat)
    cfg_t = t_configs.get_smoke(ARCH).replace(remat=remat)
    model_r = r_build(cfg_r)
    params = _np(model_r.init(jax.random.key(seed))[0])
    model_t = t_build(cfg_t, device="cpu", params=params_from_jax(params))
    return model_r, params, model_t


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S_DEC)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S_DEC)).astype(np.int32),
            "frames": rng.standard_normal(
                (B, S_ENC, cfg.d_model)).astype(np.float32)}


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **TOL)


def test_layer_norm_and_sinusoidal_positions_match_reference():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 48), (48,), (48,)))
    _close(layer_norm(*map(torch.from_numpy, (x, w, b))),
           r_layers.layer_norm(x, w, b))
    # one ulp of float32 exp in a frequency moves sin(pos * div) by up to
    # pos * 6e-8 at position pos (447: 3e-5)
    for seq, dim in ((7, 48), (448, 512)):
        got = sinusoidal_positions(seq, dim).numpy()
        want = np.asarray(r_layers.sinusoidal_positions(seq, dim))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_init_whisper_equals_reference():
    tree = _np(r_build(r_configs.get_smoke(ARCH)).init(jax.random.key(3))[0])
    want = params_from_jax(tree)
    got = t_wh.init_whisper(t_configs.get_smoke(ARCH), 3, "cpu")
    assert got.keys() == want.keys()
    bits = same = 0
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        ulps = (got[k].view(torch.int32).long()
                - want[k].view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 3, k
        bits += ulps.numel()
        same += int((ulps == 0).sum())
    assert same / bits > 0.95, same / bits
    # the layer norms and every 1-d leaf are exact
    for k in want:
        if k.endswith((".w", ".b")):
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("remat", [False, True])
def test_encode_decode_loss_and_grads_match_reference(remat):
    model_r, params, model_t = _pair(remat=remat)
    cfg = model_r.config
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc_r = jax.jit(lambda p, f: r_wh.encode(p, cfg, f))(params, jb["frames"])
    h_r = jax.jit(lambda p, t, e: r_wh.decode_train(p, cfg, t, e))(
        params, jb["tokens"], enc_r)
    loss_r, grads_r = jax.jit(jax.value_and_grad(model_r.loss))(params, jb)
    with torch.no_grad():
        enc_t = t_wh.encode(model_t, torch.from_numpy(batch["frames"]))
        h_t = t_wh.decode_train(model_t,
                                torch.from_numpy(batch["tokens"]).long(),
                                enc_t)
    _close(enc_t, enc_r, "encode")
    _close(h_t, h_r, "decode_train")
    loss_t = t_wh.whisper_loss(model_t, batch)
    loss_t.backward()
    _close(loss_t, loss_r, "loss")
    want = params_from_jax(_np(grads_r))
    got = {k: p.grad for k, p in model_t.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], k)


def test_prefill_cross_and_decode_steps_match_reference():
    model_r, params, model_t = _pair()
    cfg = model_r.config
    batch = _batch(cfg, seed=2)
    enc_r = r_wh.encode(params, cfg, jnp.asarray(batch["frames"]))
    cache_r = r_wh.whisper_prefill_cross(
        params, cfg, enc_r, model_r.init_cache(B, 8, enc_len=S_ENC))
    enc_t = model_t.encode(torch.from_numpy(batch["frames"]))
    cache_t = t_wh.whisper_prefill_cross(
        model_t, enc_t, model_t.init_cache(B, 8, enc_len=S_ENC))
    for k in cache_r:
        _close(cache_t[k], cache_r[k], f"prefill {k}")
    step_r = jax.jit(lambda p, t, c, i: r_wh.whisper_decode_step(
        p, cfg, t, c, i))
    tok_r = jnp.asarray(batch["tokens"][:, :1])
    tok_t = torch.from_numpy(batch["tokens"][:, :1]).long()
    for i in range(4):
        logits_r, cache_r = step_r(params, tok_r, cache_r, jnp.int32(i))
        logits_t = t_wh.whisper_decode_step(model_t, tok_t, cache_t, i)
        _close(logits_t, logits_r, f"step {i}")
        nxt = np.asarray(jnp.argmax(logits_r, -1))
        assert np.array_equal(torch.argmax(logits_t, -1).numpy(), nxt), i
        tok_r = jnp.asarray(nxt[:, None].astype(np.int32))
        tok_t = torch.from_numpy(nxt[:, None].copy()).long()
    for k in cache_r:
        _close(cache_t[k], cache_r[k], f"cache {k}")


def test_config_count_and_conversion_match_reference():
    full_r, full_t = r_configs.get(ARCH), t_configs.get(ARCH)
    assert (full_t.enc_layers, full_t.dec_layers) == (6, 6)
    assert t_count(full_t) == r_count(full_r) == 70_595_072
    smoke = t_configs.get_smoke(ARCH)
    assert (smoke.enc_layers, smoke.dec_layers, smoke.n_layers) == (2, 2, 2)
    assert t_count(smoke) == r_count(r_configs.get_smoke(ARCH))
    tree = _np(r_build(r_configs.get_smoke(ARCH)).init(jax.random.key(0))[0])
    out = params_from_jax(tree)
    assert sum(t.numel() for t in out.values()) == sum(
        a.size for a in jax.tree.leaves(tree))
    back = params_to_jax(out, 1)
    assert jax.tree.structure(_np(back)) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(_np(back)), jax.tree.leaves(tree),
                         strict=True):
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(dict(tree, extra=np.zeros(3, np.float32)))
    short = dict(out)
    short.pop("dec.blocks.1.cross.wq")
    with pytest.raises(ValueError, match="layout"):
        t_build(smoke, device="cpu", params=short)
    with pytest.raises(ValueError, match="dec layer 1"):
        params_to_jax(short, 1)


def test_serve_launcher_report_matches_reference(capsys):
    argv = ["--arch", ARCH, "--batch", "2", "--prompt-len", "12", "--gen",
            "6"]
    ref = r_serve.main(argv)
    params = _np(r_build(r_configs.get_smoke(ARCH)).init(
        jax.random.key(0))[0])
    got = t_serve.main(argv + ["--device", "cpu"],
                       params=params_from_jax(params))
    capsys.readouterr()
    assert got.keys() == ref.keys()
    assert got["sample"] == ref["sample"]
    assert got["serve_tier"] is None and ref["serve_tier"] is None
    assert got["traffic"] == ref["traffic"] == {}
    assert got["tokens_per_s"] > 0 and got["prefill_tokens_per_s"] > 0


def test_train_launcher_losses_match_reference(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "32", "--ckpt-every", "3", "--inject-fault", "4",
            "--seed", "3"]
    ref = r_train.main(argv + ["--ckpt-dir", str(tmp_path / "r"),
                               "--json-out", str(tmp_path / "r.json")])
    ours = t_train.main(argv + ["--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "t"),
                                "--json-out", str(tmp_path / "t.json")])
    capsys.readouterr()
    assert ours.keys() == ref.keys()
    assert ours["steps"] == ref["steps"] == 6
    assert ours["restarts"] == ref["restarts"] == 1
    losses_r = json.loads((tmp_path / "r.json").read_text())["losses"]
    losses_t = json.loads((tmp_path / "t.json").read_text())["losses"]
    # the port keeps one loss a step; the reference keeps the steps from
    # where its restart began (step 0, or 3 if its save of step 3 was
    # committed before it looked)
    assert len(losses_t) == 6 and len(losses_r) in (3, 6)
    np.testing.assert_allclose(losses_t[-len(losses_r):], losses_r,
                               rtol=0, atol=1e-4)
    # the restart restored the port's whisper tree from its checkpoint,
    # whose leaves are the reference's tree
    leaves = {x["key"] for x in read_manifest(tmp_path / "t", 3)["leaves"]}
    assert ".params/dec/blocks/cross/wq" in leaves
    assert ".m/pos_dec" in leaves


def test_whisper_defaults_to_the_card():
    cfg = t_configs.get_smoke(ARCH)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_wh.init_whisper(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--arch", ARCH, "--batch", "1", "--prompt-len", "2",
                      "--gen", "1"])


@pytest.mark.cuda
def test_whisper_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t_configs.get_smoke(ARCH)
    params = t_wh.init_whisper(cfg, 1, "cpu")
    batch = _batch(cfg)
    out = []
    for dev in ("cpu", "cuda"):
        model = t_build(cfg, device=dev,
                        params={k: v.clone() for k, v in params.items()})
        state = t_adamw.adamw_init(model)
        state, m = t_adamw.make_train_step(model, lr_peak=1e-2)(state, batch)
        enc = model.encode(torch.from_numpy(batch["frames"]).to(dev))
        cache = model.prefill_cross(enc, model.init_cache(B, 4,
                                                          enc_len=S_ENC))
        tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        logits = [model.decode_step(tok, cache, i).cpu() for i in range(4)]
        out.append((float(m["loss"]), torch.stack(logits)))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-4, abs=1e-4)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4, atol=1e-4)
