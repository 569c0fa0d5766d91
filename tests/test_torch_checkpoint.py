"""Port parity for the CRAM checkpoints: the line-codec stream, the
on-disk format (leaf files and manifest bytes equal to the reference's
for the same training state, and each package restoring the other's),
the AutoTuner's per-leaf codec choices, retention, the manifest's
MessagePack encoding, and the ledger's merge and checkpoint rows."""

import hashlib

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.bandwidth import Ledger as RLedger
from repro.bandwidth import adapters as r_adapters
from repro.checkpoint import codec as r_codec
from repro.checkpoint.ckpt import load_checkpoint as r_load
from repro.checkpoint.ckpt import save_checkpoint as r_save
from repro.models import build as r_build
from repro.optim import adamw as r_adamw
from repro_torch import configs as t_configs
from repro_torch.bandwidth import Ledger
from repro_torch.bandwidth import adapters as t_adapters
from repro_torch.checkpoint import codec as t_codec
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         load_checkpoint, read_manifest,
                                         save_checkpoint)
from repro_torch.checkpoint.manifest import packb, unpackb
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import build as t_build
from repro_torch.optim import adamw as t_adamw

torch.set_num_threads(1)

CODECS = ("bdi", "fpc", "hybrid", "raw")


def _stream(seed=0) -> bytes:
    """Lines of every kind a checkpoint holds: zeros, small integers,
    float32 noise, repeated values, a bf16-like pattern, a ragged tail."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(256, np.float32).tobytes(),
             rng.integers(-3, 4, 512).astype(np.int32).tobytes(),
             rng.standard_normal(300).astype(np.float32).tobytes(),
             np.full(64, 7, np.int64).tobytes(),
             (rng.standard_normal(200).astype(np.float32).view(np.uint32)
              & 0xFFFF0000).tobytes(),
             b"tail-bytes"]
    return b"".join(parts)


@pytest.mark.parametrize("codec", CODECS)
def test_codec_stream_equals_reference_and_round_trips(codec):
    raw = _stream()
    blob = t_codec.cram_compress_bytes(raw, codec=codec)
    assert blob == r_codec.cram_compress_bytes(raw, codec=codec)
    assert t_codec.cram_decompress_bytes(blob) == raw
    assert r_codec.cram_decompress_bytes(blob) == raw
    z = t_codec.cram_compress_bytes(raw, use_zstd=True, codec=codec)
    assert t_codec.cram_decompress_bytes(z) == raw
    assert r_codec.cram_decompress_bytes(z) == raw
    with pytest.raises(ValueError, match="unknown checkpoint codec"):
        t_codec.cram_compress_bytes(raw, codec="nope")


def _states(arch, seed=0):
    """A reference TrainState of the smoke config (zamba2 cut to two
    super-blocks of two ssm layers) with random moments, some of them
    exact zeros, at step 3, and the port's TrainState holding the same
    tensors."""
    cfg_r, cfg_t = r_configs.get_smoke(arch), t_configs.get_smoke(arch)
    if cfg_r.family == "hybrid":
        cfg_r = cfg_r.replace(n_layers=4, attn_every=2)
        cfg_t = cfg_t.replace(n_layers=4, attn_every=2)
    params = jax.tree.map(np.asarray,
                          r_build(cfg_r).init(jax.random.key(seed))[0])
    rng = np.random.default_rng(seed)

    def moment(p, sq):
        x = (rng.standard_normal(p.shape) * 1e-3).astype(np.float32)
        x[rng.random(p.shape) < 0.5] = 0.0
        return x * x if sq else x

    st_r = r_adamw.TrainState(
        params=params, m=jax.tree.map(lambda p: moment(p, False), params),
        v=jax.tree.map(lambda p: moment(p, True), params),
        step=np.int32(3), dyn_counter=np.int32(2048 + 128))
    model_t = t_build(cfg_t, device="cpu", params=params_from_jax(params))
    st_t = t_adamw.adamw_init(model_t)
    st_t.m = params_from_jax(st_r.m)
    st_t.v = params_from_jax(st_r.v)
    st_t.step = torch.tensor(3, dtype=torch.int32)
    return st_r, st_t


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("arch,codec", [
    ("llama4_maverick_400b_a17b", "cram"), ("zamba2_2_7b", "cram:hybrid"),
    ("phi4_mini_3_8b", "auto"), ("zamba2_2_7b", "raw")])
def test_saved_files_equal_the_reference(tmp_path, arch, codec):
    st_r, st_t = _states(arch)
    r_save(tmp_path / "r", 1, st_r, codec=codec)
    save_checkpoint(tmp_path / "t", 1, st_t, codec=codec)
    got, want = (_files(tmp_path / p / "step_00000001") for p in "tr")
    assert got.keys() == want.keys()
    for name in want:
        assert hashlib.sha1(got[name]).hexdigest() == \
            hashlib.sha1(want[name]).hexdigest(), name
    man = read_manifest(tmp_path / "t", 1)
    assert man == msgpack.unpackb(want["manifest.msgpack"])
    keys = [m["key"] for m in man["leaves"]]
    assert ".params/blocks/b0/ln1" in keys and ".step" in keys
    if codec == "auto":       # the AutoTuner's choices, leaf by leaf
        assert {m["codec"] for m in man["leaves"]} - {"raw"}


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_2_7b"])
def test_each_package_restores_the_others_checkpoint(tmp_path, arch):
    st_r, st_t = _states(arch)
    save_checkpoint(tmp_path / "t", 3, st_t, codec="cram")
    r_save(tmp_path / "r", 3, st_r, codec="raw")
    back_r, _ = r_load(tmp_path / "t", 3, st_r)
    for a, b in zip(jax.tree.leaves(back_r), jax.tree.leaves(st_r),
                    strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back_t, man = load_checkpoint(tmp_path / "r", 3, st_t)
    assert man["codec"] == "raw"
    for f in ("params", "m", "v"):
        want, got = getattr(st_t, f), getattr(back_t, f)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k].detach()), (f, k)
    assert int(back_t.step) == int(st_t.step) == 3
    assert int(back_t.dyn_counter) == 2048 + 128


def test_params_to_jax_inverts_params_from_jax():
    cfg = r_configs.get_smoke("llama4_maverick_400b_a17b")
    tree = jax.tree.map(np.asarray, r_build(cfg).init(jax.random.key(1))[0])
    ours = params_from_jax(tree)
    back = params_to_jax(ours, per=2)
    flat_r = jax.tree_util.tree_leaves_with_path(tree)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back))
    assert [p for p, _ in flat_r] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_r, flat_t):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="super-blocks"):
        params_to_jax(ours, per=3)


def test_dict_tree_round_trip_and_auto_choices(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"weights": rng.standard_normal(4096).astype(np.float32),
            "opt/moments": np.zeros(8192, np.float32),
            "misc": rng.integers(0, 256, 512, dtype=np.uint8),
            "nested": {"h": np.zeros((64, 64), np.float16),
                       "step": np.int32(7)}}
    led_r, led_t = RLedger("train"), Ledger("train")
    r_save(tmp_path / "r", 2, tree, codec="auto", ledger=led_r)
    save_checkpoint(tmp_path / "t", 2, tree, codec="auto", ledger=led_t)
    assert _files(tmp_path / "t" / "step_00000002") == \
        _files(tmp_path / "r" / "step_00000002")
    assert led_t.as_dict() == led_r.as_dict()
    out, man = load_checkpoint(tmp_path / "t", None, tree)
    assert np.array_equal(out["nested"]["h"].numpy(), tree["nested"]["h"])
    assert int(out["nested"]["step"]) == 7
    for m in man["leaves"]:
        assert m["stored_bytes"] <= m["raw_bytes"], m
    bf = {"w": torch.arange(40, dtype=torch.float32).to(torch.bfloat16)}
    save_checkpoint(tmp_path / "bf", 1, bf, codec="cram")
    back, man = load_checkpoint(tmp_path / "bf", 1, bf)
    assert man["leaves"][0]["dtype"] == "bfloat16"
    assert torch.equal(back["w"], bf["w"])


def test_checkpoint_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, codec="raw")
    tree = {"x": torch.ones(8)}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
        tree["x"].add_(1.0)           # the save holds its own copy
        mgr.wait()
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4] and latest_step(tmp_path) == 4
    out, _ = mgr.restore_latest(tree)
    assert torch.equal(out["x"], torch.full((8,), 4.0))
    assert latest_step(tmp_path / "none") is None


def test_manifest_encoding_equals_msgpack():
    values = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
              -2 ** 31, -2 ** 31 - 1, -2 ** 63, True, False, None, 1.5,
              -0.0, 1e300, "", "a" * 31, "a" * 32, "é" * 200,
              "x" * 70000, b"", b"ab" * 200, list(range(15)),
              list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
              {"leaves": [{"key": ".params/x", "shape": [3, 4],
                           "framed": True}], "traffic": {}}]
    for v in values:
        assert packb(v) == msgpack.packb(v), str(v)[:40]
        assert unpackb(packb(v)) == msgpack.unpackb(msgpack.packb(v))
    with pytest.raises(TypeError):
        packb({1.5j: 1})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb("abc")[:-1])


def test_ledger_merge_and_checkpoint_adapters():
    pairs = []
    for Led, ad in ((RLedger, r_adapters), (Ledger, t_adapters)):
        a, b = Led("x"), Led("y")
        for key, raw, stored in ((".params/embed", 4096, 3000),
                                 (".m/adam_mu", 512, 64),
                                 (".params/blocks/b0/ln1/scale", 64, 70),
                                 ("grads/w", 128, 128)):
            got = ad.checkpoint_leaf_event(a, key=key, raw_len=raw,
                                           stored_len=stored)
            assert got == (raw, stored)
        ad.checkpoint_restore_event(b, key=".v/adam_nu", raw_len=256,
                                    stored_len=100)
        b.record("spill", raw=10, compressed=5, consumer="kv")
        a.merge(b)
        pairs.append((a.as_dict(), len(a), a.consumers(),
                      a.tensor_classes(), a.tensor_classes("kv"),
                      a.raw_bytes("write"), a.compressed_bytes(),
                      ad.classify_tensor(".params/blocks/b0/ssm/dt_bias")))
    assert pairs[0] == pairs[1]
    tree = {"a": np.zeros((3, 4), np.float32), "b": {"c": np.zeros(5,
                                                                  np.int8)}}
    ttree = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5,
                                                            dtype=torch.int8)}}
    assert t_adapters.tree_wire_bytes(ttree) == \
        r_adapters.tree_wire_bytes(tree) == 53
    assert t_adapters.int8_wire_bytes(ttree) == \
        r_adapters.int8_wire_bytes(tree) == 25
