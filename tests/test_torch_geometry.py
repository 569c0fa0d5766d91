"""The head geometries the reference computes, and `shard=True` on one
device, on the CPU.

The reference runs its decode kernels (K3 batched, K6 single-sequence) at
head_dim 16 with one KV head (its serving tests), 32 (its kernel sweep and
smoke configs), 80 (zamba2_2_7b) and at GQA groups of 12
(mistral_large_123b).  Here the port's plain versions meet the reference's
Pallas kernels (interpret mode) on the same numpy inputs at those shapes:
attention within atol = rtol = 1e-4 (float32, different summation order),
bytes exact.  The CUDA wrappers' own checks, run with the library replaced
by a recorder (nothing is built or launched), take those shapes and refuse
a head_dim that is not a multiple of 8 from 8 to 128.

`shard_kv_attend(..., shard=True)` on one device runs the single-device
decode, as the reference does: bit-identical to `shard=False` and, within
the attention tolerance, to the reference's `shard=True` on one device.
Over a list of k CPU devices the slot axis is sharded, one decode a shard:
bit-identical to the single-device decode and within the tolerance of the
reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R
from repro.kernels.cram_attention import cram_decode_attention as r_k6
from repro.kv import synthetic_kv_stream
from repro.serving import ServeLoop as RefLoop
from repro.serving.shard import shard_kv_attend as r_shard
from repro_torch.kernels import cram_attention as t_ca
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import ops as T
from repro_torch.serving import ServeLoop
from repro_torch.serving import shard as t_shard

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)

# (page, Hkv, Hq, head_dim): the reference's serving tests, its kernel
# sweep and smoke configs, zamba2_2_7b's head_dim, mistral_large's G = 12
GEOMETRIES = [(8, 1, 1, 16), (4, 1, 4, 32), (4, 2, 4, 80), (4, 2, 24, 32)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _pages(rng, n_pages, page, hkv, hd, kind):
    """(n_pages, page, Hkv, 2*hd) int16 bf16 bits: compressible,
    incompressible or mixed (alternating page pairs)."""
    t = n_pages * page
    kc, vc = synthetic_kv_stream(rng, 1, t, hkv, hd)
    ki, vi = synthetic_kv_stream(rng, 1, t, hkv, hd, compressible=False)
    if kind == "incompressible":
        kc, vc = ki, vi
    elif kind == "mixed":
        for g in range(1, n_pages // 2, 2):
            sl = slice(2 * g * page, 2 * (g + 1) * page)
            kc[:, sl], vc[:, sl] = ki[:, sl], vi[:, sl]
    bits = np.concatenate([np.asarray(jnp.asarray(x[0], jnp.bfloat16)).view(
        np.int16) for x in (kc, vc)], -1)
    return bits.reshape(n_pages, page, hkv, 2 * hd)


def _inputs(rng, lanes, geometry, b=3, n_groups=3):
    """Per-sequence caches from the reference's build (numpy leaves), a
    ragged valid mask with a zero-valid sequence, a predictor with
    mismatches, and q."""
    page, hkv, hq, hd = geometry
    build = R.build_cram_cache if lanes == 2 else R.build_cram_cache_quad
    kinds = ["compressible", "mixed", "incompressible"]
    cs = [build(jnp.asarray(_pages(rng, n_groups * lanes, page, hkv, hd,
                                   kinds[i % 3])), interpret=True)
          for i in range(b)]
    cache = {k: np.stack([np.asarray(c[k]) for c in cs])
             for k in ("slots", "slots_overflow", "strips", "packed_mask")}
    cache["markers"] = np.asarray(cs[0]["markers"])
    n_pages = n_groups * lanes
    tokens = rng.integers(1, n_pages * page, b)
    tokens[1] = 0                                   # a zero-valid sequence
    valid = np.clip(tokens[:, None] - np.arange(n_pages)[None] * page, 0,
                    page).astype(np.int32)
    pred = cache["packed_mask"] ^ (rng.random((b, n_groups)) < 0.4)
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    return q, cache, valid, pred


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_batched_decode_plain_matches_reference_kernel(lanes, geometry):
    """K3's plain version (through `decode_attention_fused`) against the
    reference's `cram_decode_attention_batched` (Pallas, interpret)."""
    rng = np.random.default_rng([lanes, *geometry])
    q, cache, valid, pred = _inputs(rng, lanes, geometry)
    out_r, raw_r, cram_r = R.decode_attention_fused(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(valid), jnp.asarray(pred), lanes=lanes, interpret=True)
    out_t, raw_t, cram_t = T.decode_attention_fused(
        _t(q), {k: _t(v) for k, v in cache.items()}, _t(valid), _t(pred),
        lanes=lanes)
    assert out_t.shape == q.shape and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), **TOL)
    assert np.array_equal(raw_t.numpy(), np.asarray(raw_r))
    assert np.array_equal(cram_t.numpy(), np.asarray(cram_r))


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_single_decode_plain_matches_reference_kernel(lanes, geometry):
    """K6's plain version on each sequence's physical view (the
    zero-valid one included) against the reference's
    `cram_decode_attention` (Pallas, interpret)."""
    rng = np.random.default_rng([lanes, *geometry, 6])
    q, cache, valid, _ = _inputs(rng, lanes, geometry)
    pv = T.physical_view if lanes == 2 else T.physical_view_quad
    for seq in range(q.shape[0]):
        one = {k: _t(v if k == "markers" else v[seq])
               for k, v in cache.items()}
        args = [x.contiguous() for x in pv(one, _t(valid[seq]))]
        got = t_ca.cram_decode_attention(_t(q[seq]), *args, lanes=lanes)
        want = r_k6(jnp.asarray(q[seq]),
                    *(jnp.asarray(a.numpy()) for a in args), lanes=lanes,
                    interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------- the CUDA wrappers' own checks

class _Recorder:
    """Stands in for the bound library: records the head geometry of each
    call and reports success."""

    def __init__(self):
        self.calls = []

    def cram_decode_attention(self, *a):
        self.calls.append(("batched", a[7], a[8], a[11]))   # hq, D, hkv
        return 0

    def cram_decode_attention_single(self, *a):
        self.calls.append(("single", a[5], a[6], a[9]))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "load", lambda: rec)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    before = dict(t_ca.LAUNCHES)
    yield rec
    t_ca.LAUNCHES.update(before)


def _zeros(b, n, page, hkv, hq, hd, lanes):
    return (torch.zeros((b, hq, hd), dtype=torch.float32),
            torch.zeros((b, n, page, hkv, 2 * hd), dtype=torch.int16),
            torch.zeros((b, n, hkv, 2 * hd + 2), dtype=torch.int16),
            torch.zeros((n,), dtype=torch.int32),
            torch.zeros((b, n, lanes), dtype=torch.int32),
            torch.zeros((b, n // lanes), dtype=torch.int32))


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("geometry", GEOMETRIES + [(16, 8, 96, 128),
                                                   (16, 32, 32, 80),
                                                   (16, 8, 24, 128),
                                                   (4, 1, 1, 8)])
def test_cuda_wrappers_take_every_reference_geometry(recorder, lanes,
                                                     geometry):
    page, hkv, hq, hd = geometry
    q, slots, strips, markers, valid, pred = _zeros(2, 2 * lanes, page, hkv,
                                                    hq, hd, lanes)
    t_ca.cram_decode_attention_batched_cuda(q, slots, strips, markers, valid,
                                            pred, lanes=lanes)
    t_ca.cram_decode_attention_cuda(q[0], slots[0], strips[0], markers,
                                    valid[0], lanes=lanes)
    assert recorder.calls == [("batched", hq, hd, hkv),
                              ("single", hq, hd, hkv)]


@pytest.mark.parametrize("hkv,hq,hd,match", [
    (1, 4, 12, "multiple of 8"), (1, 4, 136, "multiple of 8"),
    (2, 4, 4, "multiple of 8"), (3, 4, 32, "whole number of groups")])
def test_cuda_wrappers_refuse_what_the_kernels_cannot_run(recorder, hkv, hq,
                                                          hd, match):
    q, slots, strips, markers, valid, pred = _zeros(2, 4, 4, hkv, hq, hd, 2)
    with pytest.raises(ValueError, match=match):
        t_ca.cram_decode_attention_batched_cuda(q, slots, strips, markers,
                                                valid, pred, lanes=2)
    with pytest.raises(ValueError, match=match):
        t_ca.cram_decode_attention_cuda(q[0], slots[0], strips[0], markers,
                                        valid[0], lanes=2)
    assert recorder.calls == []


# ------------------------------------------------ shard=True on one device

SHARD_PAGE, SHARD_HKV, SHARD_HD, SHARD_HQ = 8, 1, 16, 2


def _serve_loops(packing, slots):
    """The reference's and the port's ServeLoop on the same prompts, at the
    reference's serving-test geometry."""
    kw = dict(slots=slots, max_pages=4, page=SHARD_PAGE, n_kv=SHARD_HKV,
              head_dim=SHARD_HD, policy="static", packing=packing)
    ref = RefLoop(interpret=True, async_spill=False, **kw)
    port = ServeLoop(device="cpu", **kw)
    rng = np.random.default_rng([slots, len(packing)])
    for sid in range(slots):
        k, v = synthetic_kv_stream(rng, 1, 5 + 7 * (sid % 4), SHARD_HKV,
                                   SHARD_HD, compressible=sid % 3 != 2)
        ref.prefill(sid, k[0], v[0])
        port.prefill(sid, k[0], v[0])
    q = rng.standard_normal((slots, SHARD_HQ, SHARD_HD)).astype(np.float32)
    return ref, port, q


@pytest.mark.parametrize("packing", ["pair", "quad"])
@pytest.mark.parametrize("slots", [3, 4])
def test_shard_true_on_one_device_is_the_single_device_decode(packing,
                                                              slots):
    ref, port, q = _serve_loops(packing, slots)
    sharded = t_shard.shard_kv_attend(port.cache, _t(q), shard=True)
    single = t_shard.shard_kv_attend(port.cache, _t(q), shard=False)
    assert torch.equal(sharded, single)
    assert torch.equal(t_shard.shard_kv_attend(port.cache, _t(q)), single)
    want = r_shard(ref.cache, q, shard=True, devices=jax.devices()[:1])
    np.testing.assert_allclose(sharded.numpy(), np.asarray(want), **TOL)
    out = port.attend({sid: q[sid] for sid in range(slots)}, shard=True)
    for sid in range(slots):
        assert torch.equal(out[sid], single[sid])


def test_shard_true_raises_only_for_a_real_multi_card_shard(monkeypatch):
    """With two devices, `shard=True` over a slot count they divide is the
    sharded attend (no longer a NotImplementedError): one decode a shard,
    equal to the single-device decode; over one they do not divide it
    falls back to the single-device decode, as the reference does."""
    calls = []
    decode = T.decode_attention_fused
    monkeypatch.setattr(T, "decode_attention_fused",
                        lambda *a, **kw: calls.append(len(a[0]))
                        or decode(*a, **kw))
    for slots, shards in ((4, [2, 2]), (3, [3])):
        _, port, q = _serve_loops("pair", slots)
        single = t_shard.shard_kv_attend(port.cache, _t(q), shard=False)
        for shard in (True, "auto"):
            calls.clear()
            got = t_shard.shard_kv_attend(port.cache, _t(q), shard=shard,
                                          devices=["cpu"] * 2)
            assert calls == shards
            assert torch.equal(got, single)
        calls.clear()
        t_shard.shard_kv_attend(port.cache, _t(q), shard=False,
                                devices=["cpu"] * 2)
        assert calls == [slots]


@pytest.mark.parametrize("packing", ["pair", "quad"])
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_attend_over_cpu_devices(packing, k):
    """Slot shards on k CPU devices: bit-identical to the single-device
    decode, and within the attention tolerance of the reference's
    single-device attend."""
    ref, port, q = _serve_loops(packing, 8)
    single = t_shard.shard_kv_attend(port.cache, _t(q), shard=False)
    got = t_shard.shard_kv_attend(port.cache, _t(q), devices=["cpu"] * k)
    assert got.device == port.cache.device
    assert torch.equal(got, single)
    want = r_shard(ref.cache, q, shard=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
