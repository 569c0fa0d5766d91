"""Port parity, framing to kernels: the same numpy inputs go through the
JAX reference (Pallas in interpret mode) and the port's plain PyTorch
versions on the CPU.

Integer outputs — markers, window packs, caches, physical views, bytes —
must be bit-exact.  Attention outputs are float32 and must agree within
atol = rtol = 1e-4: the reference's oracle softmax and the port's sum the
same terms in a different order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import framing as r_framing
from repro.compression import gate as r_gate
from repro.compression import pagepack as r_pagepack
from repro.kernels import ops as R
from repro.kernels import prefill_pack as r_prefill
from repro.kernels import ref as r_ref
from repro.kv import synthetic_kv_stream
from repro_torch.compression import framing as t_framing
from repro_torch.compression import gate as t_gate
from repro_torch.compression import pagepack as t_pagepack
from repro_torch.kernels import ops as T
from repro_torch.kernels import prefill_pack as t_prefill
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import cram_attention as t_ca
from repro_torch.kernels.cram_attention import resolve_block_groups

torch.set_num_threads(1)

PAGE, HKV, HD, HQ = 4, 2, 8, 4
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)


def _pages(rng, b, n_pages, kind):
    """(b, n_pages*PAGE, HKV, 2*HD) int16: compressible, incompressible or
    mixed (alternating page pairs) KV."""
    t = n_pages * PAGE
    kc, vc = synthetic_kv_stream(rng, b, t, HKV, HD)
    ki, vi = synthetic_kv_stream(rng, b, t, HKV, HD, compressible=False)
    if kind == "incompressible":
        kc, vc = ki, vi
    elif kind == "mixed":
        for g in range(1, n_pages // 2, 2):
            sl = slice(2 * g * PAGE, 2 * (g + 1) * PAGE)
            kc[:, sl], vc[:, sl] = ki[:, sl], vi[:, sl]
    return np.concatenate([_bits(kc), _bits(vc)], -1)


# ------------------------------------------------------------------ framing

@pytest.mark.parametrize("domain", [r_framing.DOMAIN_PAIR,
                                    r_framing.DOMAIN_QUAD])
@pytest.mark.parametrize("key", [r_framing.DEFAULT_MARKER_KEY, 0, 2**31 + 7])
def test_markers_and_lanes_bit_exact(key, domain):
    m_r = r_framing.slot_markers(37, key, domain)
    m_t = t_framing.slot_markers(37, key, domain)
    assert m_r.dtype == m_t.dtype and np.array_equal(m_r, m_t)
    lanes_r = r_framing.marker_to_lanes(m_r)
    assert np.array_equal(lanes_r, t_framing.marker_to_lanes(m_t))
    assert np.array_equal(r_framing.lanes_to_marker_i32(lanes_r, np),
                          t_framing.lanes_to_marker_i32(lanes_r, np))
    for name in ("MARKER_LANES", "DOMAIN_PAIR", "DOMAIN_QUAD",
                 "DEFAULT_MARKER_KEY", "FIB_MULT", "M2_MULT", "M4_MULT",
                 "IL_MULT"):
        assert getattr(r_framing, name) == getattr(t_framing, name), name
    for name in ("COUNTER_MAX", "ENABLE_THRESHOLD", "COUNTER_INIT"):
        assert getattr(r_gate, name) == getattr(t_gate, name), name


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("kind", ["compressible", "incompressible"])
def test_pagepack_codecs_bit_exact(lanes, kind):
    rng = np.random.default_rng(lanes)
    pages = _pages(rng, 1, lanes, kind)[0].reshape(lanes, PAGE, HKV, 2 * HD)
    pack_r = r_pagepack.pack_pair if lanes == 2 else r_pagepack.pack_quad
    pack_t = t_pagepack.pack_pair if lanes == 2 else t_pagepack.pack_quad
    ok_r, packed_r, base_r = pack_r(*pages)
    ok_t, packed_t, base_t = pack_t(*map(_t, pages))
    assert bool(ok_r) == bool(ok_t)
    assert np.array_equal(packed_r, packed_t.numpy())
    assert np.array_equal(base_r, base_t.numpy())
    unpack_r = (r_pagepack.unpack_pair if lanes == 2
                else r_pagepack.unpack_quad)
    unpack_t = (t_pagepack.unpack_pair if lanes == 2
                else t_pagepack.unpack_quad)
    for a, b in zip(unpack_r(packed_r, base_r),
                    unpack_t(packed_t, base_t), strict=True):
        assert np.array_equal(a, b.numpy())
    if ok_r:
        for a, b in zip(unpack_t(packed_t, base_t), pages, strict=True):
            assert np.array_equal(a.numpy(), b)
    # the kernels' `ref` oracles are the same codecs under the ref names
    name = "pair" if lanes == 2 else "quad"
    ok_rr, packed_rr, base_rr = getattr(r_ref, f"pack_{name}_ref")(
        *map(jnp.asarray, pages))
    ok_tr, packed_tr, base_tr = getattr(t_ref, f"pack_{name}_ref")(
        *map(_t, pages))
    assert bool(ok_rr) == bool(ok_tr)
    assert np.array_equal(_np(packed_rr), packed_tr.numpy())
    assert np.array_equal(_np(base_rr), base_tr.numpy())
    for a, b in zip(getattr(r_ref, f"unpack_{name}_ref")(packed_rr, base_rr),
                    getattr(t_ref, f"unpack_{name}_ref")(packed_tr, base_tr),
                    strict=True):
        assert np.array_equal(_np(a), b.numpy())


# ------------------------------------------------------------------ windows

GATES = {"on": [True, True, True], "off": [False, False, False],
         "mixed": [True, False, True]}


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("kind", ["compressible", "incompressible", "mixed"])
def test_layout_window_bit_exact(lanes, gate, kind):
    rng = np.random.default_rng(
        [lanes, sorted(GATES).index(gate), len(kind)])
    b, w = 3, 4
    pages = _pages(rng, b, w * lanes, kind)
    pages[2, -PAGE // 2:] = 0                       # a partial last page
    win = pages.reshape(b, w, lanes, PAGE, HKV, 2 * HD)
    mk = rng.integers(-2**15, 2**15, (w, 2)).astype(np.int16)
    en = np.array(GATES[gate])
    for use_pack in (True, False):
        ref = R.layout_window(jnp.asarray(win), jnp.asarray(mk),
                              jnp.asarray(en), use_pack=use_pack,
                              interpret=True)
        got = T.layout_window(_t(win), _t(mk), _t(en), use_pack=use_pack)
        for name, a, g in zip(("slots", "over", "strips", "lay", "fit"),
                              ref, got, strict=True):
            assert np.array_equal(_np(a), g.numpy()), (name, use_pack)


@pytest.mark.parametrize("lanes", [2, 4])
def test_prefill_pack_padded_index_bit_exact(lanes):
    """A prompt's touched columns, padded to a power of two by repeating a
    real column, as the serve cache sends them."""
    rng = np.random.default_rng(11)
    n_groups = 6
    pages = _pages(rng, 2, n_groups * lanes, "mixed")
    pages[:, 13:] = 0                               # prompt of 13 tokens
    idx = np.array([0, 1, 2, 3, 4, 4, 4, 4], np.int32)
    mk = r_framing.marker_to_lanes(r_framing.slot_markers(n_groups))
    en = np.array([True, False])
    ref = r_prefill.prefill_pack(jnp.asarray(pages), jnp.asarray(idx),
                                 jnp.asarray(mk), jnp.asarray(en),
                                 lanes=lanes, page=PAGE, interpret=True)
    got = t_prefill.prefill_pack(_t(pages), _t(idx.astype(np.int64)), _t(mk),
                                 _t(en), lanes=lanes, page=PAGE)
    for a, g in zip(ref, got, strict=True):
        assert np.array_equal(_np(a), g.numpy())


# ------------------------------------------------------- caches and views

def _caches(rng, lanes, b, n_groups):
    """Per-sequence caches from the reference's build (numpy leaves)."""
    build = R.build_cram_cache if lanes == 2 else R.build_cram_cache_quad
    kinds = ["compressible", "mixed", "incompressible"]
    cs = [build(jnp.asarray(_pages(rng, 1, n_groups * lanes,
                                   kinds[i % 3])[0].reshape(
                                       -1, PAGE, HKV, 2 * HD)),
                interpret=True) for i in range(b)]
    cache = {k: np.stack([_np(c[k]) for c in cs])
             for k in ("slots", "slots_overflow", "strips", "packed_mask")}
    cache["markers"] = _np(cs[0]["markers"])
    return cache


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("kind", ["compressible", "incompressible", "mixed"])
def test_build_cache_and_physical_view_bit_exact(lanes, kind):
    rng = np.random.default_rng(5)
    n_groups = 4
    pages = _pages(rng, 1, n_groups * lanes, kind)[0].reshape(
        -1, PAGE, HKV, 2 * HD)
    build_r = R.build_cram_cache if lanes == 2 else R.build_cram_cache_quad
    build_t = T.build_cram_cache if lanes == 2 else T.build_cram_cache_quad
    c_r = build_r(jnp.asarray(pages), interpret=True)
    c_t = build_t(_t(pages))
    assert c_r.keys() == c_t.keys()
    for k in c_r:
        assert np.array_equal(_np(c_r[k]), c_t[k].numpy()), k
    valid = rng.integers(0, PAGE + 1, n_groups * lanes).astype(np.int32)
    pv_r = R.physical_view if lanes == 2 else R.physical_view_quad
    pv_t = T.physical_view if lanes == 2 else T.physical_view_quad
    for a, g in zip(pv_r(c_r, jnp.asarray(valid)),
                    pv_t(c_t, _t(valid)), strict=True):
        assert np.array_equal(_np(a), g.numpy())
    markers_u = np.asarray(c_r["markers"]).view(np.uint32)
    for a, g in zip(r_ref.materialize_kv_ref(c_r["slots"], c_r["strips"],
                                             jnp.asarray(markers_u), lanes),
                    t_ref.materialize_kv_ref(c_t["slots"], c_t["strips"],
                                             c_t["markers"], lanes),
                    strict=True):
        assert np.array_equal(_np(a), g.numpy())


def _ragged_valid(rng, b, n_pages):
    tokens = rng.integers(1, n_pages * PAGE, b)
    tokens[1] = 0                                   # a zero-valid lane
    v = np.clip(tokens[:, None] - np.arange(n_pages)[None] * PAGE, 0, PAGE)
    return v.astype(np.int32)


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("block_groups", [1, None])
def test_decode_attention_fused_matches_reference(lanes, shared,
                                                  block_groups):
    rng = np.random.default_rng(lanes * 10 + shared)
    b, n_groups = 4, 4
    cache = _caches(rng, lanes, b, n_groups)
    valid = _ragged_valid(rng, b, n_groups * lanes)
    pred = cache["packed_mask"] ^ (rng.random((b, n_groups)) < 0.4)
    if shared:
        cache = {k: (v if k == "markers" else v[0]) for k, v in cache.items()}
        valid, pred = valid[2], pred[2]
    q = rng.standard_normal((b, HQ, HD)).astype(np.float32)
    out_r, raw_r, cram_r = R.decode_attention_fused(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(valid), jnp.asarray(pred), lanes=lanes,
        block_groups=block_groups, interpret=True)
    out_t, raw_t, cram_t = T.decode_attention_fused(
        _t(q), {k: _t(v) for k, v in cache.items()}, _t(valid), _t(pred),
        lanes=lanes, block_groups=block_groups)
    np.testing.assert_allclose(out_t.numpy(), _np(out_r), **TOL)
    assert np.array_equal(raw_t.numpy(), _np(raw_r))
    assert np.array_equal(cram_t.numpy(), _np(cram_r))
    # the standalone byte model agrees with the kernel's byte output
    bw_r = R.hbm_bytes_moved({k: jnp.asarray(v) for k, v in cache.items()},
                             jnp.asarray(valid), jnp.asarray(pred),
                             lanes=lanes)
    bw_t = T.hbm_bytes_moved({k: _t(v) for k, v in cache.items()},
                             _t(valid), _t(pred), lanes=lanes)
    for key in ("raw_bytes", "cram_bytes"):
        assert bw_r[key] == bw_t[key]
    for key in ("raw_per_seq", "cram_per_seq"):
        assert np.array_equal(bw_r[key], bw_t[key])


@pytest.mark.parametrize("lanes", [2, 4])
def test_reference_oracles_match(lanes):
    rng = np.random.default_rng(3)
    b, n_groups = 3, 2
    cache = _caches(rng, lanes, b, n_groups)
    valid = _ragged_valid(rng, b, n_groups * lanes)
    q = rng.standard_normal((b, HQ, HD)).astype(np.float32)
    if lanes == 2:
        ref_r, ref_t = R.decode_attention_ref_batched, \
            T.decode_attention_ref_batched
    else:
        ref_r, ref_t = R.decode_attention_quad_ref_batched, \
            T.decode_attention_quad_ref_batched
    want = ref_r(jnp.asarray(q), {k: jnp.asarray(v) for k, v in
                                  cache.items()}, valid)
    got = ref_t(_t(q), {k: _t(v) for k, v in cache.items()}, _t(valid))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # an all-masked lane averages V over the masked positions, not NaN
    assert np.isfinite(got.numpy()).all()


def test_shared_cache_aliases_and_byte_events_match_reference():
    """`decode_attention` / `decode_attention_ref` over one shared pair
    cache, and the host ledger events `kv_decode_event` /
    `kv_repack_event`."""
    from repro.bandwidth import Ledger as RLedger
    from repro.bandwidth import adapters as r_adapters
    from repro_torch.bandwidth import Ledger as TLedger
    from repro_torch.bandwidth import adapters as t_adapters

    rng = np.random.default_rng(4)
    cache = {k: (v if k == "markers" else v[0])
             for k, v in _caches(rng, 2, 1, 3).items()}
    valid = _ragged_valid(rng, 2, 6)[0]
    q = rng.standard_normal((3, HQ, HD)).astype(np.float32)
    c_r = {k: jnp.asarray(v) for k, v in cache.items()}
    c_t = {k: _t(v) for k, v in cache.items()}
    for fn in ("decode_attention", "decode_attention_ref"):
        want = getattr(R, fn)(jnp.asarray(q), c_r, jnp.asarray(valid))
        got = getattr(T, fn)(_t(q), c_t, _t(valid))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    bw_r = R.hbm_bytes_moved(c_r, jnp.asarray(valid))
    bw_t = T.hbm_bytes_moved(c_t, _t(valid))
    led_r, led_t = RLedger("kv"), TLedger("kv")
    r_adapters.kv_decode_event(led_r, bw_r)
    t_adapters.kv_decode_event(led_t, bw_t)
    geo = dict(groups=5, packed=3, lanes=4, slot_bytes=4096, strip_bytes=72)
    r_adapters.kv_repack_event(led_r, **geo)
    t_adapters.kv_repack_event(led_t, **geo)
    assert led_r.as_dict() == led_t.as_dict()
    assert led_r.saving() == led_t.saving()


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("cut", [0, 1, 3])
def test_single_sequence_decode_matches_reference_kernel(lanes, cut):
    """K6 on one sequence's physical view, cut to n % lanes != 0, against
    the reference's `cram_decode_attention` (Pallas, interpret mode).
    Sequence 1 has no valid token: both average V over every position."""
    from repro.kernels.cram_attention import cram_decode_attention as r_k6

    rng = np.random.default_rng([lanes, cut])
    n_groups = 3
    cache = _caches(rng, lanes, 2, n_groups)
    valid = _ragged_valid(rng, 2, n_groups * lanes)
    pv = T.physical_view if lanes == 2 else T.physical_view_quad
    for seq in (0, 1):
        one = {k: _t(v if k == "markers" else v[seq])
               for k, v in cache.items()}
        s, st, mk, v = pv(one, _t(valid[seq]))
        n = s.shape[0] - cut
        args = [x[:n].contiguous() for x in (s, st, mk, v)]
        q = rng.standard_normal((HQ, HD)).astype(np.float32)
        got = t_ca.cram_decode_attention(_t(q), *args, lanes=lanes)
        want = r_k6(jnp.asarray(q), *(jnp.asarray(a.numpy()) for a in args),
                    lanes=lanes, interpret=True)
        assert got.shape == (HQ, HD) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        assert torch.equal(got, t_ca.cram_decode_attention_plain(
            _t(q), *args, lanes=lanes))


@pytest.mark.parametrize("lanes", [2, 4])
def test_single_sequence_decode_is_k3_per_sequence(lanes):
    """K6 on each sequence's physical view equals that sequence's row of
    the batched decode (the reference's `_legacy_vmap_decode` relation)."""
    rng = np.random.default_rng(lanes)
    b, n_groups = 3, 4
    cache = {k: _t(v) for k, v in _caches(rng, lanes, b, n_groups).items()}
    valid = _t(_ragged_valid(rng, b, n_groups * lanes))
    q = _t(rng.standard_normal((b, HQ, HD)).astype(np.float32))
    out, _, _ = T.decode_attention_fused(q, cache, valid, lanes=lanes)
    pv = T.physical_view if lanes == 2 else T.physical_view_quad
    s, st, mk, v = pv(cache, valid)
    for i in range(b):
        one = t_ca.cram_decode_attention(q[i], s[i], st[i], mk, v[i],
                                         lanes=lanes)
        np.testing.assert_allclose(one.numpy(), out[i].numpy(), **TOL)


@pytest.mark.parametrize("n_groups,want", [(8, None), (6, 4), (6, 5),
                                           (7, 100), (1, None)])
def test_resolve_block_groups_matches_reference(n_groups, want):
    from repro.kernels.cram_attention import resolve_block_groups as r_rbg

    assert resolve_block_groups(n_groups, want) == r_rbg(n_groups, want)
