"""Port parity, the codec and layout registries: the same numpy inputs go
through `repro.compression` (the reference) and `repro_torch.compression`.

Everything here is integer or byte output and must be bit-exact: the
registries' surfaces, every line codec's per-line bytes, batch stream and
sizes, the host marker classification, the layout tables and helpers, and
the page codecs' device pair (the port's plain versions on the CPU against
the reference's Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import codecs as r_codecs
from repro.compression import layouts as r_layouts
from repro.compression import marker as r_marker
from repro_torch import compression as t_compression
from repro_torch.compression import codecs as t_codecs
from repro_torch.compression import layouts as t_layouts
from repro_torch.compression import marker as t_marker

torch.set_num_threads(1)

LINE_NAMES = ("raw", "bdi", "fpc", "hybrid")


def _lines(seed: int, n_random: int = 24) -> np.ndarray:
    """Structured lines covering every FPC pattern and BDI mode, zero-run
    boundaries, and random lines."""
    rng = np.random.default_rng(seed)
    lines = [np.zeros(64, np.uint8),
             np.tile(np.arange(8, dtype=np.uint8), 8),                 # rep8
             np.repeat(rng.integers(0, 256, 16), 4).astype(np.uint8),  # repb
             rng.integers(-8, 8, 16).astype("<i4").view(np.uint8),     # se4
             rng.integers(-128, 128, 16).astype("<i4").view(np.uint8),
             rng.integers(-30000, 30000, 16).astype("<i4").view(np.uint8),
             (rng.integers(0, 2**15, 16).astype("<u4") << 16).view(np.uint8),
             (np.int64(10**15) + np.arange(8)).astype("<i8").view(np.uint8),
             (np.int64(2**40) + rng.integers(-30000, 30000, 8)).astype(
                 "<i8").view(np.uint8),
             (np.int64(2**29) + rng.integers(-100, 100, 16)).astype(
                 "<i4").view(np.uint8),
             (1000 + rng.integers(-120, 120, 32)).astype("<i2").view(np.uint8),
             rng.integers(-128, 128, 32).astype("<i2").view(np.uint8)]
    for start, stop in ((4, 8), (0, 40), (36, 64), (8, 12)):
        z = np.zeros(64, np.uint8)
        z[start:stop] = rng.integers(1, 256, stop - start)
        lines.append(z)
    lines += list(rng.integers(0, 256, (n_random, 64)).astype(np.uint8))
    return np.stack([np.ascontiguousarray(x) for x in lines])


def test_registry_surface_matches_reference():
    assert t_codecs.codec_names() == r_codecs.codec_names()
    for unit in ("line64", "page"):
        assert t_codecs.codec_names(unit) == r_codecs.codec_names(unit)
    for name in r_codecs.codec_names():
        r, t = r_codecs.get_codec(name), t_codecs.get_codec(name)
        for field in ("unit", "description", "group_lanes", "scan_field"):
            assert getattr(t, field) == getattr(r, field), (name, field)
        assert t.has_pallas() == r.has_pallas(), name
        for field in ("pallas_pack", "pallas_unpack", "pallas_scan"):
            rv, tv = getattr(r, field), getattr(t, field)
            assert (rv is None) == (tv is None), (name, field)
            if rv is not None:
                assert tv.startswith("repro_torch.kernels.")
                assert tv.split(".")[-1] == rv.split(".")[-1], (name, field)
    with pytest.raises(KeyError):
        t_codecs.get_codec("lz77")
    # the package exports what the reference's does
    from repro import compression as r_compression

    assert sorted(t_compression.__all__) == sorted(r_compression.__all__)
    for name in ("LINE_BYTES", "SLOT_BUDGET", "MARKER_BYTES", "MARKER_LANES",
                 "PAYLOAD_BUDGET", "HEADER_BYTES"):
        assert getattr(t_compression, name) == getattr(r_compression, name)


def test_backends_resolve_to_the_port_kernels():
    from repro_torch.kernels import bdi_pack, compress_scan

    for name in ("bdi", "fpc", "hybrid"):
        assert t_codecs.get_codec(name).scan() is compress_scan.compress_scan
    assert t_codecs.get_codec("int8-delta").pallas() == (
        bdi_pack.pack_pair, bdi_pack.unpack_pair)
    assert t_codecs.get_codec("int4-delta").pallas() == (
        bdi_pack.pack_quad, bdi_pack.unpack_quad)
    assert t_codecs.get_codec("raw").scan() is None
    assert t_codecs.get_codec("raw").pallas() is None


@pytest.mark.parametrize("name", LINE_NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_line_codec_bytes_and_sizes_bit_exact(name, seed):
    r, t = r_codecs.get_codec(name), t_codecs.get_codec(name)
    lines = _lines(seed)
    sizes_r, sizes_t = np.asarray(r.sizes(lines)), t.sizes(lines)
    assert sizes_t.dtype == sizes_r.dtype
    assert np.array_equal(sizes_t, sizes_r)
    for i, line in enumerate(lines):
        blob = t.pack_line(line)
        assert blob == r.pack_line(line), (name, i)
        out, nxt = t.unpack_line(blob + b"\x00\x07", 0)
        want, want_nxt = r.unpack_line(blob + b"\x00\x07", 0)
        assert np.array_equal(out, want) and np.array_equal(out, line)
        assert nxt == want_nxt == len(blob) == int(sizes_t[i]), (name, i)
    stream = t.pack_batch(lines)
    assert np.array_equal(stream, r.pack_batch(lines))
    assert stream.tobytes() == b"".join(t.pack_line(x) for x in lines)


def test_component_size_functions_bit_exact():
    from repro.compression import bdi as r_bdi
    from repro.compression import fpc as r_fpc
    from repro.compression import hybrid as r_hybrid
    from repro_torch.compression import bdi as t_bdi
    from repro_torch.compression import fpc as t_fpc
    from repro_torch.compression import hybrid as t_hybrid

    lines = _lines(2, n_random=200)
    words = lines.view("<u4").reshape(-1, 16)
    assert np.array_equal(t_fpc.fpc_size_bits(words),
                          r_fpc.fpc_size_bits(words))
    assert np.array_equal(t_fpc.fpc_size_bytes(lines),
                          r_fpc.fpc_size_bytes(lines))
    for got, want in zip(t_bdi.bdi_sizes(lines), r_bdi.bdi_sizes(lines),
                         strict=True):
        assert np.array_equal(got, want)
    assert np.array_equal(t_hybrid.compressed_sizes(lines),
                          r_hybrid.compressed_sizes(lines))
    assert np.array_equal(t_hybrid.compress_batch(lines),
                          r_hybrid.compress_batch(lines))
    _, modes = t_bdi.bdi_sizes(lines)
    for mode in np.unique(modes):
        sel = lines[modes == mode]
        packed = t_bdi.bdi_pack_batch(sel, int(mode))
        assert np.array_equal(packed, r_bdi.bdi_pack_batch(sel, int(mode)))
        assert np.array_equal(t_bdi.bdi_unpack_batch(packed, int(mode)), sel)


def test_group_pack_and_unpack_bit_exact():
    from repro.compression import hybrid as r_hybrid
    from repro_torch.compression import hybrid as t_hybrid

    lines = _lines(3)
    marker = bytes([0xA5, 0x5A, 0x3C, 0xC3])
    sizes = t_hybrid.compressed_sizes(lines)
    packed_any = False
    for i in range(0, len(lines) - 3, 2):
        for group in (list(lines[i:i + 2]), list(lines[i:i + 4])):
            lanes = tuple(range(len(group)))
            got = t_hybrid.pack_group(group, marker)
            want = r_hybrid.pack_group(group, marker)
            assert (got is None) == (want is None)
            fits = t_hybrid.group_fits(sizes[i:i + len(group)], lanes)
            assert fits == r_hybrid.group_fits(sizes[i:i + len(group)], lanes)
            assert fits == (got is not None)
            if got is not None:
                packed_any = True
                assert np.array_equal(got, want)
                for a, b in zip(t_hybrid.unpack_group(got, len(group)),
                                group, strict=True):
                    assert np.array_equal(a, b)
    assert packed_any


def test_line_status_and_classify_line_match_reference():
    assert {s.name: int(s) for s in t_marker.LineStatus} == \
        {s.name: int(s) for s in r_marker.LineStatus}
    spec_r, spec_t = r_marker.MarkerSpec(), t_marker.MarkerSpec()
    rng = np.random.default_rng(9)
    for slot in (0, 1, 77, 2**33 + 5):
        assert spec_t.marker2(slot) == spec_r.marker2(slot)
        assert spec_t.marker4(slot) == spec_r.marker4(slot)
        assert spec_t.marker_il(slot) == spec_r.marker_il(slot)
        base = rng.integers(0, 256, 64).astype(np.uint8)
        planted = [base]
        for tail in (spec_r.marker2(slot), spec_r.marker4(slot),
                     bytes(255 - x for x in spec_r.marker2(slot)),
                     bytes(255 - x for x in spec_r.marker4(slot))):
            line = base.copy()
            line[-4:] = np.frombuffer(tail, np.uint8)
            planted.append(line)
        il = np.frombuffer(spec_r.marker_il(slot), np.uint8)
        planted += [il.copy(), (255 - il).astype(np.uint8)]
        got = [t_marker.classify_line(x, slot, spec_t) for x in planted]
        want = [r_marker.classify_line(x, slot, spec_r) for x in planted]
        assert [int(s) for s in got] == [int(s) for s in want]
        assert {int(s) for s in got} == set(range(5))
        for x in planted:
            assert t_marker.needs_inversion(x, slot, spec_t) == \
                r_marker.needs_inversion(x, slot, spec_r)
            assert np.array_equal(t_marker.invert_line(x),
                                  r_marker.invert_line(x))
    spec_t.regenerate()
    spec_r.regenerate()
    assert spec_t.marker2(3) == spec_r.marker2(3)
    assert t_marker.collision_probability() == \
        r_marker.collision_probability()


def test_layouts_match_reference():
    assert t_layouts.layout_names() == r_layouts.layout_names()
    for name in r_layouts.layout_names():
        r, t = r_layouts.get_layout(name), t_layouts.get_layout(name)
        for field in ("n_lanes", "candidates", "state_names", "slot_budget",
                      "marker_bytes", "payload_budget", "description"):
            assert getattr(t, field) == getattr(r, field), (name, field)
        for field in ("loc", "vacated", "lines_in_slot", "lanes_in_slot",
                      "lane_level", "pred_slot"):
            assert np.array_equal(getattr(t, field), getattr(r, field))
        assert t.n_states == r.n_states
        for lane in range(r.n_lanes):
            for slot in range(r.n_lanes):
                assert t.probe_chain(lane, slot) == r.probe_chain(lane, slot)
            for state in range(r.n_states):
                assert t.slot_of(state, lane) == r.slot_of(state, lane)
    for lane in range(4):
        for slot in range(4):
            assert t_layouts.probe_chain(lane, slot) == \
                r_layouts.probe_chain(lane, slot)
    rng = np.random.default_rng(11)
    for _ in range(200):
        sizes = rng.integers(1, 66, 4)
        mask = int(rng.integers(0, 16))
        assert t_layouts.choose_state(sizes, mask) == \
            r_layouts.choose_state(sizes, mask)
    for bits in range(8):
        flags = [bool(bits & 1), bool(bits & 2), bool(bits & 4)]
        assert t_layouts.fits_to_state(*flags) == \
            r_layouts.fits_to_state(*flags)
    with pytest.raises(KeyError):
        t_layouts.get_layout("group8")


# --------------------------------------------- page codecs: K1/K2, K4/K5

def _group_pages(rng, lanes, lead, compressible, page=4, hkv=2, d2=16):
    row = rng.integers(-1000, 1000, (*lead, 1, hkv, d2))
    shape = (*lead, page, hkv, d2)
    spread = 8 if lanes == 2 else 1
    pages = []
    for _ in range(lanes):
        noise = (rng.integers(-spread, spread, shape) if compressible
                 else rng.integers(-(2**14), 2**14, shape))
        pages.append((row + noise).astype(np.int16))
    pages[0][..., 0, :, :] = row[..., 0, :, :]   # lane A's token-0 row
    return pages


@pytest.mark.parametrize("name,lanes", [("int8-delta", 2), ("int4-delta", 4)])
@pytest.mark.parametrize("compressible", [True, False])
def test_page_codec_device_pair_matches_reference_kernels(name, lanes,
                                                          compressible):
    """The registry's (pack, unpack) on CPU tensors (the plain versions)
    against the reference's Pallas kernels in interpret mode: per group,
    and with a leading group axis against the reference vmapped."""
    rng = np.random.default_rng([lanes, compressible])
    pack_t, unpack_t = t_codecs.get_codec(name).pallas()
    pack_r, unpack_r = r_codecs.get_codec(name).pallas()
    pages = _group_pages(rng, lanes, (), compressible)
    packed_t, base_t, ok_t = pack_t(*map(torch.from_numpy, pages))
    packed_r, base_r, ok_r = pack_r(*map(jnp.asarray, pages), interpret=True)
    assert bool(ok_t) == bool(ok_r) == compressible
    assert np.array_equal(packed_t.numpy(), np.asarray(packed_r))
    assert np.array_equal(base_t.numpy(), np.asarray(base_r))
    got = unpack_t(packed_t, base_t)
    want = unpack_r(packed_r, base_r, interpret=True)
    for g, w, p in zip(got, want, pages, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
        if compressible:
            assert np.array_equal(g.numpy(), p)
    # a leading group axis: one call over G groups
    g = 3
    groups = _group_pages(rng, lanes, (g,), compressible)
    packed_t, base_t, ok_t = pack_t(*map(torch.from_numpy, groups))
    packed_r, base_r, ok_r = jax.vmap(
        lambda *p: pack_r(*p, interpret=True))(*map(jnp.asarray, groups))
    assert ok_t.shape == (g,)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_r))
    assert np.array_equal(packed_t.numpy(), np.asarray(packed_r))
    assert np.array_equal(base_t.numpy(), np.asarray(base_r))
    got = unpack_t(packed_t, base_t)
    want = jax.vmap(lambda p, b: unpack_r(p, b, interpret=True))(
        packed_r, base_r)
    for a, b in zip(got, want, strict=True):
        assert a.shape == (g, 4, 2, 16)
        assert np.array_equal(a.numpy(), np.asarray(b))
