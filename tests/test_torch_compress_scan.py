"""Port parity, the one-pass compressibility scan (K7): the port's plain
version of the kernel body against the reference's Pallas kernel in
interpret mode and against the bit-true numpy codec.

All four outputs (sizes, fpc, bdi, status) must be bit-exact at every
size and key.  The Fig. 4 memory image `chip_smoke.py` scans on the card
is a copy of the benchmark's corpus: it must be byte-equal to it, and its
pair-fit statistics must be the benchmark's."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.core.compress import compressed_sizes
from repro.kernels import compress_scan as R
from repro_torch.compression import hybrid as t_hybrid
from repro_torch.compression.marker import LineStatus
from repro_torch.kernels import compress_scan as T

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
KEYS = (0x5EED, 0, 0xDEADBEEF)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(n: int, seed: int = 0) -> np.ndarray:
    """Random + structured lines exercising every FPC/BDI mode family (the
    reference test's corpus)."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 256, (n, 64)).astype(np.uint8)
    lines[0::7] = 0                                            # M_ZEROS
    lines[1::7] = np.tile(rng.integers(0, 256, 8).astype(np.uint8), 8)
    base = rng.integers(0, 2**31, dtype=np.int64)              # M_REP8
    k = len(lines[2::5])
    lines[2::5] = (base + rng.integers(-100, 100, (k, 8))).astype(
        "<i8").view(np.uint8).reshape(k, 64)                   # B8D1/D2
    k = len(lines[3::5])
    lines[3::5] = rng.integers(-7, 8, (k, 16)).astype(
        "<i4").view(np.uint8).reshape(k, 64)                   # FPC SE4
    k = len(lines[4::5])
    lines[4::5] = (1000 + rng.integers(-120, 120, (k, 32))).astype(
        "<i2").view(np.uint8).reshape(k, 64)                   # B2D1 / SE16
    return lines


def _plant(lines: np.ndarray, key: int) -> dict:
    """Plant each marker class at spread slots; returns slot -> class."""
    n = lines.shape[0]
    slots = np.linspace(0, n - 1, 6).astype(np.int64)
    m2, m4 = R.device_markers(slots, key)
    il = R.device_il_words(slots, key)
    want = {}
    for i, (s, cls) in enumerate(zip(slots, (
            LineStatus.COMP2, LineStatus.COMP4, LineStatus.INVALID,
            LineStatus.MAYBE_INVERTED, LineStatus.MAYBE_INVERTED,
            LineStatus.MAYBE_INVERTED), strict=True)):
        if i == 0:
            lines[s, -4:] = np.frombuffer(m2[i].tobytes(), np.uint8)
        elif i == 1:
            lines[s, -4:] = np.frombuffer(m4[i].tobytes(), np.uint8)
        elif i == 2:
            lines[s] = il[i].astype("<u4").view(np.uint8)
        elif i == 3:
            lines[s, -4:] = np.frombuffer((~m2[i]).tobytes(), np.uint8)
        elif i == 4:
            lines[s, -4:] = np.frombuffer((~m4[i]).tobytes(), np.uint8)
        else:
            lines[s] = (~il[i]).astype("<u4").view(np.uint8)
        want[int(s)] = int(cls)
    return want


def _assert_scan_equal(lines, key, got):
    want = R.compress_scan(lines, key=key, interpret=True)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == torch.int32, name
        assert np.array_equal(got[name].numpy(), arr), name


@pytest.mark.parametrize("n,seed", [(1024, 0), (301, 3), (1, 5)])
@pytest.mark.parametrize("key", KEYS)
def test_plain_scan_matches_reference_kernel(n, seed, key):
    lines = _lines(n, seed)
    got = T.compress_scan(torch.from_numpy(lines), key=key)
    _assert_scan_equal(lines, key, got)
    assert np.array_equal(got["sizes"].numpy(), compressed_sizes(lines))
    assert np.array_equal(got["sizes"].numpy(),
                          t_hybrid.compressed_sizes(lines))


@pytest.mark.parametrize("key", KEYS[1:])
def test_planted_marker_lines_at_a_non_default_key(key):
    lines = _lines(512, seed=2)
    want = _plant(lines, key)
    got = T.compress_scan(torch.from_numpy(lines), key=key)
    _assert_scan_equal(lines, key, got)
    status = got["status"].numpy()
    for slot, cls in want.items():
        assert status[slot] == cls, slot
    assert set(status.tolist()) == {int(s) for s in LineStatus}
    assert np.array_equal(status, T.classify_image_ref(lines, key))
    assert np.array_equal(status, R.classify_image_ref(lines, key))
    # the default key sees none of those markers
    other = T.compress_scan(torch.from_numpy(lines))["status"].numpy()
    assert (other == int(LineStatus.UNCOMP)).all()


def test_host_helpers_match_reference():
    idx = np.asarray([0, 1, 2**27 - 1, 2**27, 2**31 - 1, 2**32 + 3])
    for key in KEYS:
        for a, b in zip(T.device_markers(idx, key),
                        R.device_markers(idx, key), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(T.device_il_words(idx, key),
                              R.device_il_words(idx, key))


def test_first_slot_offsets_the_marker_family():
    """A chunk scanned with `first_slot=o` equals the whole image's rows
    from o on (how the card holds its one-launch scan against the plain
    version in chunks)."""
    key = 0xDEADBEEF
    lines = _lines(300, seed=4)
    _plant(lines, key)
    whole = T.compress_scan_plain(torch.from_numpy(lines), key=key)
    for o in (0, 37, 255):
        part = T.compress_scan_plain(torch.from_numpy(lines[o:]), key=key,
                                     first_slot=o)
        for name in whole:
            assert torch.equal(part[name], whole[name][o:]), (o, name)
        assert np.array_equal(
            T.classify_image_ref(lines[o:], key, first_slot=o),
            whole["status"][o:].numpy())


def test_fig4_corpus_copy_and_statistics():
    from benchmarks.fig4_compressibility import _corpus, pair_fit_stats

    smoke = _chip_smoke()
    copy, orig = smoke.fig4_corpus(4096, 0), _corpus(4096, 0)
    assert list(copy) == list(orig)
    for name in orig:
        assert copy[name].dtype == orig[name].dtype
        assert np.array_equal(copy[name], orig[name]), name
    names, images = zip(*sorted(copy.items()), strict=True)
    lines = np.concatenate([v.reshape(-1, 64) for v in images])
    assert lines.shape == (30720, 64)
    got = T.compress_scan(torch.from_numpy(lines))
    _assert_scan_equal(lines, 0x5EED, got)
    sizes = got["sizes"].numpy()
    p64, p60 = smoke.pair_fit_stats(sizes)
    assert (p64, p60) == pair_fit_stats(sizes)
    assert (round(p64, 4), round(p60, 4)) == (0.3311, 0.3118)
    assert (got["status"].numpy() == int(LineStatus.UNCOMP)).all()


def test_scan_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        T.compress_scan(torch.zeros((4, 64), dtype=torch.int16))
    with pytest.raises(ValueError, match="uint8"):
        T.compress_scan(torch.zeros((4, 32), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.compress_scan_cuda(torch.zeros((4, 64), dtype=torch.uint8))
