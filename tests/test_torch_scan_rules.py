"""The integer rules of K7's CUDA kernel (`csrc/compress_scan.cu`), each
as a numpy model held against the plain version, the port's line codecs or
the JAX reference.

The kernel runs only on a card.  What it computes differently from the
reference's formulation (a bit trick, a skipped mode test, a mask instead
of a walk) is modelled here in numpy, operation for operation, and every
model must give the reference's answer on lines built at the edges those
rules turn on.  The kernel's source names the test that covers each trick.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.kernels import compress_scan as R
from repro_torch.compression import bdi
from repro_torch.compression.framing import IL_MULT
from repro_torch.kernels import compress_scan as T

try:
    from hypothesis import given
    from hypothesis import strategies as st
except ModuleNotFoundError:     # an optional dev dependency (conftest.py)
    given = None

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
U32 = 0xFFFFFFFF
MODES = ((8, 1), (8, 2), (8, 4), (4, 1), (4, 2), (2, 1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _popc(x):
    x = np.asarray(x, dtype=np.uint64)
    return np.array([bin(int(v)).count("1") for v in x.ravel()]).reshape(
        x.shape)


def _s32(u):
    """uint32 bit patterns -> their int32 values as int64."""
    u = np.asarray(u, dtype=np.int64) & U32
    return np.where(u >= 1 << 31, u - (1 << 32), u)


def _edge_words() -> np.ndarray:
    """Every FPC edge as uint32 words: +-8, +-128, +-32768 and their
    neighbours, half-se8 words from halves at the signed-byte edges, pad16
    words, repb words and words one byte off repb, plus random words."""
    vals = [0, 1, -1]
    for v in (8, 128, 32768):
        vals += [v - 1, v, v + 1, -v - 1, -v, -v + 1]
    halves = [-129, -128, -127, -1, 0, 1, 126, 127, 128, 0x7FFF, -0x8000]
    vals += [(hi << 16) | (lo & 0xFFFF) for hi in halves for lo in halves]
    vals += [h << 16 for h in halves]
    for b in (0x00, 0x01, 0x7F, 0x80, 0xAB, 0xFF):
        vals += [b * 0x01010101, b * 0x01010101 ^ 0x100,
                 b * 0x01010101 ^ 0x01000000]
    rng = np.random.default_rng(17)
    vals += rng.integers(0, 1 << 32, 2000).tolist()
    return np.unique(np.asarray(vals, dtype=np.int64) & U32).astype(np.uint32)


def _test_lines(n: int, seed: int) -> np.ndarray:
    """The card's boundary image, random lines and the Fig. 4 sources."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(seed)
    fig4 = np.concatenate([v.reshape(-1, 64)[:256] for _, v in
                           sorted(smoke.fig4_corpus(256, seed).items())])
    return np.concatenate([smoke.boundary_image(rng, n, 0x1234ABCD),
                           rng.integers(0, 256, (512, 64)).astype(np.uint8),
                           fig4])


# ------------------------------------------------------------------- FPC

def _range_chain_bits(words):
    """Payload bits of each nonzero word as the reference's last-wins
    chain on signed values (raw < half-se8 < pad16 < se16 < repb < se8 <
    se4), as `repro.kernels.compress_scan._fpc_bytes_i32`."""
    w = _s32(words)
    u = w & U32
    lo16 = ((u & 0xFFFF) ^ 0x8000) - 0x8000
    hi16 = (((u >> 16) & 0xFFFF) ^ 0x8000) - 0x8000
    b0 = u & 0xFF
    repb = ((b0 == ((u >> 8) & 0xFF)) & (b0 == ((u >> 16) & 0xFF))
            & (b0 == (u >> 24)))
    bits = np.full(w.shape, 32)
    bits = np.where((lo16 >= -128) & (lo16 < 128) & (hi16 >= -128)
                    & (hi16 < 128), 16, bits)
    bits = np.where((u & 0xFFFF) == 0, 16, bits)
    bits = np.where((w >= -32768) & (w < 32768), 16, bits)
    bits = np.where(repb, 8, bits)
    bits = np.where((w >= -128) & (w < 128), 8, bits)
    return np.where((w >= -8) & (w < 8), 4, bits)


def _kernel_word_bits(words):
    """`fpc_word_bits`: classes from t = x ^ (x << 1), repb as one byte
    permute (byte 0 in all four bytes)."""
    x = np.asarray(words, dtype=np.int64) & U32
    t = (x ^ (x << 1)) & U32
    repb = (x & 0xFF) * 0x01010101 == x
    bits = np.full(x.shape, 32)
    bits = np.where((t < 0x10000) | ((t & 0xFF00FF00) == 0)
                    | ((x & 0xFFFF) == 0), 16, bits)
    bits = np.where((t < 0x100) | repb, 8, bits)
    return np.where(t < 0x10, 4, bits)


def _kernel_zero_run_chunks(z):
    """`zero_run_chunks`: run starts plus ninth-in-a-row ends, one popc."""
    z = np.asarray(z, dtype=np.int64)
    starts = z & ~(z << 1)
    a = z & (z << 1)
    a &= a << 2
    a &= a << 4
    ninth = a & (z << 8) & ~(z << 9)
    return _popc((starts | ninth) & 0xFFFF)


def _kernel_fpc_bytes(lines):
    words = np.ascontiguousarray(lines).view("<u4").reshape(-1, 16)
    z = ((words == 0) << np.arange(16)).sum(1)
    bits = 48 + _kernel_word_bits(words).sum(1)
    bits += 6 * _kernel_zero_run_chunks(z) - 7 * _popc(z)
    return (bits + 7) >> 3


def test_significant_bit_class_matches_the_range_chain():
    words = _edge_words()
    nonzero = words[words != 0]
    assert np.array_equal(_kernel_word_bits(nonzero),
                          _range_chain_bits(nonzero))
    # every class is reached
    assert set(_kernel_word_bits(nonzero).tolist()) == {4, 8, 16, 32}
    # whole lines of edge words (with zero runs) through the plain version
    rng = np.random.default_rng(5)
    lines = rng.choice(words, (4096, 16))
    lines[rng.random((4096, 16)) < 0.3] = 0
    lines = lines.astype("<u4").view(np.uint8).reshape(-1, 64)
    want = T.compress_scan_plain(torch.from_numpy(lines))["fpc"].numpy()
    assert np.array_equal(_kernel_fpc_bytes(lines), want)


def test_zero_run_chunks_from_the_mask():
    """All 2^16 zero masks: the kernel's formula against a run walk
    (ceil(L/8) chunks a run), and whole lines with those zero words
    through the plain version's run walk, with two filler classes so that
    the byte rounding cannot hide a chunk."""
    z = np.arange(1 << 16)
    run = np.zeros_like(z)
    chunks = np.zeros_like(z)
    for i in range(16):
        bit = (z >> i) & 1
        chunks += bit & (run % 8 == 0)
        run = (run + 1) * bit
    assert np.array_equal(_kernel_zero_run_chunks(z), chunks)
    zero = ((z[:, None] >> np.arange(16)) & 1).astype(bool)
    for filler, bits in ((1, 7), (0x12345678, 35)):
        words = np.where(zero, 0, filler).astype("<u4")
        lines = words.view(np.uint8).reshape(-1, 64)
        got = T._fpc_bytes(torch.from_numpy(words.astype(np.int64))).numpy()
        want = (bits * (16 - zero.sum(1)) + 6 * chunks + 7) // 8
        assert np.array_equal(got, want)
        assert np.array_equal(_kernel_fpc_bytes(lines), want)


# --------------------------------------------------------------------- BDI

def _elems(lines, b):
    return np.ascontiguousarray(lines).view(f"<i{b}").reshape(
        lines.shape[0], 64 // b).astype(np.int64)


def _fits(v, d):
    lim = 1 << (8 * d - 1)
    return (v >= -lim) & (v < lim)


def _wrap(v, b):
    """v (int64, wrapping) into the b-byte element width, sign-extended."""
    if b == 8:
        return v
    m = 1 << (8 * b)
    return ((v & (m - 1)) ^ (m >> 1)) - (m >> 1)


def _kernel_mode_fits(lines, b, d):
    """One mode test as the kernel runs it: elements 0 and 1 first, then
    the mask of non-immediate elements, at most one of them passes, else
    the base (first of them) and the next one read by index, then the rest
    compared in registers."""
    e = _elems(lines, b)
    n = e.shape[0]
    rows = np.arange(n)
    far = ~_fits(e, d)
    with np.errstate(over="ignore"):
        quick_fail = far[:, 0] & far[:, 1] & ~_fits(
            _wrap(e[:, 1] - e[:, 0], b), d)
        first = np.argmax(far, 1)
        base = e[rows, first]
        rest = far.copy()
        rest[rows, first] = False
        second = np.argmax(rest, 1)
        second_ok = _fits(_wrap(e[rows, second] - base, b), d)
        rest[rows, second] = False
        rest_ok = (~rest | _fits(_wrap(e - base[:, None], b), d)).all(1)
    return ~quick_fail & ((far.sum(1) <= 1) | (second_ok & rest_ok))


def _kernel_bdi(lines):
    """`bdi_bytes`: zero and rep8 lines first, then the modes by base
    width, smallest payload first, with the lemma's skips.  Each branch
    reads only the tests the kernel runs on its way there."""
    e8 = _elems(lines, 8)
    zeros = (e8 == 0).all(1)
    rep8 = (e8 == e8[:, :1]).all(1)
    f = {m: _kernel_mode_fits(lines, *m) for m in MODES}
    return np.select(
        [zeros, rep8,
         f[8, 4] & f[8, 1],                      # 17, and nothing else
         f[8, 4] & f[8, 2] & f[4, 1],            # 25 found: only (4, 1)
         f[8, 4] & f[8, 2],
         f[4, 2] & f[4, 1],                      # (4, 1) only after (4, 2)
         f[4, 2],
         f[2, 1],
         f[8, 4]],
        [0, 8, 17, 22, 25, 22, 38, 38, 41], 64)


@pytest.mark.parametrize("b,d", MODES)
def test_mode_tests_match_the_reference(b, d):
    lines = _test_lines(4096, seed=b * 10 + d)
    want, _, _ = bdi._mode_fits(bdi._elems_np(lines, b), d)
    got = _kernel_mode_fits(lines, b, d)
    assert np.array_equal(got, want)
    assert 0.05 < want.mean() < 0.95      # both answers are exercised


@pytest.mark.parametrize("seed", [0, 1])
def test_mode_search_matches_the_reference(seed):
    lines = _test_lines(8192, seed)
    want = R.compress_scan(lines, interpret=True)["bdi"]
    got = _kernel_bdi(lines)
    assert np.array_equal(got, want)
    assert set(got.tolist()) == {0, 8, 17, 22, 25, 38, 41, 64}
    assert np.array_equal(got, bdi.bdi_sizes(lines)[0])


def _edge_lines(rng, b, d, m):
    """m lines of b-byte elements at the edges of d-byte deltas: bases
    at +-lim and the element width's ends, immediates and deltas at
    -lim - 1 .. -lim + 1 and lim - 2 .. lim, the base first, in the
    middle or last."""
    k, lim, half = 64 // b, 1 << (8 * d - 1), 1 << (8 * b - 1)
    edges = np.array([-lim - 1, -lim, -lim + 1, lim - 2, lim - 1, lim, 0,
                      1, -1], dtype=np.int64)
    far = np.array([lim, -lim - 1, lim + 1, half - 1, -half, half - 2],
                   dtype=np.int64)
    base = rng.choice(far, m).astype(np.uint64)
    pos = rng.choice([0, k // 2, k - 1], m)
    e = rng.choice(edges, (m, k)).astype(np.uint64)
    after = np.arange(k)[None, :] > pos[:, None]
    delta = rng.choice(edges, (m, k)).astype(np.uint64)
    e = np.where(after & (rng.random((m, k)) < 0.7), base[:, None] + delta,
                 e)
    e[np.arange(m), pos] = base
    return e.astype(f"<u{b}").view(np.uint8).reshape(m, 64)


PAIRS = [(8, 1, 2), (8, 1, 4), (8, 2, 4), (4, 1, 2)]


def _check_lemma(b, small, large, seed):
    rng = np.random.default_rng(seed)
    lines = np.concatenate([_edge_lines(rng, b, dd, 256)
                            for dd in (small, large)])
    fit_small, _, _ = bdi._mode_fits(bdi._elems_np(lines, b), small)
    fit_large, _, _ = bdi._mode_fits(bdi._elems_np(lines, b), large)
    assert not (fit_small & ~fit_large).any()
    return fit_small.any(), (fit_large & ~fit_small).any()


if given is not None:
    @given(st.sampled_from(PAIRS), st.integers(0, 2 ** 32 - 1))
    def test_lemma_smaller_delta_fit_implies_larger(pair, seed):
        """(B, d') fits => (B, d) fits for d' < d, through the port's
        `bdi._mode_fits` on lines built at the +-2^(8d-1) edges."""
        _check_lemma(*pair, seed)
else:
    def test_lemma_smaller_delta_fit_implies_larger():
        pytest.skip("needs hypothesis")


@pytest.mark.parametrize("b,small,large", PAIRS)
def test_lemma_is_not_vacuous(b, small, large):
    """The lemma's edge lines reach both sides: lines that fit the smaller
    delta and lines that fit only the larger one."""
    reached = [_check_lemma(b, small, large, seed) for seed in range(4)]
    assert any(r[0] for r in reached) and any(r[1] for r in reached)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_pair_fit_matches_int64(d):
    """B = 8 as (hi, lo) words: hi == lo >> 31 and lo fits, against the
    64-bit value's range."""
    lim = 1 << (8 * d - 1)
    vals = [0, 1, -1, 1 << 31, -(1 << 31), (1 << 31) - 1, -(1 << 31) - 1,
            (1 << 32), -(1 << 32), (1 << 63) - 1, -(1 << 63)]
    vals += [s * lim + o for s in (1, -1) for o in (-2, -1, 0, 1)]
    rng = np.random.default_rng(d)
    vals += rng.integers(-(1 << 63), (1 << 63) - 1, 500).tolist()
    v = np.asarray(vals, dtype=np.int64)
    lo = v.astype(np.uint64) & U32
    hi = v.astype(np.uint64) >> np.uint64(32)
    sign = np.where(lo >= 1 << 31, U32, 0).astype(np.uint64)
    lo_fits = _fits(_s32(lo), d) if d < 4 else np.ones(v.shape, bool)
    assert np.array_equal((hi == sign) & lo_fits, _fits(v, d))


def _far_lo(x):
    return ((np.asarray(x, dtype=np.int64) + 0x80) & 0xFF00) != 0


def _far_hi(x):
    return ((np.asarray(x, dtype=np.int64) + 0x800000) & 0xFF000000) != 0


def test_halfword_tests_on_whole_words():
    """B = 2 on whole words: byte 1 of x + 0x80 (low half), byte 3 of
    x + 0x800000 (high half), every halfword under every low half that
    could carry; a delta of zero-extended halfwords, wrapped mod 2^16,
    for every halfword against bases at the edges; the first pair's
    delta (x >> 16) - x."""
    h = np.arange(1 << 16, dtype=np.int64)
    s = ((h ^ 0x8000) - 0x8000)
    immediate = (s >= -128) & (s < 128)
    assert np.array_equal(_far_lo(h), ~immediate)
    for low in (0, 0x7F, 0x80, 0xFF7F, 0xFF80, 0xFFFF):
        assert np.array_equal(_far_hi((h << 16) | low), ~immediate)
    for b in (0, 1, 0x7F, 0x80, 0x7FFF, 0x8000, 0xFF80, 0xFFFF, 0x1234):
        sb = ((b ^ 0x8000) - 0x8000)
        want = ~_fits(_wrap(s - sb, 2), 1)
        assert np.array_equal(_far_lo((h - b) & U32), want)
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 1 << 32, 4000),
                        _edge_words().astype(np.int64)])
    lo = (((x & 0xFFFF) ^ 0x8000) - 0x8000)
    hi = ((((x >> 16) & 0xFFFF) ^ 0x8000) - 0x8000)
    assert np.array_equal(_far_lo(((x >> 16) - x) & U32),
                          ~_fits(_wrap(hi - lo, 2), 1))


def _kernel_far_b2(words):
    """`far_b2`: PRMT 0x7610 takes bytes 0-1 of x + 0x80 and bytes 2-3 of
    x + 0x800000; bit 15 / 31 of ((t & 0x7F007F00) + 0x7F007F00) | t
    flags a nonzero byte; shifted right by 15 - i into bits i and 16 + i."""
    x = np.asarray(words, dtype=np.int64) & U32
    t = (((x + 0x80) & 0xFFFF) | ((x + 0x800000) & 0xFFFF0000)) & U32
    flag = ((((t & 0x7F007F00) + 0x7F007F00) | t) & 0x80008000)
    far = np.zeros(x.shape[0], dtype=np.int64)
    for i in range(x.shape[1]):
        far |= flag[:, i] >> (15 - i)
    return far


def test_halfword_far_mask():
    """The predicate-free mask of non-immediate halfwords, the base's
    halfword from it and the halfword each later bit names."""
    rng = np.random.default_rng(9)
    words = np.concatenate([rng.choice(_edge_words(), (3000, 16)),
                            rng.integers(0, 1 << 32, (1000, 16))])
    far = _kernel_far_b2(words)
    lines = words.astype("<u4").view(np.uint8).reshape(-1, 64)
    want = ~_fits(_elems(lines, 2), 1)                     # (N, 32)
    bit = np.arange(32)
    half = 2 * (bit & 15) + (bit >> 4)                     # bit -> halfword
    got = ((far[:, None] >> bit) & 1).astype(bool)
    assert np.array_equal(got, want[:, half])
    some = want.any(1)
    both = (far | (far >> 16)) & 0xFFFF
    k = np.array([(int(v) & -int(v)).bit_length() - 1 for v in both])
    low = (far >> np.maximum(k, 0)) & 1
    assert np.array_equal((2 * k + 1 - low)[some],
                          np.argmax(want, 1)[some])


def test_marker_il_family_by_addition():
    """classify: il_j = il_0 + j * IL and w == ~il iff w + il ==
    0xFFFFFFFF, against the device Marker-IL words."""
    slots = np.array([0, 1, 2 ** 27 - 1, 2 ** 31 + 5, 12345])
    for key in (0, 0x5EED, 0xDEADBEEF):
        il = T.device_il_words(slots, key).astype(np.int64)
        il0 = ((slots * 16 + 1) * IL_MULT + key) & U32
        j = np.arange(16)
        assert np.array_equal((il0[:, None] + j * IL_MULT) & U32, il)
        inv = (~il) & U32
        assert ((inv + il) & U32 == U32).all()
        assert not (((il ^ 1) + il) & U32 == U32).any()
