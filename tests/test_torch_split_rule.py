"""The split rule of the decode-on-compressed kernels (K3 batched, K6
single-sequence), on the CPU.

Both CUDA wrappers cut a sequence's `n` flat slots into splits of
`split_width(n)` slots, one CTA per (sequence, KV head, split).  These
tests run the wrappers' own argument handling with the library replaced
by a recorder (nothing is built or launched), and check that the splits
cover every slot exactly once, that K6 and K3 with `block_groups=None`
pick the same split for the same `n` (what makes K6 on a sequence equal
K3's row for it bit for bit on the card), that the batch does not move
the split, and that an explicit `block_groups` keeps its meaning.
"""

import math

import pytest
import torch

from repro_torch.kernels import cram_attention as ca
from repro_torch.kernels import cuda_lib

PAGE, HKV, HQ, HD = 1, 1, 2, 64


class _Recorder:
    """Stands in for the bound library: records (entry, n, lanes, kk,
    batch) of each call and reports success."""

    def __init__(self):
        self.calls = []

    def cram_decode_attention(self, *a):
        b, n, lanes, kk = a[6], a[9], a[12], a[13]
        self.calls.append(("batched", n, lanes, kk, b))
        return 0

    def cram_decode_attention_single(self, *a):
        n, lanes, kk = a[7], a[10], a[11]
        self.calls.append(("single", n, lanes, kk, 1))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "load", lambda: rec)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    before = dict(ca.LAUNCHES)
    yield rec
    ca.LAUNCHES.update(before)


def _single(n, lanes):
    q = torch.zeros((HQ, HD), dtype=torch.float32)
    slots = torch.zeros((n, PAGE, HKV, 2 * HD), dtype=torch.int16)
    strips = torch.zeros((n, HKV, 2 * HD + 2), dtype=torch.int16)
    markers = torch.zeros((n,), dtype=torch.int32)
    valid = torch.zeros((n, lanes), dtype=torch.int32)
    return q, slots, strips, markers, valid


def _batched(b, n, lanes, shared=False):
    lead = () if shared else (b,)
    q = torch.zeros((b, HQ, HD), dtype=torch.float32)
    slots = torch.zeros(lead + (n, PAGE, HKV, 2 * HD), dtype=torch.int16)
    strips = torch.zeros(lead + (n, HKV, 2 * HD + 2), dtype=torch.int16)
    markers = torch.zeros((n,), dtype=torch.int32)
    valid = torch.zeros(lead + (n, lanes), dtype=torch.int32)
    pred = torch.zeros(lead + (n // lanes,), dtype=torch.int32)
    return q, slots, strips, markers, valid, pred


def _splits(n, kk):
    return [range(j * kk, min((j + 1) * kk, n))
            for j in range(math.ceil(n / kk))]


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 256), (257, 512)])
def test_split_rule_covers_every_slot_once(recorder, lanes, lo, hi):
    """For n from 1 to 512: the kernel's splits of K6 (any n) and K3 (n a
    multiple of the lanes) cover [0, n) exactly once, in order, with no
    empty split and at most MAX_SPLITS of them."""
    for n in range(lo, hi + 1):
        recorder.calls.clear()
        ca.cram_decode_attention_cuda(*_single(n, lanes), lanes=lanes)
        if n % lanes == 0:
            ca.cram_decode_attention_batched_cuda(*_batched(2, n, lanes),
                                                  lanes=lanes)
        for _, got_n, _, kk, _ in recorder.calls:
            assert got_n == n and kk == ca.split_width(n)
            parts = _splits(n, kk)
            assert 1 <= len(parts) <= ca.MAX_SPLITS
            assert all(len(p) > 0 for p in parts)
            assert [s for p in parts for s in p] == list(range(n))


@pytest.mark.parametrize("lanes", [2, 4])
def test_single_and_batched_pick_the_same_split(recorder, lanes):
    """K6 on one sequence and K3 with block_groups=None take the same split
    width for the same n."""
    for n in range(lanes, 513, lanes):
        recorder.calls.clear()
        ca.cram_decode_attention_cuda(*_single(n, lanes), lanes=lanes)
        ca.cram_decode_attention_batched_cuda(*_batched(3, n, lanes),
                                              lanes=lanes, block_groups=None)
        (k6, *_, kk6, _), (k3, *_, kk3, _) = recorder.calls
        assert (k6, k3) == ("single", "batched")
        assert kk6 == kk3, n


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("lanes", [2, 4])
def test_split_rule_ignores_the_batch(recorder, lanes, shared):
    """The batch (and a shared cache) changes the grid's first axis and
    nothing about the split."""
    for n in (lanes, 16, 36, 256):
        recorder.calls.clear()
        for b in (1, 2, 5, 8):
            ca.cram_decode_attention_batched_cuda(
                *_batched(b, n, lanes, shared), lanes=lanes,
                shared_cache=shared)
        widths = {kk for *_, kk, _ in recorder.calls}
        assert widths == {ca.split_width(n)}
        assert [b for *_, b in recorder.calls] == [1, 2, 5, 8]


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("block_groups", [1, 3, 8])
def test_explicit_block_groups_keep_their_meaning(recorder, lanes,
                                                  block_groups):
    """An explicit block_groups sets K3's split to that many page groups
    (the largest divisor of the group count not above it, as the
    reference resolves it); the launch counter counts each call."""
    name = "decode_attention_pair" if lanes == 2 else "decode_attention_quad"
    for n_groups in (1, 6, 8, 17):
        n = n_groups * lanes
        recorder.calls.clear()
        before = ca.LAUNCHES[name]
        ca.cram_decode_attention_batched_cuda(*_batched(2, n, lanes),
                                              lanes=lanes,
                                              block_groups=block_groups)
        (_, _, _, kk, _), = recorder.calls
        assert kk == ca.resolve_block_groups(n_groups, block_groups) * lanes
        assert ca.LAUNCHES[name] == before + 1


def test_split_width_values():
    widths = [ca.split_width(n) for n in (1, 15, 16, 17, 32, 33, 256, 257)]
    assert widths == [1, 1, 1, 2, 2, 3, 16, 17]
    assert ca.MAX_SPLITS == 16
