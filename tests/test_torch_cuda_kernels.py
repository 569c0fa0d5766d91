"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked `cuda`; without one the
fixture skips it.  On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

K1/K2 (window pack and the registry's group pack), K4/K5 (unpack), K7
(the compressibility scan) and E1 (the trace engine's scan, every carry
tensor, at three SimConfigs, one lane and 3 x 5 lanes, whole and in
chunks of 1 event and of odd lengths) must be bit-exact, and E1 must raise
on an address, a params row or a carry value outside its tables.  K3
(batched decode on the
compressed cache) and K6 (single-sequence decode) must agree within
atol = rtol = 2e-3 (the kernels' online softmax sums in another order and
uses __expf), K3 with its byte output exact, and K6 on a sequence equals
K3's row for it bit for bit when K3 takes its default split.  The shapes
are small and odd on purpose: they cover what the chip_smoke run at the
phi4 geometry does not (head_dim 16, 32, 64 and 80, one query head per KV
head, groups of 8, 9 and 12, one slot block per sequence, a single group,
a ragged last split, one slot, 256 slots, a slot count that is not a
multiple of the lanes, a marker on all KV heads but one, window-pack
groups of one chunk and of several with a ragged last one, a misfit only
the last chunk sees, a 64-group window, a group-pack misfit only the last
CTA of a group's cluster sees, 1,024 groups at the phi4 geometry and
65,539 groups of one vector, an image whose line count is not a multiple
of the kernel's block).

K3's in-place entry (the serve tier's attend on the card, reading the
cache state's leaves) equals the flat entry on `physical_view` of the
same cache bit for bit, output and byte columns, at every head geometry,
pair and quad, on a shared cache, on a state sliced out of a wider one
and on a row shard of that slice, with a zero marker, and with garbage
in packed groups' overflow that never reaches the output; the serve
tier's attend calls it once, opens no span but its repack and K3, and
copies nothing of the cache.

A1 (the model's decode attention, `kernels/gqa_decode.py`, launched by
`models/attention.py:decode_attention_state` and
`chunked_decode_attention` on CUDA tensors) holds its state and output
within 2e-5 of the rms of its plain version run in
float32 on the same inputs (the output also within its dtype's
rounding), over bf16, fp16 and float32, head_dim 8 to 256, groups of 1
to 12, lengths 0, 1, a split's edge, T - 1, T and past T, one split and
many; two halves of a cache combine to the whole; a tiny dense and a
tiny GQA decoder decode the same tokens through it as through the plain
path.

The CPU half at the end runs here too: a wrapper given CPU tensors runs
the plain version and counts no launch, and the CUDA entry refuses a CPU
tensor before it builds anything; tensors with no storage (FakeTensor,
meta) take A1's plain version.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.compression import pagepack
from repro_torch.compression.marker import LineStatus
from repro_torch.compression.predictor import LCT_ENTRIES
from repro_torch.core import engine, schemes, traces
from repro_torch.core.engine import SimConfig
from repro_torch.kernels import bdi_pack
from repro_torch.kernels import compress_scan as cs
from repro_torch.kernels import cram_attention as ca
from repro_torch.kernels import engine_scan as es
from repro_torch.kernels import gqa_decode as gd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import strip_is_packed
from repro_torch.kv import synthetic_kv_stream
from repro_torch.kv.cache import kv_bits
from repro_torch.models import attention

torch.set_num_threads(1)

TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _window(rng, b, w, lanes, page, hkv, hd, device):
    """(B, W, lanes, page, Hkv, 2*hd) int16: sequence 0 compressible,
    sequence 1 incompressible, the rest alternating by group."""
    t = w * lanes * page
    rows = []
    for i in range(b):
        kc, vc = synthetic_kv_stream(rng, 1, t, hkv, hd)
        ki, vi = synthetic_kv_stream(rng, 1, t, hkv, hd, compressible=False)
        if i == 1:
            kc, vc = ki, vi
        elif i > 1:
            span = lanes * page
            for g in range(i % 2, w, 2):
                kc[:, g * span:(g + 1) * span] = ki[:, g * span:(g + 1) * span]
                vc[:, g * span:(g + 1) * span] = vi[:, g * span:(g + 1) * span]
        rows.append(kv_bits(kc[0], vc[0], device))
    return torch.stack(rows).reshape(b, w, lanes, page, hkv, 2 * hd)


def _misfit_last_vector(win, b, w):
    """Push the last element of group (b, w)'s last page out of the
    delta range of its base row: a misfit only the last 16-byte vector of
    the group sees, so only the group's last chunk."""
    base = int(win[b, w, 0, 0, -1, -1])
    win[b, w, -1, -1, -1, -1] = base + 300 if base < 2**14 else base - 300


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("page,hkv,hd,chunks", [(4, 2, 8, 1), (16, 8, 128, 64),
                                                (5, 3, 64, 4)])
def test_pack_window_kernel_bit_exact(cuda, lanes, page, hkv, hd, chunks):
    """One chunk a group, 64 whole chunks, and 4 chunks with a ragged last
    one (48 of 64 vectors); group (0, 1) of the compressible sequence
    misfits in its last chunk only."""
    rng = np.random.default_rng([lanes, page, hkv, hd])
    b, w = 4, 3
    win = _window(rng, b, w, lanes, page, hkv, hd, cuda).contiguous()
    win[3, 1, :, page // 2:] = 0                    # a partial page group
    _misfit_last_vector(win, 0, 1)
    nvec = page * hkv * 2 * hd // 8
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bdi_pack.window_chunks(b * w, nvec, sms)[1] == chunks
    mk = torch.from_numpy(rng.integers(-2**15, 2**15, (w, 2)).astype(
        np.int16)).to(cuda)
    enabled = torch.tensor([True, True, False, True], device=cuda)
    got = bdi_pack.pack_window_cuda(win, mk, enabled)
    torch.cuda.synchronize()
    want = bdi_pack.pack_window_plain(win, mk, enabled)
    for name, g, r in zip(("slots", "over", "strips", "lay", "fit"), got,
                          want, strict=True):
        assert torch.equal(g, r), name
    assert bool(got[4][0, 0]) and not bool(got[4][0, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
def test_pack_window_kernel_64_groups(cuda, lanes):
    """The prefill window (B = 8, W = 8) at the phi4 KV geometry with the
    default chunks; a misfit in the last chunk of one compressible group."""
    rng = np.random.default_rng([lanes, 64])
    b, w, page, hkv, hd = 8, 8, 16, 8, 128
    win = _window(rng, b, w, lanes, page, hkv, hd, cuda).contiguous()
    _misfit_last_vector(win, 0, 5)
    nvec = page * hkv * 2 * hd // 8
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk_vecs, chunks = bdi_pack.window_chunks(b * w, nvec, sms)
    assert chunks > 1 and chunk_vecs * (chunks - 1) < nvec
    mk = torch.from_numpy(rng.integers(-2**15, 2**15, (w, 2)).astype(
        np.int16)).to(cuda)
    enabled = torch.ones(b, dtype=torch.bool, device=cuda)
    enabled[3] = False
    got = bdi_pack.pack_window_cuda(win, mk, enabled)
    torch.cuda.synchronize()
    want = bdi_pack.pack_window_plain(win, mk, enabled)
    for name, g, r in zip(("slots", "over", "strips", "lay", "fit"), got,
                          want, strict=True):
        assert torch.equal(g, r), name
    fit = got[4]
    assert bool(fit[0, 4]) and not bool(fit[0, 5])


def _attention_args(rng, lanes, b, n_groups, page, hkv, hq, hd, device,
                    shared):
    caches = []
    for i in range(1 if shared else b):
        win = _window(rng, 3, n_groups, lanes, page, hkv, hd, device)[i % 3]
        build = (ops.build_cram_cache if lanes == 2
                 else ops.build_cram_cache_quad)
        caches.append(build(win.reshape(-1, page, hkv, 2 * hd)))
    keys = ("slots", "slots_overflow", "strips", "packed_mask")
    cache = ({k: caches[0][k] for k in keys} if shared
             else {k: torch.stack([c[k] for c in caches]) for k in keys})
    cache["markers"] = caches[0]["markers"]
    n_pages = n_groups * lanes
    tokens = rng.integers(1, n_pages * page, 1 if shared else b)
    if not shared:
        tokens[0] = 0                               # a zero-valid lane
    valid = np.clip(tokens[:, None] - np.arange(n_pages)[None] * page, 0,
                    page).astype(np.int32)
    valid = torch.from_numpy(valid[0] if shared else valid).to(device)
    pred = cache["packed_mask"] ^ torch.from_numpy(
        rng.random(tuple(cache["packed_mask"].shape)) < 0.4).to(device)
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    slots, strips, markers, fvalid = pv(cache, valid)
    q = torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(
        np.float32)).to(device)
    return (q, slots.contiguous(), strips.contiguous(), markers.contiguous(),
            fvalid.to(torch.int32).contiguous(),
            pred.to(torch.int32).contiguous())


# (Hkv, Hq, head_dim) the reference computes beyond the phi4 shape: its
# serving tests, its kernel sweep and smoke configs, zamba2_2_7b's head_dim
# and mistral_large_123b's group of 12
REFERENCE_GEOMETRIES = [(1, 1, 16), (1, 4, 32), (32, 32, 80), (8, 96, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("hkv,hq,hd", [(2, 2, 64), (1, 8, 128),
                                       (3, 9, 64)] + REFERENCE_GEOMETRIES)
@pytest.mark.parametrize("block_groups", [1, None, 8])
def test_decode_attention_kernel_matches_plain(cuda, lanes, shared, hkv, hq,
                                               hd, block_groups):
    rng = np.random.default_rng([lanes, shared, hkv, hq, hd])
    args = _attention_args(rng, lanes, 3, 8, 4, hkv, hq, hd, cuda, shared)
    kw = dict(lanes=lanes, block_groups=block_groups, shared_cache=shared)
    out, byts = ca.cram_decode_attention_batched_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref, ref_b = ca.cram_decode_attention_batched_plain(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(byts, ref_b)
    if block_groups is None:
        _k3_and_k6(args, lanes, shared)


def _zero_attention_args(b, n, page, hkv, hq, hd, lanes, device):
    z = dict(dtype=torch.int16, device=device)
    return [torch.zeros((b, hq, hd), dtype=torch.float32, device=device),
            torch.zeros((b, n, page, hkv, 2 * hd), **z),
            torch.zeros((b, n, hkv, 2 * hd + 2), **z),
            torch.zeros((n,), dtype=torch.int32, device=device),
            torch.zeros((b, n, lanes), dtype=torch.int32, device=device),
            torch.zeros((b, n // lanes), dtype=torch.int32, device=device)]


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_cannot_run(cuda):
    rng = np.random.default_rng(0)
    for hd in (12, 136):
        args = _zero_attention_args(2, 4, 4, 1, 4, hd, 2, cuda)
        with pytest.raises(ValueError, match="multiple of 8"):
            ca.cram_decode_attention_batched_cuda(*args, lanes=2)
    args = list(_attention_args(rng, 2, 2, 2, 4, 2, 4, 64, cuda, False))
    args[4] = args[4].to(torch.int64)
    with pytest.raises(ValueError, match="valid must be"):
        ca.cram_decode_attention_batched_cuda(*args, lanes=2)


def _delta_pages(lanes, g, page, hkv, d2, device):
    """`lanes` (g, page, Hkv, D2) int16 pages made on `device` from a
    seeded generator: even groups within the codec's delta range of their
    base row (lane A's token-0 row), odd groups far from it; group 2 (where
    there is one) fits but for the last element of its last lane."""
    gen = torch.Generator(device=device)
    gen.manual_seed(g * 8 + lanes)

    def draw(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device=device,
                             dtype=torch.int16)

    row = draw(3000, (g, 1, hkv, d2))
    far = (torch.arange(g, device=device) % 2 == 1).reshape(-1, 1, 1, 1)
    lim = 128 if lanes == 2 else 8
    pages = [row + torch.where(far, draw(2**14, (g, page, hkv, d2)),
                               draw(lim, (g, page, hkv, d2)))
             for _ in range(lanes)]
    pages[0][:, 0] = row[:, 0]
    if g > 2:
        pages[-1][2, -1, -1, -1] = row[2, 0, -1, -1] + 300
    return pages


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("lead,page,hkv,hd,kv", [
    ((), 4, 2, 8, True), ((1,), 5, 3, 8, True), ((3, 2), 16, 8, 128, True),
    # a misfit only in the last CTA of group 2's cluster of 8
    ((3,), 16, 8, 128, False),
    ((1024,), 16, 8, 128, False),         # the bulk shape's pair groups
    ((65539,), 1, 1, 4, False)])          # more groups than a grid's y
def test_group_pack_and_unpack_kernels_bit_exact(cuda, lanes, lead, page,
                                                 hkv, hd, kv):
    """K1/K2 group pack (deltas written whatever ok says) and K4/K5 unpack
    against `pagepack`, on fitting and non-fitting groups; pack -> unpack
    is the identity where the group fits.  Pages from KV streams, or from
    `_delta_pages` with a group that misfits only at its last element."""
    rng = np.random.default_rng([lanes, page, hkv, hd, len(lead)])
    g = int(np.prod(lead)) if lead else 1
    if kv:
        win = _window(rng, max(g, 2), 1, lanes, page, hkv, hd, cuda)[:g, 0]
        pages = [win[:, j].reshape(*lead, page, hkv, 2 * hd).contiguous()
                 for j in range(lanes)]
    else:
        pages = _delta_pages(lanes, g, page, hkv, 2 * hd, cuda)
    pack = bdi_pack.pack_pair if lanes == 2 else bdi_pack.pack_quad
    unpack = bdi_pack.unpack_pair if lanes == 2 else bdi_pack.unpack_quad
    packed, base, ok = pack(*pages)
    torch.cuda.synchronize()
    plain = pagepack.pack_pair if lanes == 2 else pagepack.pack_quad
    ok_p, packed_p, base_p = plain(*pages)
    assert torch.equal(ok, ok_p) and ok.shape == lead
    assert torch.equal(packed, packed_p) and torch.equal(base, base_p)
    got = unpack(packed, base)
    torch.cuda.synchronize()
    plain_un = pagepack.unpack_pair if lanes == 2 else pagepack.unpack_quad
    for a, b in zip(got, plain_un(packed, base), strict=True):
        assert torch.equal(a, b)
    fit = ok.reshape(-1)
    for a, p in zip(got, pages, strict=True):
        assert torch.equal(a.reshape(g, -1)[fit], p.reshape(g, -1)[fit])
    if g > 1:
        assert bool(fit.any()) and not bool(fit.all())
    if not kv:
        assert bool(fit[0]) and not bool(fit[1]) and not bool(fit[2])


def _scan_image(rng, n, key):
    lines = rng.integers(0, 256, (n, 64)).astype(np.uint8)
    lines[0::5] = 0
    lines[1::5] = np.tile(rng.integers(0, 256, 8).astype(np.uint8), 8)
    k = len(lines[2::5])
    lines[2::5] = (2**40 + rng.integers(-300, 300, (k, 8))).astype(
        "<i8").view(np.uint8).reshape(k, 64)
    k = len(lines[3::5])
    lines[3::5] = rng.integers(-100, 100, (k, 16)).astype(
        "<i4").view(np.uint8).reshape(k, 64)
    slots = np.unique(np.linspace(0, n - 1, 6).astype(np.int64))
    m2, m4 = cs.device_markers(slots, key)
    il = cs.device_il_words(slots, key)
    for i, s in enumerate(slots):
        if i % 6 == 0:
            lines[s, -4:] = np.frombuffer(m2[i].tobytes(), np.uint8)
        elif i % 6 == 1:
            lines[s, -4:] = np.frombuffer(m4[i].tobytes(), np.uint8)
        elif i % 6 == 2:
            lines[s] = il[i].astype("<u4").view(np.uint8)
        elif i % 6 == 3:
            lines[s, -4:] = np.frombuffer((~m2[i]).tobytes(), np.uint8)
        elif i % 6 == 4:
            lines[s] = (~il[i]).astype("<u4").view(np.uint8)
        else:
            lines[s, -4:] = np.frombuffer((~m4[i]).tobytes(), np.uint8)
    return lines


def _boundary_image(rng, n, key):
    """`chip_smoke.boundary_image`: lines at the edges of K7's rules, kinds
    shuffled across every warp."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.boundary_image(rng, n, key)


@pytest.mark.cuda
@pytest.mark.parametrize("image", ["families", "boundary"])
@pytest.mark.parametrize("n", [1, 255, 257, 4097])
@pytest.mark.parametrize("key", [0x5EED, 0xDEADBEEF])
def test_compress_scan_kernel_bit_exact(cuda, n, key, image):
    rng = np.random.default_rng([n, key])
    if image == "families":
        lines = _scan_image(rng, n, key)
    else:
        lines = _boundary_image(rng, n, key)
    img = torch.from_numpy(lines).to(cuda)
    got = cs.compress_scan(img, key=key)
    torch.cuda.synchronize()
    want = cs.compress_scan_plain(img, key=key)
    for name in ("sizes", "fpc", "bdi", "status"):
        assert got[name].device == img.device
        assert torch.equal(got[name], want[name]), name
    assert np.array_equal(got["status"].cpu().numpy(),
                          cs.classify_image_ref(lines, key))
    if n >= 6 and image == "families":
        assert set(got["status"].tolist()) == {int(s) for s in LineStatus}


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("hkv,hq,hd", [(2, 2, 64), (1, 8, 128), (3, 9, 64)]
                         + REFERENCE_GEOMETRIES)
@pytest.mark.parametrize("cut", [0, 1, 3])
def test_single_decode_kernel_matches_plain(cuda, lanes, hkv, hq, hd, cut):
    """K6 over one sequence's physical view, cut to n % lanes != 0; the
    sequence of index 0 has no valid token.  (K6 equal to K3's row at
    these geometries: `test_decode_attention_kernel_matches_plain`.)"""
    rng = np.random.default_rng([lanes, hkv, hq, hd, cut])
    q, slots, strips, markers, valid, _ = _attention_args(
        rng, lanes, 3, 5, 4, hkv, hq, hd, cuda, False)
    n = slots.shape[1] - cut
    for i in range(3):
        args = [x[:n].contiguous() for x in (slots[i], strips[i], markers,
                                             valid[i])]
        out = ca.cram_decode_attention_cuda(q[i].contiguous(), *args,
                                            lanes=lanes)
        torch.cuda.synchronize()
        ref = ca.cram_decode_attention_plain(q[i], *args, lanes=lanes)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, **TOL)


def _k3_and_k6(args, lanes, shared=False):
    """K3 with block_groups=None against its plain version (bytes exact),
    and K6 on each sequence against its plain version and, bit for bit,
    against K3's row for that sequence."""
    kw = dict(lanes=lanes, shared_cache=shared)
    out, byts = ca.cram_decode_attention_batched_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref, ref_b = ca.cram_decode_attention_batched_plain(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(byts, ref_b)
    q, slots, strips, markers, valid, _ = args
    for i in range(q.shape[0]):
        one = [x if shared else x[i] for x in (slots, strips, valid)]
        got = ca.cram_decode_attention_cuda(q[i].contiguous(), one[0], one[1],
                                            markers, one[2], lanes=lanes)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ca.cram_decode_attention_plain(
            q[i], one[0], one[1], markers, one[2], lanes=lanes), **TOL)
        assert torch.equal(got, out[i]), f"K6 differs from K3's row {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n_groups,page,hkv,hq,hd", [
    (17, 16, 8, 24, 128),      # ragged last split (34 / 68 flat slots)
    (1, 16, 8, 24, 128),       # one group: a single split per head
    (19, 5, 3, 9, 64)])        # odd page and heads, ragged (38 / 76)
def test_decode_kernels_ragged_splits_and_k6_equals_k3(cuda, lanes, shared,
                                                       n_groups, page, hkv,
                                                       hq, hd):
    rng = np.random.default_rng([lanes, shared, n_groups, page, hkv])
    args = _attention_args(rng, lanes, 3, n_groups, page, hkv, hq, hd, cuda,
                           shared)
    n = args[1].shape[-4]
    if n_groups > 1:
        assert n % ca.split_width(n) != 0          # the last split is ragged
    _k3_and_k6(args, lanes, shared)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
def test_decode_kernels_long_sequence(cuda, lanes):
    """256 flat slots (16 full splits) at page 16, head_dim 128."""
    rng = np.random.default_rng([lanes, 256])
    args = _attention_args(rng, lanes, 2, 256 // lanes, 16, 2, 6, 128, cuda,
                           False)
    assert args[1].shape[1] == 256
    _k3_and_k6(args, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_single_decode_kernel_one_slot(cuda, lanes, hd):
    rng = np.random.default_rng([lanes, hd, 1])
    q, slots, strips, markers, valid, _ = _attention_args(
        rng, lanes, 2, 2, 16, 2, 8, hd, cuda, False)
    for i in range(2):
        args = [x[:1].contiguous() for x in (slots[i], strips[i], markers,
                                             valid[i])]
        out = ca.cram_decode_attention_cuda(q[i].contiguous(), *args,
                                            lanes=lanes)
        torch.cuda.synchronize()
        ref = ca.cram_decode_attention_plain(q[i], *args, lanes=lanes)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
def test_decode_kernels_marker_on_all_but_one_head_reads_raw(cuda, lanes):
    """A raw slot whose strip tails carry its marker on every KV head but
    one must still be read as raw, by K3 and K6 alike: in sequence 0 (no
    valid token) and in sequence 2, whose every position is made valid."""
    rng = np.random.default_rng([lanes, 7])
    q, slots, strips, markers, valid, pred = _attention_args(
        rng, lanes, 3, 4, 16, 4, 8, 128, cuda, False)
    packed = strip_is_packed(strips, markers)
    strips = strips.clone()
    for i in (0, 2):
        s = int(torch.nonzero(~packed[i])[0])
        m = int(markers[s]) & 0xFFFFFFFF
        lo, hi = (x - 0x10000 if x >= 0x8000 else x
                  for x in (m & 0xFFFF, m >> 16))
        strips[i, s, :3, -2] = lo                  # heads 0-2 of 4
        strips[i, s, :3, -1] = hi
        assert bool(strip_is_packed(strips[i, s, :3][None],
                                    markers[s:s + 1]).all())
    assert torch.equal(strip_is_packed(strips, markers), packed)
    valid = valid.clone()
    valid[2] = 16
    _k3_and_k6((q, slots, strips.contiguous(), markers, valid, pred), lanes)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_cannot_run(cuda):
    img = torch.zeros((8 * 64 + 1,), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        cs.compress_scan_cuda(img[1:].view(8, 64))
    rng = np.random.default_rng(0)
    q, slots, strips, markers, valid, _ = _zero_attention_args(
        1, 2, 4, 1, 4, 12, 2, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        ca.cram_decode_attention_cuda(q[0].contiguous(), slots[0], strips[0],
                                      markers, valid[0], lanes=2)
    packed = torch.zeros((2, 4, 2, 12), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        bdi_pack.unpack_pair(packed, packed[:, 0])


@pytest.mark.cuda
def test_train_cell_on_one_nccl_rank_matches_the_unsharded_step(cuda):
    """lm2m's train cell, built by `build_cell` and placed from a seed on
    a (1, 1) mesh of one NCCL rank, takes three steps equal to
    `make_train_step` on the same weights (loss and every parameter
    within 1e-5: on one rank DTensor moves nothing)."""
    import datetime
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, place_cell
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import ShapeSpec, build
    from repro_torch.optim.adamw import adamw_init, make_train_step

    cfg = PRESETS["lm2m"]
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(device_type="cuda")
        fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", 64, 4, "train"),
                                          mesh)
        state, pb = place_cell(fn, specs, shards, (batch,), seed=2,
                               device=cuda)
        losses = []
        for _ in range(3):
            state, m = fn(state, pb)
            losses.append(float(m["loss"]))
        got = {k: p.detach().full_tensor() for k, p in state.params.items()}
    finally:
        dist.destroy_process_group()
    model = build(cfg, device=cuda, seed=2)
    st, step = adamw_init(model), make_train_step(model)
    tb = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    want = []
    for _ in range(3):
        st, m = step(st, tb)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
    for k, p in st.params.items():
        torch.testing.assert_close(got[k], p.detach(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ E1: the engine scan

E1_CONFIGS = {
    "default": {},
    "second": dict(llc_sets=64, llc_ways=4, meta_sets=32,
                   compress_clean=False),
    "small": dict(llc_sets=16, llc_ways=2, n_groups=512),
    # more ways than a warp has threads: a thread searches several
    "wide_llc": dict(llc_sets=4, llc_ways=40, n_groups=512),
    "wide_meta": dict(llc_sets=16, llc_ways=2, n_groups=512, meta_sets=2,
                      meta_ways=40, groups_per_meta=4),
}


CARRY_NAMES = ("tag", "lru", "valid", "dirty", "pf", "mem_state", "lct",
               "mtag", "mlru", "mdirty", "mclock", "counter", "clock",
               "stats")


def _e1_inputs(rng, cfg, n_s, n_w, t):
    """Seeded random (flags, params) rows and traces over `cfg`'s groups
    (every trace reaches the last group)."""
    flags = (rng.random((n_s, engine.N_FLAGS)) < 0.5).astype(np.int32)
    params = np.zeros((n_s, engine.N_PARAMS), np.int32)
    params[:, engine.PARAM_LCT_SIZE] = rng.choice([1, 64, 512], n_s)
    params[:, engine.PARAM_SAMPLE_THRESH] = rng.integers(0, 1025, n_s)
    params[:, engine.PARAM_COUNTER_INIT] = rng.integers(0, 4096, n_s)
    params[:, engine.PARAM_META_SETS] = rng.integers(1, cfg.meta_sets + 1,
                                                     n_s)
    addrs = rng.integers(0, 4 * cfg.n_groups, (n_w, t)).astype(np.int32)
    addrs[:, -1] = 4 * cfg.n_groups - 1
    trace = (addrs, rng.random((n_w, t)) < 0.4,
             *(rng.random((n_w, cfg.n_groups)) < p for p in (0.6, 0.6, 0.3)))
    return flags, params, trace


def _e1_run(cfg, flags, params, trace, device, chunks=None):
    eng = engine.build_engine(cfg)
    a, w, pab, pcd, pq = engine.trace_tensors(cfg, *trace, device)
    fl = torch.as_tensor(flags, device=device)
    pr = torch.as_tensor(params, device=device)
    carry = eng.init_state(pr, a.shape[0], device=device)
    bounds = [0, *(chunks or []), a.shape[1]]
    for lo, hi in zip(bounds[:-1], bounds[1:], strict=True):
        eng.run_chunk(carry, fl, pr, a[:, lo:hi], w[:, lo:hi], pab, pcd, pq)
    mtag, mlru, mdirty, mclock = carry[7]
    return [x.cpu() for x in (*carry[:7], mtag, mlru, mdirty, mclock,
                              *carry[8:])]


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(E1_CONFIGS))
@pytest.mark.parametrize("n_s,n_w,t,chunks", [
    (1, 1, 1500, None),                 # one lane, one launch
    (3, 5, 700, [1, 2, 351, 699]),      # 15 lanes; chunks of 1, 1, 349, 348, 1
])
def test_engine_scan_kernel_equals_plain(cuda, config, n_s, n_w, t, chunks):
    """E1, whole or in chunks, leaves every carry tensor equal to the plain
    version's single run on the same inputs, one launch per chunk."""
    cfg = SimConfig(**E1_CONFIGS[config])
    rng = np.random.default_rng(n_s * 100 + n_w)
    flags, params, trace = _e1_inputs(rng, cfg, n_s, n_w, t)
    want = _e1_run(cfg, flags, params, trace, torch.device("cpu"))
    before = es.LAUNCHES["engine_scan"]
    got = _e1_run(cfg, flags, params, trace, cuda, chunks)
    torch.cuda.synchronize()
    assert es.LAUNCHES["engine_scan"] - before == len(chunks or []) + 1
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_engine_scan_kernel_refuses_what_it_cannot_run(cuda):
    cfg = SimConfig(llc_sets=4096, llc_ways=4)
    carry = engine.build_engine(cfg).init_state(np.zeros((1, 4), np.int32),
                                         device=cuda)
    z = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    fit = torch.zeros((1, cfg.n_groups), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        engine.build_engine(cfg).run_chunk(carry, torch.zeros((1, 7)), z, z,
                                    z.bool(), fit, fit, fit)
    assert es.smem_bytes(4096, 4, 64, 8, 512, 3) > es.SMEM_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("fault,match", [
    ("address", "trace address"), ("negative", "trace address"),
    ("lct_size", "params row"), ("meta_sets", "params row"),
    ("carry", "carry holds"),
])
def test_engine_scan_kernel_refuses_bad_indices(cuda, fault, match):
    """An address outside the lanes' groups, a params row beyond what the
    carry holds, or a carry value outside the tables makes E1 set its
    refusal flag instead of writing outside a lane's slice: the launch
    does not wait, and the entry that reads the flags (`run_trace`, or
    `raise_refused` after `run_chunk`) raises; the neighbour lane's
    mem_state is left as the plain version leaves it."""
    cfg = SimConfig(**E1_CONFIGS["small"])
    rng = np.random.default_rng(7)
    flags, params, trace = _e1_inputs(rng, cfg, 2, 1, 300)
    eng = engine.build_engine(cfg)
    a, w, pab, pcd, pq = engine.trace_tensors(cfg, *trace, cuda)
    pr = torch.as_tensor(params, device=cuda)
    carry = eng.init_state(pr, 1, device=cuda)
    if fault == "address":
        a[0, 150] = 4 * cfg.n_groups
    elif fault == "negative":
        a[0, 150] = -4
    elif fault == "lct_size":
        pr[1, engine.PARAM_LCT_SIZE] = LCT_ENTRIES + 1
    elif fault == "meta_sets":
        pr[0, engine.PARAM_META_SETS] = 0
    else:
        carry[5][1, 0, int(a[0, 0]) >> 2] = es.MEM_STATES
    fl = torch.as_tensor(flags, device=cuda)
    if fault != "carry":
        with pytest.raises(ValueError, match=match):
            engine.run_trace(cfg, fl, pr, a, w, pab, pcd, pq, device=cuda)
    carry, err = eng.run_chunk(carry, fl, pr, a, w, pab, pcd, pq)
    with pytest.raises(ValueError, match=match):
        engine.raise_refused([err])
    torch.cuda.synchronize()
    if fault == "address":
        want = eng.init_state(params, 1, device="cpu")
        es.engine_scan_plain(want, torch.as_tensor(flags), torch.as_tensor(
            params), torch.as_tensor(trace[0][:, :150]), torch.as_tensor(
            trace[1][:, :150]), *(torch.as_tensor(x) for x in trace[2:]),
            engine.device_tables(cfg, torch.device("cpu")),
            engine.engine_consts(cfg))
        for g, r in zip(carry[:7], want[:7], strict=True):
            assert torch.equal(g.cpu(), r)


def _e1_rows(cfg, device):
    rows = schemes.names()
    return (torch.as_tensor(schemes.flags_matrix(rows), device=device),
            torch.as_tensor(schemes.params_matrix(rows, cfg), device=device))


def _refetch_trace(gap, offset, t=200):
    """A one-way, one-set LLC's trace over groups 5 (A) and 9 (B): A from
    event `offset`, B evicts A at `offset + 1` (A's mem_state changes:
    its fit bits say it packs), B hits until A misses again `gap` events
    after its eviction, which evicts B; B misses right after, and the
    pattern repeats to the end.  E1 fetched A's mem_state a batch of 32
    events ahead: a stale fetch changes the stats."""
    rng = np.random.default_rng(gap * 100 + offset)
    groups = np.full(t, 9)
    e = offset
    groups[:e + 1] = 5
    while e + 2 + gap < t:
        groups[e + 1:e + 1 + gap] = 9       # B: evicts A, then hits
        groups[e + 1 + gap] = 5             # A again, `gap` events later
        e += 1 + gap
    addrs = 4 * groups + rng.integers(0, 4, t)
    return addrs.astype(np.int32), rng.random(t) < 0.5


@pytest.mark.cuda
def test_engine_scan_kernel_refetch_after_eviction(cuda):
    """A group evicted and missed again 1, 2, 31, 32, 33 and 63 events
    later, the eviction at every offset of a batch from its first event
    to its last: E1 equals the plain version on every carry tensor, for
    all 10 registry rows, in one launch."""
    cfg = SimConfig(llc_sets=1, llc_ways=1, n_groups=512)
    gaps, offsets = (1, 2, 31, 32, 33, 63), (0, 1, 15, 30, 31)
    traces = [_refetch_trace(g, o) for g in gaps for o in offsets]
    fits = np.zeros((len(traces), cfg.n_groups), bool)
    fits[:, 5] = True
    trace = (np.stack([a for a, _ in traces]),
             np.stack([w for _, w in traces]), fits, fits, fits)
    flags, params = _e1_rows(cfg, "cpu")
    want = _e1_run(cfg, flags, params, trace, torch.device("cpu"))
    got = _e1_run(cfg, flags.to(cuda), params.to(cuda), trace, cuda)
    torch.cuda.synchronize()
    assert int(want[5].ne(0).sum()) > 0      # A's mem_state did change
    for name, g, w in zip(CARRY_NAMES, got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_engine_scan_kernel_second_chunk_starts_full(cuda):
    """A chunked run whose second chunk starts with every LLC way holding
    a group (E1 fills each way's shadow from mem_state and the fit bits
    at launch): equal to the plain version's single run."""
    cfg = SimConfig(llc_sets=16, llc_ways=4)
    built = [traces.build_workload(n, 1500, 0)
             for n in ("libq", "pr_twi", "mix3")]
    trace = tuple(np.stack([b[i] for b in built]) for i in range(1, 6))
    flags, params = _e1_rows(cfg, "cpu")
    head = _e1_run(cfg, flags, params, tuple(
        x[:, :700] if k < 2 else x for k, x in enumerate(trace)),
        torch.device("cpu"))
    assert bool(head[0].ne(0).all())          # every way of every lane
    want = _e1_run(cfg, flags, params, trace, torch.device("cpu"))
    got = _e1_run(cfg, flags.to(cuda), params.to(cuda), trace, cuda, [700])
    torch.cuda.synchronize()
    for name, g, w in zip(CARRY_NAMES, got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_engine_scan_kernel_group_held_in_two_ways(cuda):
    """A carry the engine never makes: one group in both ways of its set.
    Its first eviction changes its mem_state, so the copy left behind no
    longer matches its shadow; E1 then reads the victim's state from
    mem_state, and equals the plain version on every carry tensor."""
    cfg = SimConfig(**E1_CONFIGS["small"])           # 16 sets x 2 ways
    x = 3                                            # groups 3, 19, 35: set 3
    trace = (np.array([[4 * (x + 16), 4 * (x + 32), 4 * x + 1,
                        4 * (x + 16) + 2]], np.int32),
             np.array([[True, False, True, False]]),
             *(np.ones((1, cfg.n_groups), bool) for _ in range(3)))
    flags, params = _e1_rows(cfg, "cpu")
    out = []
    for dev in (torch.device("cpu"), cuda):
        eng = engine.build_engine(cfg)
        pr = params.to(dev)
        carry = eng.init_state(pr, 1, device=dev)
        carry[0][:, 0, x] = x + 1
        carry[1][:, 0, x] = torch.tensor([1, 2], device=dev)
        carry[2][:, 0, x] = 15
        carry[3][:, 0, x] = 1
        carry[9][:] = 10
        eng.run_chunk(carry, flags.to(dev), pr,
                      *engine.trace_tensors(cfg, *trace, dev))
        mtag, mlru, mdirty, mclock = carry[7]
        out.append([t.cpu() for t in (*carry[:7], mtag, mlru, mdirty,
                                      mclock, *carry[8:])])
    want, got = out
    assert int(want[5][:, 0, x].ne(0).sum()) > 0
    for name, g, w in zip(CARRY_NAMES, got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_engine_scan_refusal_flags_are_per_launch(cuda):
    """Two sweeps in flight on two streams, one with a refused address:
    each launch writes its own flags, so only that one raises, and the
    other's stats are exact."""
    cfg = SimConfig(**E1_CONFIGS["small"])
    flags, params, trace = _e1_inputs(np.random.default_rng(9), cfg, 3, 2,
                                      600)
    want = _e1_run(cfg, flags, params, trace, torch.device("cpu"))[-1]
    good = engine.trace_tensors(cfg, *trace, cuda)
    bad = tuple(x.clone() for x in good)
    bad[0][1, 300] = 4 * cfg.n_groups
    runs = []
    for tr in (bad, good):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            runs.append(engine.launch_trace(cfg, flags, params, *tr,
                                            device=cuda))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="trace address"):
        engine.fetch_checked(runs[0][0][-1], [runs[0][1]])
    assert np.array_equal(engine.fetch_checked(runs[1][0][-1], [runs[1][1]]),
                          want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_sharded_sweep_on_one_card(cuda, k):
    """The workload axis in k shards on one card (a device list naming it
    k times): one E1 launch a shard, stats equal to the one-launch
    sweep; a refused address in one shard raises."""
    from repro_torch.core import batchsim

    names = ("libq", "pr_twi", "mix3", "mcf17", "lbm17", "soplex")
    trace = tuple(np.stack([b[i] for b in (
        traces.build_workload(n, 1500, 0) for n in names)])
        for i in range(1, 6))
    rows = schemes.names()
    one = batchsim.sweep(rows, *trace, device=cuda, shard=False)
    before = es.LAUNCHES["engine_scan"]
    got = batchsim.sweep(rows, *trace, device=cuda, devices=[cuda] * k)
    assert es.LAUNCHES["engine_scan"] - before == k
    assert np.array_equal(got, one)
    want = batchsim.sweep(rows, *(x[:2] for x in trace), device="cpu")
    assert np.array_equal(one[:, :2], want)
    bad = torch.as_tensor(trace[0], device=cuda).clone()
    bad[-1, 7] = -1
    with pytest.raises(ValueError, match="trace address"):
        batchsim.sweep(rows, bad, *trace[1:], device=cuda,
                       devices=[cuda] * k)


@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["pair", "quad"])
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_attend_on_one_card(cuda, packing, k):
    """Slot shards on one card (a device list naming it k times): one K3
    launch a shard, bit-identical to one launch over every slot, and
    within the kernels' tolerance of the plain version on the CPU."""
    from repro_torch.serving import ServeLoop
    from repro_torch.serving.shard import shard_kv_attend

    out = {}
    for dev in (torch.device("cpu"), cuda):
        loop = ServeLoop(device=dev, slots=8, max_pages=4, page=8, n_kv=1,
                         head_dim=16, policy="static", packing=packing)
        rng = np.random.default_rng(k)
        for sid in range(8):
            kk, vv = synthetic_kv_stream(rng, 1, 5 + 7 * (sid % 4), 1, 16,
                                         compressible=sid % 3 != 2)
            loop.prefill(sid, kk[0], vv[0])
        q = torch.from_numpy(rng.standard_normal((8, 2, 16)).astype(
            np.float32)).to(dev)
        out[dev.type] = (loop, q)
    loop, q = out["cuda"]
    key = "decode_attention_pair" if packing == "pair" else \
        "decode_attention_quad"
    single = shard_kv_attend(loop.cache, q, shard=False)
    before = ca.LAUNCHES[key]
    got = shard_kv_attend(loop.cache, q, devices=[cuda] * k)
    assert ca.LAUNCHES[key] - before == k
    assert torch.equal(got, single)
    cpu_loop, cpu_q = out["cpu"]
    want = shard_kv_attend(cpu_loop.cache, cpu_q, shard=False)
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("column,value", [("wb_dirty", 8), ("new_state", -1)])
def test_engine_scan_kernel_refuses_an_unpackable_evict_table(cuda, column,
                                                              value):
    """The wrapper packs the eviction table 3 bits a column and refuses a
    table that does not fit, before it launches."""
    cfg = SimConfig(**E1_CONFIGS["small"])
    flags, params, trace = _e1_inputs(np.random.default_rng(3), cfg, 1, 1,
                                      50)
    eng = engine.build_engine(cfg)
    a, w, pab, pcd, pq = engine.trace_tensors(cfg, *trace, cuda)
    pr = torch.as_tensor(params, device=cuda)
    carry = eng.init_state(pr, 1, device=cuda)
    tables = dict(engine.device_tables(cfg, cuda))
    tables[column] = tables[column].clone()
    tables[column][11] = value
    before = es.LAUNCHES["engine_scan"]
    with pytest.raises(ValueError, match=f"column {column}"):
        es.engine_scan_cuda(carry, torch.as_tensor(flags, device=cuda), pr,
                            a, w, pab, pcd, pq, tables,
                            engine.engine_consts(cfg))
    assert es.LAUNCHES["engine_scan"] == before


# ----------------------------------------- A1: the model's decode attention

GQA_DTYPES = [torch.bfloat16, torch.float16, torch.float32]
# float32 sums in another order, exp2 by ex2.approx (2^-22 relative) and q
# scaled in float32 where the plain version scales it in q's dtype: the
# state and the normalised output within 2e-5 of the rms of what they are
# compared with, in every input dtype, since the kernel computes in float32
# from the inputs' exact float32 values
GQA_TOL = 2e-5
# the output rounded to its dtype: half an ulp of the largest value
GQA_ROUND = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
             torch.float32: 0.0}


def _gqa_inputs(b, t, hkv, g, hd, dtype, device, seed=0, q_dtype=None):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, hkv * g, hd), generator=gen)
    k = torch.randn((b, t, hkv, hd), generator=gen)
    v = torch.randn((b, t, hkv, hd), generator=gen)
    return (q.to(device=device, dtype=q_dtype or dtype),
            k.to(device=device, dtype=dtype), v.to(device=device, dtype=dtype))


def _gqa_plain32(q, k, v, length):
    """The plain version in float32 on the same inputs (one chunk)."""
    f = torch.float32
    return attention.decode_attention_state_plain(q.to(f), k.to(f), v.to(f),
                                                  length, k.shape[1])


def _rel(got, want) -> float:
    scale = want.to(torch.float32).pow(2).mean().sqrt().clamp_min(1e-30)
    return float((got.to(torch.float32) - want.to(torch.float32)).abs().max()
                 / scale)


def _check_gqa(q, k, v, length):
    torch.backends.cuda.matmul.allow_tf32 = False
    m, l, o = attention.decode_attention_state(q, k, v, length)
    out = attention.chunked_decode_attention(q, k, v, length)
    assert out.dtype == q.dtype and out.shape == q.shape
    if length <= 0:
        assert bool((m == -1e30).all()) and not l.any() and not o.any()
        assert not out.any()
        return
    pm, pl, po = _gqa_plain32(q, k, v, length)
    assert _rel(m, pm) <= GQA_TOL, (length, _rel(m, pm))
    assert _rel(l, pl) <= GQA_TOL, (length, _rel(l, pl))
    assert _rel(o, po) <= GQA_TOL, (length, _rel(o, po))
    want = po / pl[..., None]
    err = float((out.to(torch.float32) - want).abs().max())
    limit = (GQA_ROUND[q.dtype] * float(want.abs().max())
             + GQA_TOL * float(want.pow(2).mean().sqrt()))
    assert err <= limit, (length, err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GQA_DTYPES)
@pytest.mark.parametrize("hd", [8, 64, 80, 128, 256])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
def test_gqa_decode_kernel_matches_plain(cuda, dtype, hd, g):
    """Many splits of a cache whose length is not a multiple of the split
    width: lengths 0, 1, a split's edge and one past it, T - 1, T and
    beyond T (clamped)."""
    b, t, hkv = 3, 1000, 2
    width, splits = gd.split_geometry(b, hkv, hkv * g, t)
    assert splits > 1 and t % width
    q, k, v = _gqa_inputs(b, t, hkv, g, hd, dtype, cuda, seed=hd + g)
    for length in (0, 1, width, width + 1, t - 1, t, t + 5):
        _check_gqa(q, k, v, length)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GQA_DTYPES)
@pytest.mark.parametrize("g,hd", [(1, 128), (3, 64), (12, 80)])
def test_gqa_decode_kernel_one_split(cuda, dtype, g, hd):
    """B x Hkv past the launch's CTA target: one split, no merge; a head
    group of 12 runs in two chunks of query heads."""
    b, t, hkv = 4300, 100, 1
    assert gd.split_geometry(b, hkv, hkv * g, t)[1] == 1
    q, k, v = _gqa_inputs(b, t, hkv, g, hd, dtype, cuda)
    for length in (0, 1, 63, 99, 100):
        _check_gqa(q, k, v, length)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.bfloat16)])
def test_gqa_decode_kernel_mixed_dtypes(cuda, q_dtype, kv_dtype):
    """q and K/V of different types (whisper's float32 cross K/V under a
    bf16 config); a q with strides of its own (a slice of a wider row)."""
    q, k, v = _gqa_inputs(5, 300, 4, 3, 64, kv_dtype, cuda,
                          q_dtype=q_dtype)
    _check_gqa(q, k, v, 217)
    wide = torch.zeros((5, 12, 128), dtype=q_dtype, device=cuda)
    wide[..., 32:96] = q
    _check_gqa(wide[..., 32:96], k, v, 217)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 150, 299, 300, 450, 600])
def test_gqa_decode_halves_combine_to_the_whole(cuda, length):
    """The states of the two halves of a cache, combined as
    `decode_on_shards` combines them (a max and two weighted sums), equal
    the kernel over the whole cache; a half with no valid position weighs
    nothing."""
    q, k, v = _gqa_inputs(4, 600, 2, 4, 128, torch.bfloat16, cuda)
    half = 300
    states = [attention.decode_attention_state(
        q, k[:, sl].contiguous(), v[:, sl].contiguous(), length - off)
        for sl, off in ((slice(0, half), 0), (slice(half, None), half))]
    top = torch.maximum(states[0][0], states[1][0])
    w = [torch.exp(s[0] - top) for s in states]
    l = sum(s[1] * wi for s, wi in zip(states, w, strict=True))
    o = sum(s[2] * wi[..., None] for s, wi in zip(states, w, strict=True))
    m_all, l_all, o_all = attention.decode_attention_state(q, k, v, length)
    assert _rel(top, m_all) <= GQA_TOL
    assert _rel(l, l_all) <= GQA_TOL
    assert _rel(o / l[..., None], o_all / l_all[..., None]) <= GQA_TOL


@pytest.mark.cuda
def test_gqa_decode_kernel_refuses_what_it_cannot_run(cuda):
    before = dict(gd.LAUNCHES)
    q, k, v = _gqa_inputs(2, 64, 2, 2, 16, torch.bfloat16, cuda)
    odd = _gqa_inputs(2, 64, 2, 2, 12, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.decode_attention_state(*odd, 10)
    wide = _gqa_inputs(1, 8, 1, 1, 264, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
        attention.chunked_decode_attention(*wide, 4)
    kt = k.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        attention.decode_attention_state(q, kt, v, 10)
    with pytest.raises(ValueError, match="Python int"):
        attention.decode_attention_state(q, k, v, torch.tensor(10))
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.chunked_decode_attention(q, k.cpu(), v.cpu(), 10)
    with pytest.raises(ValueError, match="whole number of groups"):
        attention.decode_attention_state(q[:, :3].contiguous(), k, v, 10)
    with pytest.raises(ValueError, match="dtype"):
        attention.decode_attention_state(q, k, v.to(torch.float16), 10)
    assert gd.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_kv_heads", [4, 1])
def test_decode_steps_through_the_kernel_equal_the_plain_path(cuda,
                                                              monkeypatch,
                                                              n_kv_heads):
    """A tiny dense decoder (4 query heads over 4 KV heads) and a tiny GQA
    one (over 1) decode 12 greedy steps on the card through the kernel and
    through the plain chunk loop: the same tokens, the logits within
    1e-4."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build

    cfg = dataclasses.replace(configs.get_smoke("phi4_mini_3_8b"),
                              n_kv_heads=n_kv_heads)
    model = build(cfg, device=cuda, seed=0)
    tok0 = torch.tensor([[3], [11], [7]], device=cuda)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(attention, "_on_card", lambda q: False)
        cache = model.init_cache(3, 64)
        tok, toks, logits = tok0, [], []
        launches = gd.LAUNCHES["gqa_decode"]
        for i in range(12):
            out = model.decode_step(tok, cache, i)
            tok = torch.argmax(out, -1, keepdim=True)
            toks.append(tok)
            logits.append(out)
        launched = gd.LAUNCHES["gqa_decode"] - launches
        assert launched == (0 if plain else 12 * cfg.n_layers)
        runs.append((torch.cat(toks, 1), torch.stack(logits)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.allclose(runs[0][1], runs[1][1], atol=1e-4, rtol=1e-4)


# ------------------------------------- K3 in place: the cache's own leaves

def _leaf_state(rng, lanes, b, n_state, page, hkv, hd, device):
    """A serve-tier state of `b` rows of `n_state` groups (compressible,
    incompressible and mixed rows, as `_window`), whose packed groups'
    overflow holds non-zero garbage: finite bf16 up to ~1e38 of either
    sign (the plain version, which decodes every slot, multiplies masked
    V by 0, and 0 x inf is nan)."""
    win = _window(rng, b, n_state, lanes, page, hkv, hd, device)
    build = ops.build_cram_cache if lanes == 2 else ops.build_cram_cache_quad
    caches = [build(w.reshape(-1, page, hkv, 2 * hd)) for w in win]
    keys = ("slots", "slots_overflow", "strips", "packed_mask")
    st = {k: torch.stack([c[k] for c in caches]) for k in keys}
    st["markers"] = caches[0]["markers"]
    over = st["slots_overflow"]
    gen = torch.Generator(device=device).manual_seed(lanes * 100 + n_state)
    mag = torch.randint(0x80, 0x7F00, tuple(over.shape), generator=gen,
                        device=device, dtype=torch.int32)
    neg = torch.randint(0, 2, tuple(over.shape), generator=gen,
                        device=device, dtype=torch.int32)
    garbage = (mag - 0x8000 * neg).to(torch.int16)
    packed = st["packed_mask"].reshape(*st["packed_mask"].shape,
                                       *([1] * (over.dim() - 2)))
    st["slots_overflow"] = torch.where(packed, garbage, over)
    assert bool(st["packed_mask"].any()) and not bool(st["packed_mask"].all())
    return st


def _leaf_args(rng, st, n, hq, *, lanes, shared, rows=None, empty_row=True):
    """(q, cache, valid, pred) as the serve tier hands them to K3: the
    state sliced [:, :n] (`kernel_cache_slice`: batch stride n_state),
    valid counts sliced out of the state's width, a predictor that misses
    about a third of the groups; `shared` takes row 2 unbatched, `rows` a
    row shard of the slice."""
    from repro_torch.kv.cache import kernel_cache_slice

    b, n_state = st["packed_mask"].shape
    page = st["slots"].shape[2]
    hd = st["slots"].shape[-1] // 2
    dev = st["slots"].device
    cache = kernel_cache_slice(st, n)
    tokens = rng.integers(1, n * lanes * page, b)
    if empty_row:
        tokens[1] = 0                               # no valid token
    pages = np.arange(n_state * lanes)
    valid = torch.from_numpy(np.clip(tokens[:, None] - pages[None] * page, 0,
                                     page).astype(np.int32)).to(dev)
    valid = valid[:, :lanes * n]
    flip = torch.from_numpy(rng.random((b, n)) < 0.3).to(dev)
    pred = cache["packed_mask"] ^ flip
    if shared:
        cache = {k: (v if k == "markers" else v[2]) for k, v in cache.items()}
        valid, pred = valid[2], pred[2]
    elif rows is not None:
        cache = {k: (v if k == "markers" else v[rows])
                 for k, v in cache.items()}
        valid, pred = valid[rows], pred[rows]
    nq = (rows.stop - rows.start) if rows is not None else b
    q = torch.from_numpy(rng.standard_normal((nq, hq, hd)).astype(
        np.float32)).to(dev)
    return q, cache, valid, pred


def _in_place_and_flat(q, cache, valid, pred, *, lanes, block_groups=None):
    """The in-place entry and the flat entry on `physical_view` of the same
    cache: both outputs and byte columns, after checking they are equal
    bit for bit."""
    shared = cache["slots"].dim() == 4
    out, byts = ca.cram_decode_attention_in_place_cuda(
        q, cache, valid, pred, lanes=lanes, block_groups=block_groups)
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    s, st, mk, v = pv(cache, valid)
    ref, ref_b = ca.cram_decode_attention_batched_cuda(
        q, s.contiguous(), st.contiguous(), mk.contiguous(),
        v.to(torch.int32).contiguous(), pred.to(torch.int32).contiguous(),
        lanes=lanes, block_groups=block_groups, shared_cache=shared)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(byts, ref_b)
    return out, byts


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("hkv,hq,hd", [(2, 2, 64), (1, 8, 128),
                                       (3, 9, 64)] + REFERENCE_GEOMETRIES)
@pytest.mark.parametrize("block_groups", [None, 1])
def test_in_place_decode_equals_the_flat_entry(cuda, lanes, shared, hkv, hq,
                                               hd, block_groups):
    """K3 over a state sliced out of a wider one, read in place, against
    K3 over the physical view copied out of it: output and both byte
    columns bit for bit, at every head geometry K3 takes; the output
    within the kernels' tolerance of the plain version."""
    rng = np.random.default_rng([lanes, shared, hkv, hq, hd, 34])
    st = _leaf_state(rng, lanes, 3, 11, 4, hkv, hd, cuda)
    q, cache, valid, pred = _leaf_args(rng, st, 8, hq, lanes=lanes,
                                       shared=shared)
    out, byts = _in_place_and_flat(q, cache, valid, pred, lanes=lanes,
                                   block_groups=block_groups)
    ref, ref_b = ca.cram_decode_attention_in_place_plain(
        q, cache, valid, pred, lanes=lanes, block_groups=block_groups)
    live = valid.reshape(-1, valid.shape[-1]).gt(0).any(-1).expand(
        q.shape[0])                 # a row with none averages the garbage
    assert torch.isfinite(out[live]).all()
    torch.testing.assert_close(out[live], ref.to(cuda)[live], **TOL)
    assert torch.equal(byts, ref_b)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
def test_in_place_decode_on_a_row_shard_of_a_sliced_state(cuda, lanes):
    """Rows 1-2 of a sliced state (a shard's strided view, as
    `serving/shard.py` hands it over) against the flat entry and against
    the same rows of one launch over every row."""
    rng = np.random.default_rng([lanes, 2])
    st = _leaf_state(rng, lanes, 4, 13, 16, 8, 128, cuda)
    q, cache, valid, pred = _leaf_args(rng, st, 8, 24, lanes=lanes,
                                       shared=False)
    whole, whole_b = _in_place_and_flat(q, cache, valid, pred, lanes=lanes)
    rows = slice(1, 3)
    part = {k: (v if k == "markers" else v[rows]) for k, v in cache.items()}
    assert part["slots"].stride(0) == 13 * part["slots"].stride(1)
    out, byts = _in_place_and_flat(q[rows].contiguous(), part, valid[rows],
                                   pred[rows], lanes=lanes)
    assert torch.equal(out.view(torch.int32), whole[rows].view(torch.int32))
    assert torch.equal(byts, whole_b[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
def test_in_place_decode_never_reads_packed_overflow(cuda, lanes):
    """Every row has a valid token: the garbage in packed groups' overflow
    slots never reaches the output or the bytes (the same bits with the
    overflow of packed groups zeroed)."""
    rng = np.random.default_rng([lanes, 3])
    st = _leaf_state(rng, lanes, 3, 9, 16, 8, 128, cuda)
    args = _leaf_args(np.random.default_rng(5), st, 8, 24, lanes=lanes,
                      shared=False, empty_row=False)
    got, got_b = _in_place_and_flat(*args, lanes=lanes)
    over = st["slots_overflow"]
    packed = st["packed_mask"].reshape(*st["packed_mask"].shape,
                                       *([1] * (over.dim() - 2)))
    clean = dict(st, slots_overflow=torch.where(packed, 0, over))
    assert not torch.equal(clean["slots_overflow"], over)
    args = _leaf_args(np.random.default_rng(5), clean, 8, 24, lanes=lanes,
                      shared=False, empty_row=False)
    want, want_b = _in_place_and_flat(*args, lanes=lanes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_b, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
def test_in_place_decode_with_a_zero_marker(cuda, lanes):
    """Groups whose marker is 0: the all-zero strip row of an overflow
    slot then carries the marker, which the in-place entry, making that
    row in shared memory, must read as the flat entry reads the zero row
    physical_view copies."""
    rng = np.random.default_rng([lanes, 4])
    st = _leaf_state(rng, lanes, 3, 8, 16, 8, 128, cuda)
    st["markers"] = st["markers"].clone()
    st["markers"][::3] = 0
    q, cache, valid, pred = _leaf_args(rng, st, 8, 24, lanes=lanes,
                                       shared=False)
    valid = torch.full_like(valid, 16)              # every slot walked
    _in_place_and_flat(q, cache, valid, pred, lanes=lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["pair", "quad"])
def test_serve_attend_reads_the_cache_in_place(cuda, packing, monkeypatch):
    """The serve tier's attend on the card takes the in-place entry, once
    an attend, opens no span but its repack, K3 and host syncs, copies
    nothing of the cache inside K3's span, and gives the flat route's
    bits on the same state."""
    from repro_torch import obs
    from repro_torch.serving import ServeLoop

    loop = ServeLoop(device=cuda, slots=4, max_pages=24, page=16, n_kv=8,
                     head_dim=128, policy="static", packing=packing)
    rng = np.random.default_rng(9)
    for sid in range(4):
        kk, vv = synthetic_kv_stream(rng, 1, 40 + 61 * sid, 8, 128,
                                     compressible=sid != 2)
        loop.prefill(sid, kk[0], vv[0])
    q = rng.standard_normal((4, 24, 128)).astype(np.float32)
    calls = []
    in_place = ca.cram_decode_attention_in_place_cuda
    monkeypatch.setattr(ca, "cram_decode_attention_in_place_cuda",
                        lambda *a, **kw: calls.append(1)
                        or in_place(*a, **kw))
    obs.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = loop.attend({i: q[i] for i in range(4)})
    snap = obs.snapshot()
    obs.reset()
    assert calls == [1]
    assert snap["spans"]["cache.k3"]["n"] == snap["spans"][
        "serve.attend"]["n"] == 1
    assert {e.name for e in prof.events()
            if e.name.startswith(("serve.", "cache.", "host."))} <= {
        "serve.attend", "cache.repack", "cache.k3", "host.sync"}
    k3 = [e for e in prof.events() if e.name == "cache.k3"]
    assert len(k3) == 1
    assert not [e for e in prof.events() if e.name in (
        "aten::stack", "aten::cat", "aten::copy_", "aten::clone")
        and k3[0].time_range.start <= e.time_range.start
        <= k3[0].time_range.end]
    c = loop.cache
    n = c._active_bucket()
    got = torch.stack([out[i] for i in range(4)])
    want, _ = _in_place_and_flat(
        torch.from_numpy(q).to(cuda), c._kernel_cache(n), c._valid(n),
        c._kernel_cache(n)["packed_mask"], lanes=c.group_lanes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------- the CPU half (runs here)

def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(1)
    cpu = torch.device("cpu")
    before = {**bdi_pack.LAUNCHES, **ca.LAUNCHES, **cs.LAUNCHES,
              **gd.LAUNCHES}
    win = _window(rng, 2, 2, 2, 4, 2, 8, cpu).contiguous()
    mk = torch.zeros((2, 2), dtype=torch.int16)
    enabled = torch.tensor([True, False])
    got = bdi_pack.pack_window(win, mk, enabled)
    want = bdi_pack.pack_window_plain(win, mk, enabled)
    assert all(torch.equal(g, r) for g, r in zip(got, want, strict=True))
    args = _attention_args(rng, 4, 2, 2, 4, 2, 4, 8, cpu, False)
    out, byts = ca.cram_decode_attention_batched(*args, lanes=4)
    ref, ref_b = ca.cram_decode_attention_batched_plain(*args, lanes=4)
    assert torch.equal(out, ref) and torch.equal(byts, ref_b)
    pages = [win[:, 0, j] for j in range(2)]
    packed, base, ok = bdi_pack.pack_pair(*pages)
    ok_p, packed_p, base_p = pagepack.pack_pair(*pages)
    assert torch.equal(packed, packed_p) and torch.equal(ok, ok_p)
    for a, b in zip(bdi_pack.unpack_pair(packed, base),
                    pagepack.unpack_pair(packed, base), strict=True):
        assert torch.equal(a, b)
    q, slots, strips, markers, valid, _ = args
    one = ca.cram_decode_attention(q[0], slots[0], strips[0], markers,
                                   valid[0], lanes=4)
    assert torch.equal(one, ca.cram_decode_attention_plain(
        q[0], slots[0], strips[0], markers, valid[0], lanes=4))
    img = torch.from_numpy(rng.integers(0, 256, (9, 64)).astype(np.uint8))
    got = cs.compress_scan(img)
    want = cs.compress_scan_plain(img)
    assert all(torch.equal(got[k], want[k]) for k in want)
    e1 = es.LAUNCHES["engine_scan"]
    small = SimConfig(**E1_CONFIGS["small"])
    flags, params, trace = _e1_inputs(rng, small, 2, 2, 50)
    whole = _e1_run(small, flags, params, trace, cpu)
    chunked = _e1_run(small, flags, params, trace, cpu, [7, 8])
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked, strict=True))
    assert es.LAUNCHES["engine_scan"] == e1
    q, k, v = _gqa_inputs(2, 64, 2, 3, 16, torch.bfloat16, cpu)
    state = attention.decode_attention_state(q, k, v, 40, 32)
    want = attention.decode_attention_state_plain(q, k, v, 40, 32)
    assert all(torch.equal(a, b) for a, b in zip(state, want, strict=True))
    out = attention.chunked_decode_attention(q, k, v, 40, 32)
    assert out.dtype == q.dtype and torch.equal(out, (
        want[2] / torch.clamp(want[1], min=1e-30)[..., None]).to(q.dtype))
    assert {**bdi_pack.LAUNCHES, **ca.LAUNCHES, **cs.LAUNCHES,
            **gd.LAUNCHES} == before


@pytest.mark.parametrize("groups,nvec,sms", [
    (8, 4096, 132),       # serve: 8 sequences, a window of one group
    (4, 4096, 132),       # launcher: batch 4
    (64, 4096, 132),      # prefill: 8 sequences x 8 groups
    (1000, 4096, 132), (1, 16, 132), (3, 240, 8), (12, 7, 2)])
def test_window_chunks_cover_each_group_once_in_one_wave(groups, nvec, sms):
    """The window pack's chunk rule: whole vectors, every vector of a group
    in exactly one chunk (the last may be shorter), at least one vector per
    thread, at least one CTA per SM where the window has a vector per
    thread to spread, and no more CTAs than the card holds at once (32 of
    64 threads per SM) unless a group is one chunk."""
    cv, chunks = bdi_pack.window_chunks(groups, nvec, sms)
    assert 1 <= cv <= nvec and (chunks - 1) * cv < nvec <= chunks * cv
    assert cv >= min(nvec, bdi_pack.WINDOW_THREADS)
    ctas = groups * chunks
    if groups * nvec >= bdi_pack.WINDOW_THREADS * sms:
        assert ctas >= sms
    assert ctas <= 2 * bdi_pack.WINDOW_CTAS_PER_SM * sms or chunks == 1


def test_ptxas_log_parse():
    from repro_torch.kernels.cuda_lib import parse_ptxas

    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z6kernelILi2EEvPKs' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z6kernelILi2EEvPKs\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 8448 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z4scanPK5uint4' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 111 registers, used 0 barriers\n")
    assert parse_ptxas(log) == [
        {"kernel": "_Z6kernelILi2EEvPKs", "registers": 80,
         "spill_stores": 12, "spill_loads": 16},
        {"kernel": "_Z4scanPK5uint4", "registers": 111, "spill_stores": 0,
         "spill_loads": 0}]
    assert parse_ptxas("") == []


def test_cuda_entry_refuses_cpu_tensors_before_building():
    win = torch.zeros((1, 1, 2, 4, 2, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bdi_pack.pack_window_cuda(win, torch.zeros((1, 2), dtype=torch.int16),
                                  torch.ones(1, dtype=torch.bool))
    page = torch.zeros((4, 2, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bdi_pack.pack_pages_cuda((page, page))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bdi_pack.unpack_pages_cuda(page, page[0], 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cs.compress_scan_cuda(torch.zeros((2, 64), dtype=torch.uint8))
    q, k, v = _gqa_inputs(1, 8, 1, 2, 16, torch.bfloat16, "cpu")
    for state in (True, False):
        with pytest.raises(ValueError, match="CUDA tensor"):
            gd.gqa_decode_cuda(q, k, v, 4, state=state)


def test_tensors_without_storage_run_the_plain_decode_attention(monkeypatch):
    """A dry run's FakeTensors and meta tensors take the plain chunk loop
    of the decode attention and never reach the kernel's build; a fake
    tensor on "cuda" is routed there too."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import cuda_lib

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    before = dict(gd.LAUNCHES)
    with FakeTensorMode():
        assert not attention._on_card(torch.empty((2, 6, 16), device="cuda"))
        q = torch.empty((2, 6, 16), dtype=torch.bfloat16)
        k = torch.empty((2, 64, 2, 16), dtype=torch.bfloat16)
        out = attention.chunked_decode_attention(q, k, k, length=40,
                                                 k_chunk=32)
        m, l, o = attention.decode_attention_state(q, k, k, 40, 32)
    assert out.shape == (2, 6, 16) and out.dtype == torch.bfloat16
    assert m.shape == l.shape == (2, 6) and o.shape == (2, 6, 16)
    q = torch.empty((2, 6, 16), device="meta")
    k = torch.empty((2, 64, 2, 16), device="meta")
    out = attention.chunked_decode_attention(q, k, k, 40, 32)
    m, l, o = attention.decode_attention_state(q, k, k, 40, 32)
    assert out.is_meta and out.shape == (2, 6, 16)
    assert o.is_meta and o.dtype == torch.float32
    assert gd.LAUNCHES == before


@pytest.mark.parametrize("b,hkv,hq,t", [
    (48, 8, 24, 3072),     # phi4-mini's decode cell: 10 splits of 320
    (1024, 16, 16, 256),   # OLMoE's: one split
    (2, 8, 96, 100), (1, 1, 1, 1), (3, 2, 6, 1000), (1, 1, 1, 100_000),
    (4300, 1, 12, 100)])
def test_gqa_decode_splits_cover_the_cache_once(b, hkv, hq, t):
    """The split rule: whole runs of SPLIT_QUANTUM positions, the last
    split non-empty, at most MAX_SPLITS, and no more splits than the
    launch needs for its CTA target; the rule sees the shapes alone."""
    width, splits = gd.split_geometry(b, hkv, hq, t)
    assert width % gd.SPLIT_QUANTUM == 0
    assert (splits - 1) * width < t <= splits * width
    assert 1 <= splits <= gd.MAX_SPLITS
    chunks = -(-(hq // hkv) // gd.MAX_GROUP)
    if splits > 1:
        assert b * hkv * chunks * (splits - 1) < gd.TARGET_CTAS


def test_analyze_step_counts_the_flops_a_kernel_reports():
    """A kernel's FLOPs, which no aten op shows, reach `analyze_step`'s
    count (A1 reports q.k and p.v over the valid positions), and only
    while it records."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.hlo_analysis import analyze_step

    a, b = torch.ones((4, 8)), torch.ones((8, 2))

    def step(x, y):
        cuda_lib.count_flops(1000.0)
        return x @ y

    assert analyze_step(step, a, b)["flops"] == 2 * 4 * 8 * 2 + 1000
    assert cuda_lib.FLOP_OBSERVERS == []
    cuda_lib.count_flops(5.0)       # no observer: nothing to count
