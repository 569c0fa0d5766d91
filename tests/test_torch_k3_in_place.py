"""K3's in-place entry on the CPU: the serve tier's attend reads the cache
state's own leaves instead of the flat slot view `physical_view` copies
out of them.

`cram_attention.leaf_addresses` is the plain counterpart of the kernel's
addressing (LeafSlots in `csrc/cram_attention.cuh`): from the leaves and
their batch strides, for each flat slot the offset of its page rows and
of its strip row (none for an overflow slot, whose all-zero strip the
kernel makes in shared memory), its marker and its valid counts.
`leaf_view` reads the leaves' storage at those offsets; it must equal
`physical_view` / `physical_view_quad` element for element on packed,
raw and empty groups, for per-sequence and shared caches, for a state
sliced `[:, :n]` out of a larger one (batch stride `n_groups`, not `n`)
and for a row shard of that slice.  `ops.decode_attention_fused` takes
this entry on every device, and its bits are the flat entry's over
`physical_view`.  The CUDA wrapper's own argument
handling runs here with the library replaced by a recorder: it passes
the leaves themselves (no copy), their batch strides and the flat
entry's split.  The kernel itself is held bit for bit against the flat
entry on the card (`tests/test_torch_cuda_kernels.py`).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cram_attention as ca
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import ops
from repro_torch.kv import synthetic_kv_stream
from repro_torch.kv.cache import kernel_cache_slice, kv_bits

torch.set_num_threads(1)

PAGE, HKV, HD, HQ = 4, 2, 8, 4
FORMS = ["per_sequence", "shared", "sliced", "sliced_row_shard"]


def _state(rng, lanes, b, n_groups):
    """Per-sequence caches of `n_groups` groups, stacked: group g of
    sequence i is compressible unless (g + i) % 3 == 1; the overflow of
    every packed group holds non-zero garbage (the pack leaves it to the
    layout's reader, which must never read it)."""
    t = n_groups * lanes * PAGE
    caches = []
    for i in range(b):
        kc, vc = synthetic_kv_stream(rng, 1, t, HKV, HD)
        ki, vi = synthetic_kv_stream(rng, 1, t, HKV, HD, compressible=False)
        span = lanes * PAGE
        for g in range(n_groups):
            if (g + i) % 3 == 1:
                sl = slice(g * span, (g + 1) * span)
                kc[:, sl], vc[:, sl] = ki[:, sl], vi[:, sl]
        pages = kv_bits(kc[0], vc[0], "cpu").reshape(-1, PAGE, HKV, 2 * HD)
        build = (ops.build_cram_cache if lanes == 2
                 else ops.build_cram_cache_quad)
        caches.append(build(pages))
    keys = ("slots", "slots_overflow", "strips", "packed_mask")
    st = {k: torch.stack([c[k] for c in caches]) for k in keys}
    st["markers"] = caches[0]["markers"]
    over = st["slots_overflow"]
    garbage = torch.from_numpy(rng.integers(-2**15, 2**15, tuple(over.shape),
                                            dtype=np.int16))
    packed = st["packed_mask"].reshape(
        *st["packed_mask"].shape, *([1] * (over.dim() - 2)))
    st["slots_overflow"] = torch.where(packed, garbage, over)
    return st


def _case(lanes, form, seed=0):
    """(cache as the attend gets it, valid_per_page, q): 4 sequences of
    4 active groups, out of a state of 6 groups for the sliced forms; the
    valid counts reach into the second group or further and leave the
    last group or more of every sequence empty, sequence 1 wholly
    empty."""
    rng = np.random.default_rng([lanes, FORMS.index(form), seed])
    b, n, n_state = 4, 4, 6
    st = _state(rng, lanes, b, n_state)
    tokens = rng.integers(lanes * PAGE + 1, (n - 1) * lanes * PAGE, b)
    tokens[1] = 0
    pages = np.arange(n_state * lanes)
    valid = torch.from_numpy(np.clip(tokens[:, None] - pages[None] * PAGE,
                                     0, PAGE).astype(np.int32))
    if form == "per_sequence":
        cache = {k: (v if k == "markers" else v[:, :n].contiguous())
                 for k, v in st.items()}
        cache["markers"] = st["markers"][:n]
        valid = valid[:, :lanes * n].contiguous()
    elif form == "shared":
        cache = {k: (v[:n] if k == "markers" else v[3, :n].contiguous())
                 for k, v in st.items()}
        valid, b = valid[3, :lanes * n].contiguous(), 3
    else:
        cache = kernel_cache_slice(st, n)
        valid = valid[:, :lanes * n]
        if form == "sliced_row_shard":
            cache = {k: (v if k == "markers" else v[2:4])
                     for k, v in cache.items()}
            valid, b = valid[2:4], 2
    q = torch.from_numpy(rng.standard_normal((b, HQ, HD)).astype(np.float32))
    return cache, valid, q


def _has_every_kind(cache, valid, lanes):
    """The case holds packed, raw and empty (no valid token) groups."""
    mask = cache["packed_mask"].reshape(-1, cache["packed_mask"].shape[-1])
    live = valid.reshape(mask.shape[0], -1, lanes).sum(-1) > 0
    return bool((mask & live).any() and (~mask & live).any()
                and (~live).any())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lanes", [2, 4])
def test_leaf_view_equals_physical_view(lanes, form):
    cache, valid, _ = _case(lanes, form)
    assert _has_every_kind(cache, valid, lanes)
    if form.startswith("sliced"):
        assert not cache["slots"].is_contiguous()   # batch stride n_groups
        assert cache["slots"].stride(0) == 6 * cache["slots"].stride(1)
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    want = pv(cache, valid)
    got = ca.leaf_view(cache, valid, lanes=lanes)
    for name, w, g in zip(("slots", "strips", "markers", "valid"), want, got,
                          strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    # the overflow's garbage is read only where the view reads it: slots of
    # a packed group past its lead carry no valid token
    a = ca.leaf_addresses(cache, valid, lanes=lanes)
    over_slot = a["src"] == 1
    packed = cache["packed_mask"].reshape(-1, cache["packed_mask"].shape[-1])
    packed_slot = packed[:, a["marker"]]
    assert (a["valid"][over_slot & packed_slot] == 0).all()
    assert (a["strip_off"][over_slot] == -1).all()


def _flat(q, cache, valid, pred, lanes):
    """The flat entry's plain version over `physical_view` of the cache:
    (out, raw, cram)."""
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    s, st, mk, v = pv(cache, valid)
    out, byts = ca.cram_decode_attention_batched_plain(
        q, s, st, mk, v, pred, lanes=lanes,
        shared_cache=cache["slots"].dim() == 4)
    return out, byts[:, 0], byts[:, 1]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lanes", [2, 4])
def test_in_place_plain_equals_the_fused_cpu_path(lanes, form):
    """The in-place entry's plain version gives the bits (output and both
    byte columns) of the flat entry's plain version over `physical_view`,
    with a predictor that misses some groups."""
    cache, valid, q = _case(lanes, form, seed=1)
    rng = np.random.default_rng([lanes, 7])
    mask = cache["packed_mask"]
    pred = mask ^ torch.from_numpy(rng.random(tuple(mask.shape)) < 0.4)
    out, raw, cram = _flat(q, cache, valid, pred, lanes)
    got, byts = ca.cram_decode_attention_in_place(q, cache, valid, pred,
                                                  lanes=lanes)
    assert torch.equal(got.view(torch.int32), out.view(torch.int32))
    assert torch.equal(byts[:, 0], raw) and torch.equal(byts[:, 1], cram)
    assert (raw > 0).any() and (cram > 0).any()


class _Recorder:
    """Stands in for the bound library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def cram_decode_attention(self, *a):
        self.calls.append(("flat", a))
        return 0

    def cram_decode_attention_leaves(self, *a):
        self.calls.append(("leaves", a))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "load", lambda: rec)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    before = dict(ca.LAUNCHES)
    yield rec
    ca.LAUNCHES.update(before)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lanes", [2, 4])
def test_in_place_entry_passes_the_leaves(recorder, lanes, form):
    """The CUDA wrapper hands the kernel the leaves themselves (no copy),
    their batch strides (0 for a shared cache), the group count and the
    split the flat entry takes on the physical view of the same cache."""
    cache, valid, q = _case(lanes, form)
    shared = cache["slots"].dim() == 4
    pred = cache["packed_mask"]
    name = "decode_attention_pair" if lanes == 2 else "decode_attention_quad"
    before = ca.LAUNCHES[name]
    ca.cram_decode_attention_in_place_cuda(q, cache, valid, pred,
                                           lanes=lanes)
    ptrs = [t.data_ptr() for t in (q, cache["slots"],
                                   cache["slots_overflow"], cache["strips"],
                                   cache["markers"], cache["packed_mask"],
                                   valid, pred)]
    (kind, a), = recorder.calls
    assert kind == "leaves" and ca.LAUNCHES[name] == before + 1
    assert [x.value for x in a[:8]] == ptrs
    leaves = (cache["slots"], cache["slots_overflow"], cache["strips"],
              cache["packed_mask"], valid, pred)
    assert list(a[8:14]) == [0 if shared else t.stride(0) for t in leaves]
    b, n = q.shape[0], cache["slots"].shape[-4]
    assert a[14:22] == (b, HQ, HD, n, PAGE, HKV, lanes,
                        ca.split_width(lanes * n))
    recorder.calls.clear()
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    s, st, mk, v = pv(cache, valid)
    ca.cram_decode_attention_batched_cuda(
        q, s.contiguous(), st.contiguous(), mk.contiguous(),
        v.to(torch.int32).contiguous(), pred.to(torch.int32).contiguous(),
        lanes=lanes, shared_cache=shared)
    (kind, f), = recorder.calls
    assert kind == "flat" and f[9] == lanes * n and f[13] == a[21]


def test_in_place_entry_refuses_what_it_cannot_read(recorder):
    cache, valid, q = _case(2, "sliced")
    pred = cache["packed_mask"]
    with pytest.raises(ValueError, match="valid_per_page must be"):
        ca.cram_decode_attention_in_place_cuda(q, cache, valid.long(), pred)
    with pytest.raises(ValueError, match="predictor must be"):
        ca.cram_decode_attention_in_place_cuda(q, cache, valid, pred.int())
    strided = dict(cache, strips=cache["strips"].transpose(1, 2)
                   .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="past its batch axis"):
        ca.cram_decode_attention_in_place_cuda(q, strided, valid, pred)
    assert recorder.calls == []


class _Observer:
    """A `cuda_lib.OBSERVERS` entry: the kernel wrappers entered."""

    def __init__(self):
        self.entered = []

    def enter(self, name):
        self.entered.append(name)

    def exit(self, name):
        pass


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lanes", [2, 4])
def test_fused_attend_takes_the_in_place_entry(monkeypatch, lanes, form):
    """On the CPU as on the card, the fused attend calls K3's in-place
    wrapper once, whose plain version runs here, and gives the bits of the
    flat entry's plain version over `physical_view` (perfect
    predictor)."""
    cache, valid, q = _case(lanes, form, seed=2)
    plain = []
    in_place_plain = ca.cram_decode_attention_in_place_plain
    monkeypatch.setattr(ca, "cram_decode_attention_in_place_plain",
                        lambda *a, **kw: plain.append(1)
                        or in_place_plain(*a, **kw))
    seen = _Observer()
    monkeypatch.setattr(cuda_lib, "OBSERVERS", [seen])
    out, raw, cram = ops.decode_attention_fused(q, cache, valid, lanes=lanes)
    name = "decode_attention_pair" if lanes == 2 else "decode_attention_quad"
    assert seen.entered == [name] and plain == [1]
    want, want_raw, want_cram = _flat(q, cache, valid, cache["packed_mask"],
                                      lanes)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(raw, want_raw) and torch.equal(cram, want_cram)
    assert (raw > 0).any() and (cram > 0).any()
