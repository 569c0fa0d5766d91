"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked `cuda`; without one the
fixture skips it.  On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

K1/K2 (window pack) must be bit-exact on all five outputs.  K3 (decode on
the compressed cache) must agree within atol = rtol = 2e-3 (the kernel's
online softmax sums in another order and uses __expf) with its byte
output exact.  The shapes are small and odd on purpose: they cover what
the chip_smoke run at the phi4 geometry does not (head_dim 64, one query
head per KV head, the largest group of 8, one slot block per sequence).

The CPU half at the end runs here too: a wrapper given CPU tensors runs
the plain version and counts no launch, and the CUDA entry refuses a CPU
tensor before it builds anything.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bdi_pack
from repro_torch.kernels import cram_attention as ca
from repro_torch.kernels import ops
from repro_torch.kv import synthetic_kv_stream
from repro_torch.kv.cache import kv_bits

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


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("page,hkv,hd", [(4, 2, 8), (16, 8, 128),
                                         (5, 3, 64)])
def test_pack_window_kernel_bit_exact(cuda, lanes, page, hkv, hd):
    rng = np.random.default_rng([lanes, page, hkv, hd])
    b, w = 4, 3
    win = _window(rng, b, w, lanes, page, hkv, hd, cuda).contiguous()
    win[3, 1, :, page // 2:] = 0                    # a partial page group
    mk = torch.from_numpy(rng.integers(-2**15, 2**15, (w, 2)).astype(
        np.int16)).to(cuda)
    enabled = torch.tensor([True, True, False, True], device=cuda)
    got = bdi_pack.pack_window_cuda(win, mk, enabled)
    torch.cuda.synchronize()
    want = bdi_pack.pack_window_plain(win, mk, enabled)
    for name, g, r in zip(("slots", "over", "strips", "lay", "fit"), got,
                          want, strict=True):
        assert torch.equal(g, r), name


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


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("hkv,hq,hd", [(2, 2, 64), (1, 8, 128),
                                       (3, 9, 64)])
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


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_cannot_run(cuda):
    rng = np.random.default_rng(0)
    args = list(_attention_args(rng, 2, 2, 2, 4, 1, 9, 64, cuda, False))
    with pytest.raises(ValueError, match="at most 8"):
        ca.cram_decode_attention_batched_cuda(*args, lanes=2)
    args = list(_attention_args(rng, 2, 2, 2, 4, 2, 4, 64, cuda, False))
    args[4] = args[4].to(torch.int64)
    with pytest.raises(ValueError, match="valid must be"):
        ca.cram_decode_attention_batched_cuda(*args, lanes=2)


# ------------------------------------------------- the CPU half (runs here)

def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(1)
    cpu = torch.device("cpu")
    before = {**bdi_pack.LAUNCHES, **ca.LAUNCHES}
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
    assert {**bdi_pack.LAUNCHES, **ca.LAUNCHES} == before


def test_cuda_entry_refuses_cpu_tensors_before_building():
    win = torch.zeros((1, 1, 2, 4, 2, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bdi_pack.pack_window_cuda(win, torch.zeros((1, 2), dtype=torch.int16),
                                  torch.ones(1, dtype=torch.bool))
