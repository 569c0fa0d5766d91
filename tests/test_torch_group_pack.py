"""The group pack (K1/K2 on whole page groups, the page codecs' device pack)
on the CPU: the cluster rule of its CUDA launch, a numpy model of the
kernel's chunks, and the wrapper's contract against the JAX reference.

The CUDA kernel (`csrc/bdi_pack.cu:pack_pages_kernel`) runs each group as
a thread-block cluster of C CTAs, cut by `bdi_pack.group_cluster`; rank r
packs the vectors [r * chunk, (r + 1) * chunk) of its group, 16 / lanes
vectors per thread at a time, and rank 0 ANDs the ranks' fit flags.  The
kernel itself runs only on a card (`tests/test_torch_cuda_kernels.py`,
marked `cuda`); here the rule's invariants and the kernel's index
arithmetic are checked in Python, and the wrapper given CPU tensors (which
runs `pagepack`) is held per group against `repro.kernels.bdi_pack.
pack_pair` / `pack_quad` in interpret mode.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bdi_pack as ref_bdi
from repro_torch.kernels import bdi_pack

torch.set_num_threads(1)

T = bdi_pack.PACK_THREADS

# (groups, vectors a group, SMs)
SHAPES = [
    (46, 4096, 132),      # the serve caches' pair groups, phi4 KV geometry
    (20, 4096, 132),      # their quad groups
    (1024, 4096, 132),    # bulk: one layer's KV of 8 x 4,096 tokens, pair
    (512, 4096, 132),     # the same, quad
    (6, 30, 132),         # the serving-test geometry (5, 3, 16)
    (65539, 1, 132),      # more groups than a grid's y axis holds
    (1, 4096, 132), (3, 600, 132), (2, 511, 8), (5, 2048, 2),
    (1, 1 << 20, 132), (7, 257, 132)]


@pytest.mark.parametrize("groups,nvec,sms", SHAPES)
def test_group_cluster_covers_each_vector_once(groups, nvec, sms):
    """C in 1, 2, 4, 8; every vector of a group in exactly one rank's
    chunk, no rank idle; a chunk of at least one vector per thread; the
    launch's own checks hold; and C stops growing only at MAX_CLUSTER, at
    a chunk of fewer than two vectors per thread, or once the call has a
    CTA for every SM."""
    cluster, chunk = bdi_pack.group_cluster(groups, nvec, sms)
    assert cluster in (1, 2, 4, 8)
    assert chunk >= min(nvec, T)
    covered = np.zeros(nvec, np.int64)
    for r in range(cluster):
        v0, v1 = r * chunk, min((r + 1) * chunk, nvec)
        assert v0 < v1
        covered[v0:v1] += 1
    assert (covered == 1).all()
    assert chunk * (cluster - 1) < nvec <= chunk * cluster
    if cluster < bdi_pack.MAX_CLUSTER and -(-nvec // (2 * cluster)) >= T:
        assert groups * cluster >= sms


@pytest.mark.parametrize("name", ["PACK_THREADS", "MAX_CLUSTER",
                                  "WINDOW_THREADS"])
def test_launch_constants_match_the_cuda_source(name):
    """The wrapper's copies of the kernels' launch constants are the
    values `csrc/bdi_pack.cu` compiles with."""
    src = (pathlib.Path(bdi_pack.__file__).resolve().parent.parent / "csrc"
           / "bdi_pack.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(getattr(bdi_pack, name))]


def test_group_cluster_at_the_shapes_the_port_runs():
    """Clusters of 4 / 8 at the serve caches' 46 pair / 20 quad groups
    (each CTA on whole token rows of 256 vectors), one CTA a group at the
    bulk shape and at the serving-test geometry, where a group is less
    than one vector per thread."""
    assert bdi_pack.group_cluster(46, 4096, 132) == (4, 1024)
    assert bdi_pack.group_cluster(20, 4096, 132) == (8, 512)
    assert bdi_pack.group_cluster(1024, 4096, 132) == (1, 4096)
    assert bdi_pack.group_cluster(512, 4096, 132) == (1, 4096)
    assert bdi_pack.group_cluster(6, 5 * 3 * 16 // 8, 132) == (1, 30)


def _pages(rng, lanes, g, page, hkv, d2):
    """`lanes` (g, page, Hkv, D2) int16 numpy pages: even groups within
    the codec's delta range of their base row, odd groups far from it;
    group 2 (where there is one) fits but for the last element of its
    last lane."""
    lim = 128 if lanes == 2 else 8
    row = rng.integers(-3000, 3000, (g, 1, hkv, d2))
    far = (np.arange(g) % 2 == 1)[:, None, None, None]
    pages = [row + np.where(far, rng.integers(-2**14, 2**14,
                                              (g, page, hkv, d2)),
                            rng.integers(-lim, lim, (g, page, hkv, d2)))
             for _ in range(lanes)]
    pages[0][:, 0] = row[:, 0]
    if g > 2:
        pages[-1][2, -1, -1, -1] = row[2, 0, -1, -1] + 300
    return [p.astype(np.int16) for p in pages]


def _kernel_model(pages, lanes, sms=132):
    """The CUDA kernel's work in numpy, CTA by CTA and thread by thread:
    each rank's chunk in steps of 16 / lanes vectors per thread, the base
    vector at v % rowvec (checked to be the thread's own where the kernel
    reads it once), the rank's fit ANDed by rank 0.  Returns (packed,
    base, ok)."""
    g, page, hkv, d2 = pages[0].shape
    rowvec, nvec = hkv * d2 // 8, page * hkv * d2 // 8
    vec = [p.reshape(g, nvec, 8).astype(np.int32) for p in pages]
    cluster, chunk = bdi_pack.group_cluster(g, nvec, sms)
    lo, bits = (-128, 8) if lanes == 2 else (-8, 4)
    packed = np.zeros((g, nvec, 8), np.int64)
    base = np.zeros((g, rowvec, 8), np.int64)
    written = np.zeros((g, nvec), np.int64)
    ok = np.ones(g, bool)
    tid = np.arange(T)
    rnd = 16 // lanes                 # the kernel's U: vectors a round
    for rank in range(cluster):
        v0, v1 = rank * chunk, min((rank + 1) * chunk, nvec)
        row = T % rowvec == 0 and v0 % rowvec == 0
        fits = np.ones(g, bool)
        for v in range(v0, v1, rnd * T):
            for u in range(rnd):
                w = v + tid + u * T
                w = w[w < v1]
                if row:
                    assert (w % rowvec == tid[:w.size] % rowvec).all()
                b = vec[0][:, w % rowvec]
                word = np.zeros_like(b)
                for j in range(lanes):
                    d = vec[j][:, w] - b
                    fits &= ((d >= lo) & (d <= -lo - 1)).all((1, 2))
                    word |= (d & ((1 << bits) - 1)) << (bits * j)
                packed[:, w] = word
                written[:, w] += 1
                base[:, w[w < rowvec]] = b[:, w < rowvec]
        ok &= fits
    assert (written == 1).all()
    packed = np.where(packed >= 0x8000, packed - 0x10000, packed)
    return (packed.astype(np.int16).reshape(pages[0].shape),
            base.astype(np.int16).reshape(g, hkv, d2), ok)


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("g,page,hkv,d2", [
    (3, 16, 8, 256),      # clusters of 8 at the phi4 KV geometry
    (6, 5, 3, 16),        # one CTA a group, the general base index
    (3, 16, 16, 256),     # a token row of 512 vectors: the general index
    (4, 9, 8, 96)])       # chunks that start mid-row
def test_kernel_model_matches_the_reference(lanes, g, page, hkv, d2):
    """The numpy model of the kernel's chunks and its cross-CTA AND gives
    the reference's packed pages, base rows and fit, per group, including
    group 2's misfit at the last element of its last lane."""
    rng = np.random.default_rng([lanes, g, page, hkv, d2])
    pages = _pages(rng, lanes, g, page, hkv, d2)
    packed, base, ok = _kernel_model(pages, lanes)
    ref = ref_bdi.pack_pair if lanes == 2 else ref_bdi.pack_quad
    for i in range(g):
        r_packed, r_base, r_ok = ref(*(jnp.asarray(p[i]) for p in pages))
        np.testing.assert_array_equal(packed[i], np.asarray(r_packed))
        np.testing.assert_array_equal(base[i], np.asarray(r_base))
        assert bool(ok[i]) == bool(r_ok)
    assert ok[0] and not ok[1] and not ok[2]


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_cpu_wrapper_matches_the_reference_per_group(lanes, lead):
    """The registry's pack on CPU tensors: packed and base as the
    reference's per group, ok a bool of the leading shape."""
    page, hkv, d2 = 4, 2, 16
    g = int(np.prod(lead)) if lead else 1
    rng = np.random.default_rng([lanes, g])
    pages = _pages(rng, lanes, g, page, hkv, d2)
    tp = [torch.from_numpy(p.reshape(*lead, page, hkv, d2)) for p in pages]
    pack = bdi_pack.pack_pair if lanes == 2 else bdi_pack.pack_quad
    before = dict(bdi_pack.LAUNCHES)
    packed, base, ok = pack(*tp)
    assert bdi_pack.LAUNCHES == before
    assert ok.dtype == torch.bool and tuple(ok.shape) == lead
    assert packed.dtype == torch.int16 and packed.shape == tp[0].shape
    assert tuple(base.shape) == (*lead, hkv, d2)
    ref = ref_bdi.pack_pair if lanes == 2 else ref_bdi.pack_quad
    for i in range(g):
        r_packed, r_base, r_ok = ref(*(jnp.asarray(p[i]) for p in pages))
        np.testing.assert_array_equal(packed.reshape(g, page, hkv, d2)[i],
                                      np.asarray(r_packed))
        np.testing.assert_array_equal(base.reshape(g, hkv, d2)[i],
                                      np.asarray(r_base))
        assert bool(ok.reshape(g)[i]) == bool(r_ok)


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("lead", [(0,), (2, 0)])
def test_cpu_wrapper_takes_empty_group_axes(lanes, lead):
    pages = [torch.zeros((*lead, 4, 2, 16), dtype=torch.int16)] * lanes
    pack = bdi_pack.pack_pair if lanes == 2 else bdi_pack.pack_quad
    packed, base, ok = pack(*pages)
    assert ok.dtype == torch.bool and tuple(ok.shape) == lead
    assert packed.shape == pages[0].shape
    assert tuple(base.shape) == (*lead, 2, 16)
