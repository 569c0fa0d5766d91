// K1 / K2: the CRAM-KV window pack (pair int8-delta 2:1, quad int4-delta 4:1),
// the registry's group pack, and K4 / K5: the group unpack.
//
// Replaces the Pallas kernels repro/kernels/bdi_pack.py:_pack_kernel
// (pack_pair) and _pack_quad_kernel (pack_quad), together with the vmap over
// (B, W) and the select/strip framing around them in
// repro/kernels/ops.py:pack_window / pack_quad_window.  One call computes
// the whole layout_window contract for a gathered window:
//
//   win (B, W, LANES, page, Hkv, D2) int16      -- LANES logical pages per group
//   marker_lanes (W, 2) int16, enabled (B,) u8   -- in-band markers, §VI gate
//   -> slots (B, W, page, Hkv, D2)               -- packed, or raw lane A
//      over  (B, W, LANES-1, page, Hkv, D2)      -- zeros where laid, else raw B..
//      strips (B, W, Hkv, D2+2)                  -- base row when enabled,
//                                                   marker tail only where laid
//      lay, fit (B, W) u8                        -- lay = fit & enabled[b]
//
// Fit is measured whatever the gate says (the §VI counter samples it).
//
// Bound on the H100: bytes.  Per group it reads LANES pages and writes
// LANES pages plus a strip, with a handful of integer operations per
// element, so the floor is (bytes read + bytes written) / 3.35 TB/s: 0.64 /
// 1.26 us (pair / quad) for the 8 groups of a decode step at the phi4 KV
// geometry.  At that size a call is bound by latency, and what sets it is
// how many loads are in flight at once: one CTA per group (the first
// design) put 8 CTAs on 132 SMs, each walking 128 / 256 KB twice.
//
// Design: every group is cut into `chunks` chunks of `chunk_vecs` whole
// 16-byte vectors (the last may be shorter), with chunk_vecs chosen in
// Python from the group count so that a decode step's window spreads over
// several CTAs per SM and a prefill window stays in one wave.  The fit is
// an AND over the whole group, so it crosses CTAs, and the call is two
// launches on one grid of (group, chunk) CTAs:
//   1. window_fit_kernel: each CTA checks every delta of its chunk against
//      the base row (lane A, token 0) and writes one flag per (group,
//      chunk), with no atomics and nothing zeroed first;
//   2. window_write_kernel: each CTA ANDs its group's flags, re-reads its
//      chunk (which pass 1 has just brought into L2) and writes every
//      output of it once: the chunks that hold lane A's token-0 row also
//      write it as the strip's base row, and chunk 0 writes the marker
//      tails and lay / fit.  (Chunk 0 writing the whole strip cost a chain
//      of dependent L2 loads per thread and most of the call.)
// Loads and stores are 16-byte vectors, neighbouring threads on
// neighbouring addresses.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WINDOW_THREADS = 64;   // threads of a window-pack CTA

union Vec8 {
  uint4 u;
  uint32_t w[4];
  int16_t h[8];
};

__device__ __forceinline__ Vec8 load8(const int16_t* p) {
  Vec8 v;
  v.u = *reinterpret_cast<const uint4*>(p);
  return v;
}

__device__ __forceinline__ void store8(int16_t* p, const Vec8& v) {
  *reinterpret_cast<uint4*>(p) = v.u;
}

// the vectors [v0, v1) of chunk blockIdx.x % chunks of group
// blockIdx.x / chunks, each group nvec (< 2^31) vectors long
struct Chunk {
  long long grp;
  int v0, v1;
  __device__ Chunk(int nvec, int chunk_vecs, int chunks) {
    grp = blockIdx.x / chunks;
    v0 = (int)(blockIdx.x % chunks) * chunk_vecs;
    v1 = min(v0 + chunk_vecs, nvec);
  }
};

template <int LANES>
__global__ void __launch_bounds__(WINDOW_THREADS)
window_fit_kernel(const int16_t* __restrict__ win, int rowvec, long long E,
                  int chunk_vecs, int chunks, uint8_t* __restrict__ flags) {
  constexpr int LO = LANES == 2 ? -128 : -8;
  constexpr int HI = LANES == 2 ? 127 : 7;
  const Chunk ck((int)(E / 8), chunk_vecs, chunks);
  const int16_t* g = win + ck.grp * LANES * E;
  int ok = 1;
#pragma unroll 4
  for (int v = ck.v0 + threadIdx.x; v < ck.v1; v += WINDOW_THREADS) {
    const Vec8 base = load8(g + (v % rowvec) * 8);
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const Vec8 x = load8(g + j * E + v * 8LL);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = (int)x.h[k] - (int)base.h[k];
        ok &= (d >= LO) & (d <= HI);
      }
    }
  }
  const int fits = __syncthreads_and(ok);
  if (threadIdx.x == 0) flags[blockIdx.x] = (uint8_t)fits;
}

template <int LANES>
__global__ void __launch_bounds__(WINDOW_THREADS)
window_write_kernel(const int16_t* __restrict__ win,
                    const int16_t* __restrict__ marker_lanes,
                    const uint8_t* __restrict__ enabled, int W, int hkv,
                    int d2, long long E, int chunk_vecs, int chunks,
                    const uint8_t* __restrict__ flags,
                    int16_t* __restrict__ slots, int16_t* __restrict__ over,
                    int16_t* __restrict__ strips, uint8_t* __restrict__ lay,
                    uint8_t* __restrict__ fit) {
  const Chunk ck((int)(E / 8), chunk_vecs, chunks);
  const int rowvec = hkv * d2 / 8;              // vectors of one token row
  const int srow = d2 + 2;
  const int16_t* g = win + ck.grp * LANES * E;

  int ok = 1;
  for (int i = threadIdx.x; i < chunks; i += WINDOW_THREADS)
    ok &= flags[ck.grp * chunks + i] != 0;
  const int fits = __syncthreads_and(ok);
  const int en = enabled[ck.grp / W] != 0;
  const int laid = fits & en;

  int16_t* out_slot = slots + ck.grp * E;
  int16_t* out_over = over + ck.grp * (LANES - 1) * E;
  int16_t* out_strip = strips + ck.grp * hkv * srow;
  for (int v = ck.v0 + threadIdx.x; v < ck.v1; v += WINDOW_THREADS) {
    const long long e = v * 8LL;
    const Vec8 a = load8(g + e);                 // lane A
    if (laid) {
      const Vec8 base = v < rowvec ? a : load8(g + (v % rowvec) * 8);
      Vec8 x[LANES];
      x[0] = a;
#pragma unroll
      for (int j = 1; j < LANES; ++j) x[j] = load8(g + j * E + e);
      Vec8 packed;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < LANES; ++j) {
          const uint32_t d = (uint32_t)((int)x[j].h[k] - (int)base.h[k]);
          word |= LANES == 2 ? (d & 0xFFu) << (8 * j) : (d & 0xFu) << (4 * j);
        }
        packed.h[k] = (int16_t)(uint16_t)word;
      }
      store8(out_slot + e, packed);
      Vec8 zero;
      zero.u = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 1; j < LANES; ++j) store8(out_over + (j - 1) * E + e, zero);
    } else {
      store8(out_slot + e, a);
#pragma unroll
      for (int j = 1; j < LANES; ++j)
        store8(out_over + (j - 1) * E + e, load8(g + j * E + e));
    }
    if (v < rowvec) {   // lane A's token-0 row: the strip's base row when
                        // enabled, as 4-byte words (a strip row is 2 d2 + 4
                        // bytes, so 4-byte aligned)
      const int h = v * 8 / d2;
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(out_strip + h * srow + v * 8 - h * d2);
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = en ? a.w[k] : 0u;
    }
  }
  if (ck.v0 != 0) return;

  // chunk 0: each head's marker tail (only where laid) and lay / fit
  const uint32_t tail =
      laid ? (uint32_t)(uint16_t)marker_lanes[(ck.grp % W) * 2] |
                 (uint32_t)(uint16_t)marker_lanes[(ck.grp % W) * 2 + 1] << 16
           : 0u;
  for (int h = threadIdx.x; h < hkv; h += WINDOW_THREADS)
    *reinterpret_cast<uint32_t*>(out_strip + h * srow + d2) = tail;
  if (threadIdx.x == 0) {
    lay[ck.grp] = (uint8_t)laid;
    fit[ck.grp] = (uint8_t)fits;
  }
}

// ---------------------------------------------------------------------------
// The page codecs' device pair (compression/codecs.py: int8-delta, int4-delta)
//
// cram_pack_pages replaces the Pallas kernels repro/kernels/bdi_pack.py
// _pack_kernel / _pack_quad_kernel as the registry calls them (pack_pair,
// pack_quad): G groups of LANES (page, Hkv, D2) int16 pages -> packed
// (G, page, Hkv, D2), base (G, Hkv, D2) = lane A's token-0 row, ok (G,) as
// one byte 0 / 1 (a torch bool).  Unlike the window pack, the truncated
// deltas are written whatever ok says, as the reference does.
//
// cram_unpack_pages replaces repro/kernels/bdi_pack.py:_unpack_kernel
// (unpack_pair, K4) and _unpack_quad_kernel (unpack_quad, K5): packed
// (G, page, Hkv, D2) + base (G, Hkv, D2) -> out (LANES, G, page, Hkv, D2),
// each lane's signed delta (int8 or int4, sign-extended in 32 bits) added
// to the base and wrapped to int16.
//
// Bound on the H100: bytes (a few integer operations per element).  The
// unpack is elementwise over 16-byte vectors, neighbouring threads on
// neighbouring addresses, in a grid-stride loop over all G groups.
//
// The pack's fit is an AND over a whole group, which a small call must
// spread over several CTAs to keep enough loads in flight (46 groups of
// 128 KB at the serve caches).  Design: one launch, each group a thread-
// block cluster of C CTAs (C in 1, 2, 4, 8 and the vectors per CTA from
// bdi_pack.group_cluster in Python: C grows while the call has fewer
// CTAs than SMs, so a large call runs one CTA a group).  Each CTA packs
// its chunk of the group, ANDs its fit with __syncthreads_and, and writes
// it into rank 0's shared memory (distributed shared memory) once a first
// cluster barrier, arrived on at entry, shows every CTA of the cluster
// started; after a second barrier rank 0 writes ok once, so nothing is
// filled before the launch and nothing is converted after it.  Groups sit
// on grid x (G * C CTAs), so G is not bounded by grid y.
// A thread loads every lane of 16 / LANES vectors (sixteen 16-byte loads:
// 8 vectors for a pair, 4 for a quad) before it packs any, neighbouring
// threads on neighbouring vectors (with 8 / LANES, one CTA a group ran
// 2-3% slower on 1,024 groups of 128 KB).  Where the CTA's chunk starts on a
// token row and the thread stride is a whole number of rows, each thread
// packs against one base vector, read once; otherwise the base vector is
// read per vector at v % rowvec.

constexpr int PACK_THREADS = 256;   // threads of a group-pack CTA
constexpr int MAX_CLUSTER = 8;      // the portable cluster size

template <int LANES>
__device__ __forceinline__ Vec8 pack_vec(const Vec8 (&x)[LANES],
                                         const Vec8& b, int& good) {
  constexpr int LO = LANES == 2 ? -128 : -8;
  constexpr int HI = LANES == 2 ? 127 : 7;
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int d = (int)x[j].h[k] - (int)b.h[k];
      good &= (d >= LO) & (d <= HI);
      word |= LANES == 2 ? ((uint32_t)d & 0xFFu) << (8 * j)
                         : ((uint32_t)d & 0xFu) << (4 * j);
    }
    out.h[k] = (int16_t)(uint16_t)word;
  }
  return out;
}

// the vectors [v0, v1) of one group: src[j] is lane j's page, dst the
// packed page, base_out the group's base row.  ROW: v % rowvec is the
// thread's own threadIdx.x % rowvec throughout, so the base is read once.
template <int LANES, bool ROW>
__device__ __forceinline__ int pack_chunk(const int16_t* const (&src)[LANES],
                                          int v0, int v1, int rowvec,
                                          int16_t* __restrict__ dst,
                                          int16_t* __restrict__ base_out) {
  constexpr int U = 16 / LANES;
  int good = 1;
  Vec8 own;
  if (ROW) own = load8(src[0] + (threadIdx.x % rowvec) * 8);
  for (int v = v0 + threadIdx.x; v < v1; v += U * PACK_THREADS) {
    Vec8 x[U][LANES];
    Vec8 b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = v + u * PACK_THREADS;
      if (w < v1) {
#pragma unroll
        for (int j = 0; j < LANES; ++j) x[u][j] = load8(src[j] + w * 8LL);
        if (!ROW) b[u] = load8(src[0] + (w % rowvec) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = v + u * PACK_THREADS;
      if (w < v1) {
        const Vec8& bu = ROW ? own : b[u];
        store8(dst + w * 8LL, pack_vec<LANES>(x[u], bu, good));
        if (!ROW && w < rowvec) store8(base_out + w * 8, bu);
      }
    }
  }
  // stored last, so that no thread waits on its base before its loads
  if (ROW && v0 == 0 && (int)threadIdx.x < rowvec)
    store8(base_out + threadIdx.x * 8, own);
  return good;
}

template <int LANES>
__global__ void __launch_bounds__(PACK_THREADS)
pack_pages_kernel(const int16_t* __restrict__ p0,
                  const int16_t* __restrict__ p1,
                  const int16_t* __restrict__ p2,
                  const int16_t* __restrict__ p3, int evec, int rowvec,
                  int cluster_size, int chunk_vecs,
                  int16_t* __restrict__ packed, int16_t* __restrict__ base,
                  uint8_t* __restrict__ ok) {
  __shared__ int fit[MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  // arrive on the cluster barrier at once and wait on it only before the
  // remote store: distributed shared memory may be touched only once every
  // CTA of the cluster has started, and the pack does not wait for that
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const long long g = blockIdx.x / cluster_size;
  const long long e0 = g * evec * 8LL;               // the group's element 0
  const int16_t* const all[4] = {p0, p1, p2, p3};
  const int16_t* src[LANES];
#pragma unroll
  for (int j = 0; j < LANES; ++j) src[j] = all[j] + e0;
  const int v0 = rank * chunk_vecs;
  const int v1 = min(v0 + chunk_vecs, evec);
  int16_t* dst = packed + e0;
  int16_t* base_out = base + g * rowvec * 8LL;
  const int good =
      PACK_THREADS % rowvec == 0 && v0 % rowvec == 0
          ? pack_chunk<LANES, true>(src, v0, v1, rowvec, dst, base_out)
          : pack_chunk<LANES, false>(src, v0, v1, rowvec, dst, base_out);
  const int fits = __syncthreads_and(good);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x == 0) *cluster.map_shared_rank(&fit[rank], 0) = fits;
  cluster.sync();   // every CTA's flag is in rank 0's fit[]; none exits before
  if (rank == 0 && threadIdx.x == 0) {
    int all_fit = 1;
    for (int r = 0; r < cluster_size; ++r) all_fit &= fit[r];
    ok[g] = (uint8_t)all_fit;
  }
}

template <int LANES>
__global__ void unpack_pages_kernel(const int16_t* __restrict__ packed,
                                    const int16_t* __restrict__ base,
                                    long long nvec, long long evec, int rowvec,
                                    int16_t* __restrict__ out) {
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long g = v / evec;
    const Vec8 p = load8(packed + v * 8);
    const Vec8 b = load8(base + (g * rowvec + (v % evec) % rowvec) * 8);
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      Vec8 o;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t u = (uint32_t)(uint16_t)p.h[k];
        const int delta = LANES == 2
                              ? (int)(int8_t)(uint8_t)((u >> (8 * j)) & 0xFFu)
                              : ((int)((u >> (4 * j)) & 0xFu) ^ 8) - 8;
        o.h[k] = (int16_t)(uint16_t)(uint32_t)((int)b.h[k] + delta);
      }
      store8(out + j * nvec * 8 + v * 8, o);
    }
  }
}

unsigned grid_for(long long nvec, int threads) {
  const long long blocks = (nvec + threads - 1) / threads;
  return (unsigned)(blocks < 65535LL * 32 ? blocks : 65535LL * 32);
}

// the two passes of the window pack on one grid of (group, chunk) CTAs
template <int LANES>
int launch_window(const void* win, const void* marker_lanes,
                  const void* enabled, int W, int hkv, int d2, long long E,
                  int chunk_vecs, int chunks, long long ctas, void* flags,
                  void* slots, void* over, void* strips, void* lay, void* fit,
                  cudaStream_t s) {
  const int16_t* w = (const int16_t*)win;
  window_fit_kernel<LANES><<<(unsigned)ctas, WINDOW_THREADS, 0, s>>>(
      w, hkv * d2 / 8, E, chunk_vecs, chunks, (uint8_t*)flags);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  window_write_kernel<LANES><<<(unsigned)ctas, WINDOW_THREADS, 0, s>>>(
      w, (const int16_t*)marker_lanes, (const uint8_t*)enabled, W, hkv, d2, E,
      chunk_vecs, chunks, (const uint8_t*)flags, (int16_t*)slots,
      (int16_t*)over, (int16_t*)strips, (uint8_t*)lay, (uint8_t*)fit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cram_layout_window(const void* win, const void* marker_lanes,
                                  const void* enabled, int B, int W, int lanes,
                                  int page, int hkv, int d2, int chunk_vecs,
                                  int chunks, void* flags, void* slots,
                                  void* over, void* strips, void* lay,
                                  void* fit, void* stream) {
  const long long E = (long long)page * hkv * d2;   // elements of one page
  const long long nvec = E / 8;
  const long long ctas = (long long)B * W * chunks;
  if (B <= 0 || W <= 0 || page <= 0 || hkv <= 0 || d2 <= 0 || d2 % 8 != 0 ||
      nvec > 0x7fffffffLL || chunk_vecs <= 0 ||
      chunks != (nvec + chunk_vecs - 1) / chunk_vecs ||
      ctas > 0x7fffffffLL || (lanes != 2 && lanes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return lanes == 2
             ? launch_window<2>(win, marker_lanes, enabled, W, hkv, d2, E,
                                chunk_vecs, chunks, ctas, flags, slots, over,
                                strips, lay, fit, s)
             : launch_window<4>(win, marker_lanes, enabled, W, hkv, d2, E,
                                chunk_vecs, chunks, ctas, flags, slots, over,
                                strips, lay, fit, s);
}

extern "C" int cram_pack_pages(const void* page_a, const void* page_b,
                               const void* page_c, const void* page_d, int G,
                               int lanes, int page, int hkv, int d2,
                               int cluster, int chunk_vecs, void* packed,
                               void* base, void* ok, void* stream) {
  const long long rowvec = (long long)hkv * d2 / 8;
  const long long evec = page * rowvec;
  // every vector of a group in exactly one chunk, no chunk empty, and
  // vector indices well inside int
  if (G <= 0 || page <= 0 || hkv <= 0 || d2 <= 0 || d2 % 8 != 0 ||
      evec > (1LL << 30) || (lanes != 2 && lanes != 4) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      chunk_vecs <= 0 || (long long)chunk_vecs * cluster < evec ||
      (long long)chunk_vecs * (cluster - 1) >= evec ||
      (long long)G * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)G * cluster), 1, 1);
  cfg.blockDim = dim3(PACK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int16_t* a = (const int16_t*)page_a;
  const int16_t* b = (const int16_t*)page_b;
  const int16_t* c = (const int16_t*)page_c;
  const int16_t* d = (const int16_t*)page_d;
  const cudaError_t err =
      lanes == 2
          ? cudaLaunchKernelEx(&cfg, pack_pages_kernel<2>, a, b, c, d,
                               (int)evec, (int)rowvec, cluster, chunk_vecs,
                               (int16_t*)packed, (int16_t*)base,
                               (uint8_t*)ok)
          : cudaLaunchKernelEx(&cfg, pack_pages_kernel<4>, a, b, c, d,
                               (int)evec, (int)rowvec, cluster, chunk_vecs,
                               (int16_t*)packed, (int16_t*)base,
                               (uint8_t*)ok);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

extern "C" int cram_unpack_pages(const void* packed, const void* base, int G,
                                 int lanes, int page, int hkv, int d2,
                                 void* out, void* stream) {
  if (G <= 0 || page <= 0 || hkv <= 0 || d2 <= 0 || d2 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int rowvec = hkv * d2 / 8;
  const long long evec = (long long)page * rowvec;
  const long long nvec = (long long)G * evec;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 2) {
    unpack_pages_kernel<2><<<grid_for(nvec, threads), threads, 0, s>>>(
        (const int16_t*)packed, (const int16_t*)base, nvec, evec, rowvec,
        (int16_t*)out);
  } else if (lanes == 4) {
    unpack_pages_kernel<4><<<grid_for(nvec, threads), threads, 0, s>>>(
        (const int16_t*)packed, (const int16_t*)base, nvec, evec, rowvec,
        (int16_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
