// K1 / K2: the CRAM-KV window pack (pair int8-delta 2:1, quad int4-delta 4:1),
// the registry's group pack, and K4 / K5: the group unpack.
//
// Replaces the Pallas kernels repro/kernels/bdi_pack.py:_pack_kernel
// (pack_pair) and _pack_quad_kernel (pack_quad), together with the vmap over
// (B, W) and the select/strip framing around them in
// repro/kernels/ops.py:pack_window / pack_quad_window.  One launch computes
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
// element, so the floor is (bytes read + bytes written) / 3.35 TB/s.
// Design: one CTA per (b, w) group; 16-byte vector loads and stores with
// neighbouring threads on neighbouring addresses; the fit is an AND-reduction
// over the CTA (__syncthreads_and); the second pass re-reads the group, which
// the first pass has just brought into L2, and writes every output once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

union Vec8 {
  uint4 u;
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

template <int LANES>
__global__ void layout_window_kernel(const int16_t* __restrict__ win,
                                     const int16_t* __restrict__ marker_lanes,
                                     const uint8_t* __restrict__ enabled,
                                     int W, int page, int hkv, int d2,
                                     int16_t* __restrict__ slots,
                                     int16_t* __restrict__ over,
                                     int16_t* __restrict__ strips,
                                     uint8_t* __restrict__ lay,
                                     uint8_t* __restrict__ fit) {
  constexpr int LO = LANES == 2 ? -128 : -8;
  constexpr int HI = LANES == 2 ? 127 : 7;
  const int w = blockIdx.x;
  const int b = blockIdx.y;
  const long long grp = (long long)b * W + w;
  const int row = hkv * d2;                       // elements of one token row
  const long long E = (long long)page * row;      // elements of one page
  const long long nvec = E / 8;
  const int16_t* g = win + grp * LANES * E;

  // pass 1: every delta of every lane against the base row (lane A, token 0)
  int ok = 1;
  for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
    const long long e = v * 8;
    const Vec8 base = load8(g + e % row);
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const Vec8 x = load8(g + j * E + e);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = (int)x.h[k] - (int)base.h[k];
        ok &= (d >= LO) & (d <= HI);
      }
    }
  }
  const int fits = __syncthreads_and(ok);
  const int en = enabled[b] != 0;
  const int laid = fits & en;

  // pass 2: slots / overflow
  int16_t* out_slot = slots + grp * E;
  int16_t* out_over = over + grp * (LANES - 1) * E;
  for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
    const long long e = v * 8;
    if (laid) {
      const Vec8 base = load8(g + e % row);
      Vec8 x[LANES];
#pragma unroll
      for (int j = 0; j < LANES; ++j) x[j] = load8(g + j * E + e);
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
      store8(out_slot + e, load8(g + e));
#pragma unroll
      for (int j = 1; j < LANES; ++j)
        store8(out_over + (j - 1) * E + e, load8(g + j * E + e));
    }
  }

  // strips: base row whenever enabled, marker tail only where laid
  const int srow = d2 + 2;
  int16_t* out_strip = strips + grp * hkv * srow;
  for (int i = threadIdx.x; i < hkv * srow; i += blockDim.x) {
    const int h = i / srow;
    const int c = i % srow;
    int16_t val = 0;
    if (en) {
      if (c < d2)
        val = g[h * d2 + c];
      else if (laid)
        val = marker_lanes[w * 2 + (c - d2)];
    }
    out_strip[i] = val;
  }
  if (threadIdx.x == 0) {
    lay[grp] = (uint8_t)laid;
    fit[grp] = (uint8_t)fits;
  }
}

// ---------------------------------------------------------------------------
// The page codecs' device pair (compression/codecs.py: int8-delta, int4-delta)
//
// cram_pack_pages replaces the Pallas kernels repro/kernels/bdi_pack.py
// _pack_kernel / _pack_quad_kernel as the registry calls them (pack_pair,
// pack_quad): G groups of LANES (page, Hkv, D2) int16 pages -> packed
// (G, page, Hkv, D2), base (G, Hkv, D2) = lane A's token-0 row, ok (G,).
// Unlike the window pack, the truncated deltas are written whatever ok
// says, as the reference does.
//
// cram_unpack_pages replaces repro/kernels/bdi_pack.py:_unpack_kernel
// (unpack_pair, K4) and _unpack_quad_kernel (unpack_quad, K5): packed
// (G, page, Hkv, D2) + base (G, Hkv, D2) -> out (LANES, G, page, Hkv, D2),
// each lane's signed delta (int8 or int4, sign-extended in 32 bits) added
// to the base and wrapped to int16.
//
// Bound on the H100: bytes (a few integer operations per element).  Design:
// elementwise over 16-byte vectors, neighbouring threads on neighbouring
// addresses; a grid-stride loop over all G groups in one launch; the pack's
// fit flag is an AND over the CTA, then a store of 0 by any CTA that saw a
// delta out of range (ok starts at 1).

template <int LANES>
__global__ void pack_pages_kernel(const int16_t* __restrict__ p0,
                                  const int16_t* __restrict__ p1,
                                  const int16_t* __restrict__ p2,
                                  const int16_t* __restrict__ p3,
                                  long long evec, int rowvec,
                                  int16_t* __restrict__ packed,
                                  int16_t* __restrict__ base,
                                  int32_t* __restrict__ ok) {
  constexpr int LO = LANES == 2 ? -128 : -8;
  constexpr int HI = LANES == 2 ? 127 : 7;
  const int16_t* pages[4] = {p0, p1, p2, p3};
  const long long g = blockIdx.y;
  int good = 1;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < evec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long e = (g * evec + v) * 8;
    const Vec8 b = load8(p0 + (g * evec + v % rowvec) * 8);
    uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const Vec8 x = load8(pages[j] + e);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = (int)x.h[k] - (int)b.h[k];
        good &= (d >= LO) & (d <= HI);
        word[k] |= LANES == 2 ? ((uint32_t)d & 0xFFu) << (8 * j)
                              : ((uint32_t)d & 0xFu) << (4 * j);
      }
    }
    Vec8 out;
#pragma unroll
    for (int k = 0; k < 8; ++k) out.h[k] = (int16_t)(uint16_t)word[k];
    store8(packed + e, out);
    if (v < rowvec) store8(base + (g * rowvec + v) * 8, b);
  }
  if (!__syncthreads_and(good) && threadIdx.x == 0) ok[g] = 0;
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

}  // namespace

extern "C" int cram_layout_window(const void* win, const void* marker_lanes,
                                  const void* enabled, int B, int W, int lanes,
                                  int page, int hkv, int d2, void* slots,
                                  void* over, void* strips, void* lay,
                                  void* fit, void* stream) {
  const dim3 grid(W, B);
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const int16_t* w = (const int16_t*)win;
  const int16_t* m = (const int16_t*)marker_lanes;
  const uint8_t* e = (const uint8_t*)enabled;
  if (lanes == 2) {
    layout_window_kernel<2><<<grid, threads, 0, s>>>(
        w, m, e, W, page, hkv, d2, (int16_t*)slots, (int16_t*)over,
        (int16_t*)strips, (uint8_t*)lay, (uint8_t*)fit);
  } else if (lanes == 4) {
    layout_window_kernel<4><<<grid, threads, 0, s>>>(
        w, m, e, W, page, hkv, d2, (int16_t*)slots, (int16_t*)over,
        (int16_t*)strips, (uint8_t*)lay, (uint8_t*)fit);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int cram_pack_pages(const void* page_a, const void* page_b,
                               const void* page_c, const void* page_d, int G,
                               int lanes, int page, int hkv, int d2,
                               void* packed, void* base, void* ok,
                               void* stream) {
  if (G <= 0 || G > 65535 || page <= 0 || hkv <= 0 || d2 <= 0 || d2 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int rowvec = hkv * d2 / 8;
  const long long evec = (long long)page * rowvec;
  const dim3 grid(grid_for(evec, threads), G);
  cudaStream_t s = (cudaStream_t)stream;
  const int16_t* a = (const int16_t*)page_a;
  const int16_t* b = (const int16_t*)page_b;
  if (lanes == 2) {
    pack_pages_kernel<2><<<grid, threads, 0, s>>>(
        a, b, nullptr, nullptr, evec, rowvec, (int16_t*)packed,
        (int16_t*)base, (int32_t*)ok);
  } else if (lanes == 4) {
    pack_pages_kernel<4><<<grid, threads, 0, s>>>(
        a, b, (const int16_t*)page_c, (const int16_t*)page_d, evec, rowvec,
        (int16_t*)packed, (int16_t*)base, (int32_t*)ok);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
