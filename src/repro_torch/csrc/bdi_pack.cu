// K1 / K2: the CRAM-KV window pack (pair int8-delta 2:1, quad int4-delta 4:1).
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
