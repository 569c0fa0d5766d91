// K3: batched decode attention over the CRAM-packed paged KV cache, and
// K6: the single-sequence decode over one sequence's physical slots.
//
// K3 replaces the Pallas kernel repro/kernels/cram_attention.py:_batched_kernel
// (cram_decode_attention_batched).  Inputs are the flat physical view that
// kernels/ops.py:physical_view / physical_view_quad builds:
//
//   q (B, Hq, D) f32; slots (Bc, n, page, Hkv, D2) i16; strips (Bc, n, Hkv,
//   D2+2) i16; markers (n,) i32; valid (Bc, n, LANES) i32; pred (Bc, n/LANES)
//   i32, with Bc = 1 for a shared cache and B otherwise
//   -> out (B, Hq, D) f32 and bytes (B, 2) i32 = (raw, cram) bytes the step
//      moves for exactly the layout walked, LLP re-probe included.
//
// K6 replaces repro/kernels/cram_attention.py:_kernel (cram_decode_attention,
// grid=(n,)): q (Hq, D) f32 and one sequence's slots (n, page, Hkv, D2),
// strips, markers (n,), valid (n, LANES) -> out (Hq, D) f32, with no
// predictor and no bytes, at any n (n need not be a multiple of LANES).
// Its entry shares K3's device body (decode_split) and merge kernel.
//
// Per flat slot: the marker check over all Hkv strip tails (uint32 compare),
// the delta decode of the head's LANES pages, the split of bf16 K||V, the
// valid mask, and an f32 online softmax.  Masked scores are -1e30 as in the
// reference, so a sequence with no valid token at all averages V over the
// masked positions; when the sequence has a valid token, masked positions
// contribute exactly 0 and are skipped without being read.
//
// Bound on the H100: bytes.  Decoding is a few integer operations per
// element and the products are G = Hq/Hkv dot products of length D per
// token, far below the card's operations-per-byte balance, so the floor is
// the live slot rows + strips + q / 3.35 TB/s.  Design: a grid of
// (B, Hkv, splits); each CTA owns the G query heads of one KV head and
// walks kk flat slots (the last split may be shorter), so the split width
// only changes the order of the float sums.  Each warp takes a token row,
// loads it once (D/32 elements of K and of V per lane) and decodes all LANES
// pages from it in registers; the scores reduce with warp shuffles; every
// warp keeps its own online-softmax state, the warps are merged through
// shared memory and a second small kernel merges the splits.  K3's byte
// pair is summed in integers by thread 0 of the head-0 CTAs and added with
// atomicAdd.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXG = 8;        // query heads per KV head
constexpr int WARPS = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_bits(int x) {
  return __uint_as_float(((uint32_t)x & 0xFFFFu) << 16);
}

template <int LANES>
__device__ __forceinline__ int decode_lane(int raw, int base, int j, bool packed) {
  if (!packed) return j == 0 ? raw : 0;
  const uint32_t u = (uint32_t)raw & 0xFFFFu;
  int delta;
  if (LANES == 2) {
    delta = (int)(int8_t)(uint8_t)((u >> (8 * j)) & 0xFFu);
  } else {
    const int nib = (int)((u >> (4 * j)) & 0xFu);
    delta = (nib ^ 8) - 8;
  }
  return (int)(int16_t)(uint16_t)(uint32_t)(base + delta);
}

// One CTA's split: query heads h*G .. h*G+G-1 of sequence b (cache row bs)
// over the flat slots [j*kk, min((j+1)*kk, n)); BYTES adds K3's byte pair.
template <int LANES, int DPL, bool BYTES>
__device__ __forceinline__ void decode_split(
    const float* __restrict__ q, const int16_t* __restrict__ slots,
    const int16_t* __restrict__ strips, const int32_t* __restrict__ markers,
    const int32_t* __restrict__ valid, const int32_t* __restrict__ pred, int b,
    int bs, int h, int j, int nj, int n, int page, int hkv, int G, int kk,
    float scale, int slot_bytes, int strip_bytes, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int32_t* __restrict__ bytes) {
  constexpr int D = 32 * DPL;
  constexpr int D2 = 2 * D;
  const int hq = hkv * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int srow = D2 + 2;

  float qr[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int k = 0; k < DPL; ++k)
      qr[g][k] = g < G ? q[((long long)b * hq + h * G + g) * D + lane * DPL + k] : 0.f;

  const int32_t* vseq = valid + (long long)bs * n * LANES;
  int any = 0;
  for (int i = tid; i < n * LANES; i += blockDim.x) any |= vseq[i] > 0;
  const bool skip_masked = __syncthreads_or(any) != 0;

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[g][k] = 0.f;
  }
  uint32_t raw_b = 0, cram_b = 0;

  const int s_end = min((j + 1) * kk, n);
  for (int s = j * kk; s < s_end; ++s) {
    const int16_t* st = strips + ((long long)bs * n + s) * hkv * srow;
    int ok = 1;
    for (int hh = tid; hh < hkv; hh += blockDim.x) {
      const uint32_t lo = (uint16_t)st[hh * srow + D2];
      const uint32_t hi = (uint16_t)st[hh * srow + D2 + 1];
      ok &= (lo | (hi << 16)) == (uint32_t)markers[s];
    }
    const bool packed = __syncthreads_and(ok) != 0;
    int vc[LANES];
    int top = 0;
#pragma unroll
    for (int q2 = 0; q2 < LANES; ++q2) {
      vc[q2] = vseq[s * LANES + q2];
      top = max(top, vc[q2]);
    }
    if (BYTES && h == 0 && tid == 0) {
      // flat-slot form of the ops.hbm_bytes_moved group model
      uint32_t n_live = 0;
#pragma unroll
      for (int q2 = 0; q2 < LANES; ++q2) n_live += vc[q2] > 0;
      raw_b += n_live * (uint32_t)slot_bytes;
      cram_b += (packed && n_live > 0)
                    ? (uint32_t)(slot_bytes + strip_bytes)
                    : n_live * (uint32_t)(slot_bytes + strip_bytes);
      if (s % LANES == 0) {   // lead slot: one re-probe per mispredicted live group
        int glive = 0;
        for (int q2 = 0; q2 < LANES * LANES; ++q2) glive |= vseq[s * LANES + q2] > 0;
        const bool p = pred[(long long)bs * (n / LANES) + s / LANES] != 0;
        if (glive && p != packed) cram_b += (uint32_t)slot_bytes;
      }
    }
    const int t_end = skip_masked ? min(top, page) : page;
    if (t_end == 0) continue;
    int bk[DPL], bv[DPL];
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      bk[k] = st[h * srow + lane * DPL + k];
      bv[k] = st[h * srow + D + lane * DPL + k];
    }
    for (int t = warp; t < t_end; t += WARPS) {
      const int16_t* rowp =
          slots + (((long long)bs * n + s) * page + t) * hkv * D2 + h * D2;
      int rk[DPL], rv[DPL];
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        rk[k] = rowp[lane * DPL + k];
        rv[k] = rowp[D + lane * DPL + k];
      }
#pragma unroll
      for (int jj = 0; jj < LANES; ++jj) {
        const bool live = t < vc[jj];
        if (!live && skip_masked) continue;
        float kf[DPL], vf[DPL];
#pragma unroll
        for (int k = 0; k < DPL; ++k) {
          kf[k] = bf16_bits(decode_lane<LANES>(rk[k], bk[k], jj, packed));
          vf[k] = bf16_bits(decode_lane<LANES>(rv[k], bv[k], jj, packed));
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < DPL; ++k) part += qr[g][k] * kf[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          const float sc = live ? part * scale : NEG_INF;
          const float m_new = fmaxf(m[g], sc);
          const float alpha = __expf(m[g] - m_new);
          const float p = __expf(sc - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[g][k] = acc[g][k] * alpha + p * vf[k];
          m[g] = m_new;
        }
      }
    }
  }

  if (BYTES && h == 0 && tid == 0) {
    atomicAdd(reinterpret_cast<unsigned int*>(bytes + 2 * b), raw_b);
    atomicAdd(reinterpret_cast<unsigned int*>(bytes + 2 * b + 1), cram_b);
  }

  // merge the warps' online-softmax states
  __shared__ float sm_m[WARPS][MAXG];
  __shared__ float sm_l[WARPS][MAXG];
  __shared__ float sm_acc[WARPS][MAXG][D];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int k = 0; k < DPL; ++k) sm_acc[warp][g][lane * DPL + k] = acc[g][k];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      asum += sm_acc[w][g][d] * f;
    }
    const long long idx = ((long long)b * hq + h * G + g) * nj + j;
    part_acc[idx * D + d] = asum;
    if (d == 0) {
      part_m[idx] = mx;
      part_l[idx] = lsum;
    }
  }
}

template <int LANES, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
cram_decode_kernel(const float* __restrict__ q, const int16_t* __restrict__ slots,
                   const int16_t* __restrict__ strips,
                   const int32_t* __restrict__ markers,
                   const int32_t* __restrict__ valid,
                   const int32_t* __restrict__ pred, int n, int page, int hkv,
                   int G, int kk, int shared, float scale, int slot_bytes,
                   int strip_bytes, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int32_t* __restrict__ bytes) {
  const int b = blockIdx.x;
  decode_split<LANES, DPL, true>(q, slots, strips, markers, valid, pred, b,
                                 shared ? 0 : b, blockIdx.y, blockIdx.z,
                                 gridDim.z, n, page, hkv, G, kk, scale,
                                 slot_bytes, strip_bytes, part_m, part_l,
                                 part_acc, bytes);
}

template <int LANES, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
cram_decode_single_kernel(const float* __restrict__ q,
                          const int16_t* __restrict__ slots,
                          const int16_t* __restrict__ strips,
                          const int32_t* __restrict__ markers,
                          const int32_t* __restrict__ valid, int n, int page,
                          int hkv, int G, int kk, float scale,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc) {
  decode_split<LANES, DPL, false>(q, slots, strips, markers, valid, nullptr, 0,
                                  0, blockIdx.x, blockIdx.y, gridDim.y, n,
                                  page, hkv, G, kk, scale, 0, 0, part_m,
                                  part_l, part_acc, nullptr);
}

__global__ void cram_decode_combine(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc, int nj,
                                    int D, float* __restrict__ out) {
  const long long bh = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = NEG_INF;
    for (int j = 0; j < nj; ++j) mx = fmaxf(mx, part_m[bh * nj + j]);
    float lsum = 0.f, asum = 0.f;
    for (int j = 0; j < nj; ++j) {
      const float f = expf(part_m[bh * nj + j] - mx);
      lsum += part_l[bh * nj + j] * f;
      asum += part_acc[(bh * nj + j) * D + d] * f;
    }
    out[bh * D + d] = asum / fmaxf(lsum, 1e-30f);
  }
}

template <int LANES>
int launch_lanes(int dpl, dim3 grid, cudaStream_t s, const float* q,
                 const int16_t* slots, const int16_t* strips,
                 const int32_t* markers, const int32_t* valid,
                 const int32_t* pred, int n, int page, int hkv, int G, int kk,
                 int shared, float scale, int slot_bytes, int strip_bytes,
                 float* pm, float* pl, float* pa, int32_t* bytes) {
#define CRAM_LAUNCH(DPL)                                                       \
  cram_decode_kernel<LANES, DPL><<<grid, WARPS * 32, 0, s>>>(                 \
      q, slots, strips, markers, valid, pred, n, page, hkv, G, kk, shared,     \
      scale, slot_bytes, strip_bytes, pm, pl, pa, bytes)
  switch (dpl) {             // head_dim 64 or 128
    case 2: CRAM_LAUNCH(2); break;
    case 4: CRAM_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CRAM_LAUNCH
  return 0;
}

}  // namespace

extern "C" int cram_decode_attention(const void* q, const void* slots,
                                     const void* strips, const void* markers,
                                     const void* valid, const void* pred, int B,
                                     int hq, int D, int n, int page, int hkv,
                                     int lanes, int kk, int shared, float scale,
                                     int slot_bytes, int strip_bytes,
                                     void* part_m, void* part_l, void* part_acc,
                                     void* out, void* bytes, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAXG || D % 32 != 0 || kk <= 0 ||
      n % kk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = hq / hkv;
  const int nj = n / kk;
  const dim3 grid(B, hkv, nj);
  const int dpl = D / 32;
  int err;
  if (lanes == 2)
    err = launch_lanes<2>(dpl, grid, s, (const float*)q, (const int16_t*)slots,
                          (const int16_t*)strips, (const int32_t*)markers,
                          (const int32_t*)valid, (const int32_t*)pred, n, page,
                          hkv, G, kk, shared, scale, slot_bytes, strip_bytes,
                          (float*)part_m, (float*)part_l, (float*)part_acc,
                          (int32_t*)bytes);
  else if (lanes == 4)
    err = launch_lanes<4>(dpl, grid, s, (const float*)q, (const int16_t*)slots,
                          (const int16_t*)strips, (const int32_t*)markers,
                          (const int32_t*)valid, (const int32_t*)pred, n, page,
                          hkv, G, kk, shared, scale, slot_bytes, strip_bytes,
                          (float*)part_m, (float*)part_l, (float*)part_acc,
                          (int32_t*)bytes);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err) return err;
  cram_decode_combine<<<B * hq, D < 1024 ? D : 1024, 0, s>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc, nj, D,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int cram_decode_attention_single(const void* q, const void* slots,
                                            const void* strips,
                                            const void* markers,
                                            const void* valid, int hq, int D,
                                            int n, int page, int hkv, int lanes,
                                            int kk, float scale, void* part_m,
                                            void* part_l, void* part_acc,
                                            void* out, void* stream) {
  if (n <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > MAXG || kk <= 0 ||
      (D != 64 && D != 128) || (lanes != 2 && lanes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = hq / hkv;
  const int nj = (n + kk - 1) / kk;
  const dim3 grid(hkv, nj);
#define CRAM_SINGLE(LANES, DPL)                                                \
  cram_decode_single_kernel<LANES, DPL><<<grid, WARPS * 32, 0, s>>>(          \
      (const float*)q, (const int16_t*)slots, (const int16_t*)strips,          \
      (const int32_t*)markers, (const int32_t*)valid, n, page, hkv, G, kk,     \
      scale, (float*)part_m, (float*)part_l, (float*)part_acc)
  if (lanes == 2) {
    if (D == 64) CRAM_SINGLE(2, 2); else CRAM_SINGLE(2, 4);
  } else {
    if (D == 64) CRAM_SINGLE(4, 2); else CRAM_SINGLE(4, 4);
  }
#undef CRAM_SINGLE
  int err = (int)cudaGetLastError();
  if (err) return err;
  cram_decode_combine<<<hq, D, 0, s>>>((const float*)part_m,
                                       (const float*)part_l,
                                       (const float*)part_acc, nj, D,
                                       (float*)out);
  return (int)cudaGetLastError();
}
