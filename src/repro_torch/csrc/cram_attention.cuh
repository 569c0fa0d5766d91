// The device body of K3 / K6 (decode on the compressed cache), shared by
// cram_attention.cu (head_dim 64 and 128, fixed at compile time; the host
// entries) and cram_attention_general_{pair,quad}.cu (any other head_dim a
// multiple of 8 from 8 to 128), which compile in parallel.  The design
// note is at the top of cram_attention.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cram_att {

// the cache's own leaves as K3's in-place entry takes them: each batch
// stride in elements (0 for a shared cache), the rest of each leaf
// contiguous; pred and mask are bools
struct Leaves {
  const int16_t* over;
  const uint8_t* mask;
  long long sb_slots, sb_over, sb_strips, sb_mask, sb_valid, sb_pred;
};

// one call of K3 (batched) or K6 (single sequence) as the host entries
// receive it; pred and part_bytes are K3's only.  With `leaves` set (K3's
// in-place entry) slots, strips, markers, valid and pred are the cache's
// leaves (slots, strips, markers, valid_per_page, the bool predictor) and
// n is still the flat slot count, lanes x groups.
struct DecodeArgs {
  const float* q;
  const int16_t* slots;
  const int16_t* strips;
  const int32_t* markers;
  const int32_t* valid;
  const void* pred;
  int B, hq, D, n, page, hkv, lanes, kk, shared;
  float scale;
  int slot_bytes, strip_bytes;
  float* part_m;
  float* part_l;
  float* part_acc;
  int32_t* part_bytes;
  bool batched;
  const Leaves* leaves;
};

// the split kernel on the general body, pair and quad
// (cram_attention_general_pair.cu, cram_attention_general_quad.cu)
int launch_general_pair(const DecodeArgs& a, cudaStream_t s);
int launch_general_quad(const DecodeArgs& a, cudaStream_t s);

}  // namespace cram_att

namespace {

constexpr int MAXG = 8;        // query heads per KV head
constexpr int ROWS = 16;       // token rows per stage
constexpr int WIN = 32;        // slot descriptors per window (one per lane)
constexpr int HCHUNK = 8;      // strip tails loaded together
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

// GMAX rounded up to whole float4s: the row stride of the scores
template <int GMAX>
__host__ __device__ constexpr int gpad() { return (GMAX + 3) / 4 * 4; }

// (delta of page lane j) << 16, sign-extended, from a packed int16 value
template <int LANES>
__device__ __forceinline__ int delta16(int raw, int j) {
  if constexpr (LANES == 2) {   // bytes 0, 0, byte j of raw, its sign
    int d;
    asm("prmt.b32 %0, %1, 0, %2;"
        : "=r"(d)
        : "r"(raw), "r"(0x8044 | (j << 8) | (j << 12)));
    return d;
  } else {
    return ((raw << (28 - 4 * j)) >> 28) << 16;
  }
}

// page lane j of a packed value against its base (base16 = base << 16)
template <int LANES>
__device__ __forceinline__ float decode_lane(int raw, int base16, int j) {
  return __int_as_float(base16 + delta16<LANES>(raw, j));
}

__device__ __forceinline__ float raw_bf16(int raw) {
  return __int_as_float(raw << 16);
}

// the GMAX probabilities of one (row, page lane) from shared memory
template <int GMAX>
__device__ __forceinline__ void load_p(const float* src, float (&p)[GMAX]) {
#pragma unroll
  for (int c = 0; c < gpad<GMAX>() / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(src)[c];
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * c + i < GMAX) p[4 * c + i] = w[i];
  }
}

// Column of the padded head that a lane holds as its k-th element in the
// score phase: DPL consecutive columns (one aligned vector load), or for
// DPL 1 and 3 every 32nd column (conflict-free 2-byte loads).
template <int DPL>
__device__ __forceinline__ int kcol(int lane, int k) {
  return DPL == 2 || DPL == 4 ? lane * DPL + k : lane + 32 * k;
}

// a lane's DPL int16 of a staged row -> each value << 16
template <int DPL>
__device__ __forceinline__ void load_hi(const int16_t* row, int lane,
                                        int (&out)[DPL]) {
  if constexpr (DPL == 4) {
    const int2 v = *reinterpret_cast<const int2*>(row + lane * 4);
    out[0] = v.x << 16;
    out[1] = v.x & (int)0xFFFF0000;
    out[2] = v.y << 16;
    out[3] = v.y & (int)0xFFFF0000;
  } else if constexpr (DPL == 2) {
    const int v = *reinterpret_cast<const int*>(row + lane * 2);
    out[0] = v << 16;
    out[1] = v & (int)0xFFFF0000;
  } else {
#pragma unroll
    for (int k = 0; k < DPL; ++k) out[k] = ((int)row[kcol<DPL>(lane, k)]) << 16;
  }
}

// a lane's DPL int16 of a staged row -> sign-extended ints
template <int DPL>
__device__ __forceinline__ void load_i16(const int16_t* row, int lane,
                                         int (&out)[DPL]) {
  if constexpr (DPL == 4) {
    const int2 v = *reinterpret_cast<const int2*>(row + lane * 4);
    out[0] = (int)(int16_t)v.x;
    out[1] = v.x >> 16;
    out[2] = (int)(int16_t)v.y;
    out[3] = v.y >> 16;
  } else if constexpr (DPL == 2) {
    const int v = *reinterpret_cast<const int*>(row + lane * 2);
    out[0] = (int)(int16_t)v;
    out[1] = v >> 16;
  } else {
#pragma unroll
    for (int k = 0; k < DPL; ++k) out[k] = row[kcol<DPL>(lane, k)];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int LANES, int DPL, int GMAX>
struct Smem {
  static constexpr int D2 = 64 * DPL;
  int16_t tile[2][ROWS][D2];
  int16_t base[2][D2];
  float p[ROWS * LANES][gpad<GMAX>()];
  float wmax[DPL][GMAX];
  float lsum[GMAX];
  int top[WIN];
  int packed[WIN];
  int vc[WIN][LANES];
};

// Where flat slot s of cache row bs lives.  The body asks its addressing
// for a slot's page rows, its strip (nullptr: an all-zero strip row, made
// in shared memory), its marker, its LANES valid counts, whether the
// row has a valid token, whether the group led by slot s has one, and
// the predictor's verdict on group g.
//
// FlatSlots: the flat slot list of ops.physical_view (K3's flat entry
// and K6), one strip and one marker a slot.
template <int LANES>
struct FlatSlots {
  const int16_t* slots;
  const int16_t* strips;
  const int32_t* markers;
  const int32_t* valid;
  const int32_t* pred;
  int n;                                // flat slots a cache row
  long long slot_elems, strip_elems;    // page * Hkv * D2, Hkv * (D2 + 2)

  __device__ __forceinline__ const int16_t* slot(int bs, int s) const {
    return slots + ((long long)bs * n + s) * slot_elems;
  }
  __device__ __forceinline__ const int16_t* strip(int bs, int s) const {
    return strips + ((long long)bs * n + s) * strip_elems;
  }
  __device__ __forceinline__ uint32_t marker(int s) const {
    return (uint32_t)__ldg(markers + s);
  }
  __device__ __forceinline__ void counts(int bs, int s, int (&vc)[LANES]) const {
    const int32_t* v = valid + ((long long)bs * n + s) * LANES;
#pragma unroll
    for (int q = 0; q < LANES; ++q) vc[q] = __ldg(v + q);
  }
  __device__ __forceinline__ int any_live(int bs, int i0, int step) const {
    const int32_t* v = valid + (long long)bs * n * LANES;
    int any = 0;
    for (int i = i0; i < n * LANES; i += step) any |= __ldg(v + i) > 0;
    return any;
  }
  __device__ __forceinline__ bool group_live(int bs, int s) const {
    const int32_t* v = valid + ((long long)bs * n + s) * LANES;
    int live = 0;
#pragma unroll
    for (int q = 0; q < LANES * LANES; ++q) live |= __ldg(v + q) > 0;
    return live != 0;
  }
  __device__ __forceinline__ bool predicted(int bs, int g) const {
    return __ldg(pred + (long long)bs * (n / LANES) + g) != 0;
  }
};

// LeafSlots: the cache state's own leaves, read in place.  Flat slot s is
// page lane j = s % LANES of group g = s / LANES: lane 0 is slots[g] with
// strips[g], lane j > 0 is the overflow slot j - 1 of group g with an
// all-zero strip; every lane carries markers[g].  The valid counts are
// physical_view's: a packed group's lead slot holds the group's LANES
// counts and its overflow slots none; a raw group's slot j holds page j's
// count in its first lane.
template <int LANES>
struct LeafSlots {
  const int16_t* slots;
  const int16_t* over;
  const int16_t* strips;
  const int32_t* markers;
  const uint8_t* mask;
  const int32_t* valid;
  const uint8_t* pred;
  long long sb_slots, sb_over, sb_strips, sb_mask, sb_valid, sb_pred;
  int n;                                // flat slots: LANES x groups
  long long slot_elems, strip_elems;

  __device__ __forceinline__ const int16_t* slot(int bs, int s) const {
    const long long g = s / LANES;
    const int j = s % LANES;
    return j == 0 ? slots + bs * sb_slots + g * slot_elems
                  : over + bs * sb_over + (g * (LANES - 1) + j - 1) * slot_elems;
  }
  __device__ __forceinline__ const int16_t* strip(int bs, int s) const {
    return s % LANES == 0
               ? strips + bs * sb_strips + (long long)(s / LANES) * strip_elems
               : nullptr;
  }
  __device__ __forceinline__ uint32_t marker(int s) const {
    return (uint32_t)__ldg(markers + s / LANES);
  }
  __device__ __forceinline__ void counts(int bs, int s, int (&vc)[LANES]) const {
    const int g = s / LANES, j = s % LANES;
    const int32_t* v = valid + bs * sb_valid + (long long)g * LANES;
    const bool ok = __ldg(mask + bs * sb_mask + g) != 0;
#pragma unroll
    for (int q = 0; q < LANES; ++q)
      vc[q] = ok ? (j == 0 ? __ldg(v + q) : 0) : (q == 0 ? __ldg(v + j) : 0);
  }
  __device__ __forceinline__ int any_live(int bs, int i0, int step) const {
    const int32_t* v = valid + bs * sb_valid;
    int any = 0;
    for (int i = i0; i < n; i += step) any |= __ldg(v + i) > 0;
    return any;
  }
  __device__ __forceinline__ bool group_live(int bs, int s) const {
    const int32_t* v = valid + bs * sb_valid + (long long)(s / LANES) * LANES;
    int live = 0;
#pragma unroll
    for (int q = 0; q < LANES; ++q) live |= __ldg(v + q) > 0;
    return live != 0;
  }
  __device__ __forceinline__ bool predicted(int bs, int g) const {
    return __ldg(pred + bs * sb_pred + g) != 0;
  }
};

// rows [t0, t0 + rows) of one slot's head (src) and, for a packed slot,
// its strip base row (sb; nullptr for an all-zero row, written with plain
// stores) -> shared memory, with cp.async.  A global row
// holds K in [0, D) and V in [D, 2D); the staged row holds them in
// [0, D) and [DP, DP + D) of its 2 * DP columns.  With PAD (D < DP
// possible) the pad columns (zeroed once per CTA) are never loaded; D is
// a multiple of 8, so every 16-byte chunk is all live or all pad.
template <int DPL, bool PAD>
__device__ __forceinline__ void stage_load(int16_t (*tile)[64 * DPL],
                                           int16_t* base,
                                           const int16_t* src,
                                           const int16_t* sb, int rows,
                                           bool packed, long long row_stride,
                                           int D) {
  constexpr int DP = 32 * DPL;
  constexpr int CPH = DP / 8;                 // 16-byte chunks per half row
  constexpr int NT = DP;
  if constexpr (PAD) {
    for (int c = threadIdx.x; c < rows * 2 * CPH; c += NT) {
      const int r = c / (2 * CPH);
      const int half = (c / CPH) & 1;         // 0: K, 1: V
      const int e = (c % CPH) * 8;
      if (e < D)
        cp_async16(&tile[r][half * DP + e],
                   src + r * row_stride + half * D + e);
    }
    if (packed && sb != nullptr)
      for (int c = threadIdx.x; c < DP; c += NT) {   // 4-byte words
        const int half = c / (DP / 2);
        const int e = (c % (DP / 2)) * 2;
        if (e < D) cp_async4(base + half * DP + e, sb + half * D + e);
      }
  } else {                                    // D == DP: rows copy whole
    for (int c = threadIdx.x; c < rows * 2 * CPH; c += NT) {
      const int r = c / (2 * CPH);
      const int k = c % (2 * CPH);
      cp_async16(&tile[r][k * 8], src + r * row_stride + k * 8);
    }
    if (packed && sb != nullptr)
      for (int c = threadIdx.x; c < DP; c += NT)
        cp_async4(base + 2 * c, sb + 2 * c);
  }
  if (packed && sb == nullptr)               // an all-zero strip row
    for (int c = threadIdx.x; c < 2 * DP; c += NT) base[c] = 0;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the GMAX scores (unscaled) of one token row for page lane myj, summed
// across the warp: each lane holds D/32 raw K values rk (and their bases
// << 16, bk); the first one (pair) or two (quad) butterfly steps send the
// page lanes to different half-warps, so every step carries GMAX values
template <int LANES, int DPL, int GMAX, bool PACKED>
__device__ __forceinline__ void row_scores(const int (&rk)[DPL],
                                           const int (&bk)[DPL],
                                           const float (&qr)[GMAX][DPL],
                                           int lane, int myj,
                                           float (&s)[GMAX]) {
  constexpr int GROUP = 32 / LANES;
  if constexpr (!PACKED) {  // page lane 0 is the slot, the others zero pages
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const float kf = raw_bf16(rk[k]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = fmaf(qr[g][k], kf, s[g]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(FULL, s[g], off);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = myj != 0 ? 0.f : s[g];
    return;
  }
  float part[LANES][GMAX];
#pragma unroll
  for (int jj = 0; jj < LANES; ++jj)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) part[jj][g] = 0.f;
#pragma unroll
  for (int k = 0; k < DPL; ++k)
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) {
      const float kf = decode_lane<LANES>(rk[k], bk[k], jj);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        part[jj][g] = fmaf(qr[g][k], kf, part[jj][g]);
    }
  const bool hi16 = lane & 16;
  if constexpr (LANES == 2) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float keep = hi16 ? part[1][g] : part[0][g];
      const float send = hi16 ? part[0][g] : part[1][g];
      s[g] = keep + __shfl_xor_sync(FULL, send, 16);
    }
  } else {
    float t2[2][GMAX];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float keep = hi16 ? part[LANES / 2 + jj][g] : part[jj][g];
        const float send = hi16 ? part[jj][g] : part[LANES / 2 + jj][g];
        t2[jj][g] = keep + __shfl_xor_sync(FULL, send, 16);
      }
    const bool hi8 = lane & 8;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float keep = hi8 ? t2[1][g] : t2[0][g];
      const float send = hi8 ? t2[0][g] : t2[1][g];
      s[g] = keep + __shfl_xor_sync(FULL, send, 8);
    }
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(FULL, s[g], off);
}

// a warp's rows of the stage (warp, warp + WARPS, ...): scaled and masked
// scores -> p[row * LANES + page lane][g], their maximum -> wm; two rows at
// a time where the registers allow, so their shuffle chains overlap (a row
// past `rows` is computed from stale data and dropped)
template <int LANES, int DPL, int GMAX, bool PACKED>
__device__ __forceinline__ void score_rows(const int16_t (*tile)[64 * DPL],
                                           int rows, int ct, int vcj,
                                           float scale,
                                           const float (&qr)[GMAX][DPL],
                                           const int (&bk)[DPL],
                                           float (*p)[gpad<GMAX>()],
                                           float (&wm)[GMAX]) {
  constexpr int WARPS = DPL;
  constexpr int GROUP = 32 / LANES;
  constexpr int RU = LANES * GMAX <= 16 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int myj = LANES == 2 ? (lane >> 4) & 1
                             : ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
  for (int r0 = warp; r0 < rows; r0 += RU * WARPS) {
    float s[RU][GMAX];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      int rk[DPL];
      load_i16<DPL>(tile[min(r0 + u * WARPS, ROWS - 1)], lane, rk);
      row_scores<LANES, DPL, GMAX, PACKED>(rk, bk, qr, lane, myj, s[u]);
    }
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int r = r0 + u * WARPS;
      if (r < rows) {
        const bool live = ct + r < vcj;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float sc = live ? s[u][g] * scale : NEG_INF;
          wm[g] = fmaxf(wm[g], sc);
          if ((lane & (GROUP - 1)) == 0) p[r * LANES + myj][g] = sc;
        }
      }
    }
  }
}

// One CTA's split: query heads h*G+g0 .. h*G+g0+gn-1 of query row b
// (cache row bs) over the flat slots [j*kk, min((j+1)*kk, n)) that `at`
// (FlatSlots or LeafSlots) addresses; BYTES books
// K3's byte pair (in the CTA of KV head 0 and head chunk 0).  blockDim.x
// == DP == 32 * DPL >= D, the head_dim padded to whole warps; gn <= GMAX
// (2, 3, 4 or 8) sizes the per-head registers.  DFIX is the head_dim when
// it is fixed at compile time (DFIX == DP, no pad), else 0 (D = d_arg).
template <int LANES, int DPL, int GMAX, bool BYTES, int DFIX, class Slots>
__device__ __forceinline__ void decode_split(
    const float* __restrict__ q, const Slots at, int b, int bs, int h,
    int g0, int gn, int j, int nj, int page, int hkv, int G, int d_arg,
    int kk, float scale, int slot_bytes, int strip_bytes,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int32_t* __restrict__ part_bytes) {
  constexpr int DP = 32 * DPL;
  constexpr int NT = DP;
  constexpr int WARPS = DPL;
  __shared__ __align__(16) Smem<LANES, DPL, GMAX> sm;
  const int D = DFIX ? DFIX : d_arg;        // a compile-time head_dim folds
  const int n = at.n;

  const int hq = hkv * G;
  const int D2 = 2 * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int srow = D2 + 2;
  const int myj = LANES == 2 ? (lane >> 4) & 1
                             : ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
  const long long row_stride = (long long)hkv * D2;
  const bool books = BYTES && h == 0 && g0 == 0;

  if (DFIX == 0 && D < DP) {   // the pad columns of tiles and base rows: 0
    const int pad = DP - D;
    for (int i = tid; i < 2 * (ROWS + 1) * 2 * pad; i += NT) {
      const int r = i / (2 * pad);
      const int c = i % (2 * pad);
      int16_t* row = r < 2 * ROWS ? sm.tile[r / ROWS][r % ROWS]
                                  : sm.base[r - 2 * ROWS];
      row[c < pad ? D + c : DP + D + c - pad] = 0;
    }
  }

  float qr[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const float* qg = q + ((long long)b * hq + h * G + g0 + g) * D;
    if constexpr (DPL == 4) {
      const float4 v = g < gn && lane * 4 < D
                           ? *reinterpret_cast<const float4*>(qg + lane * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[g][0] = v.x;
      qr[g][1] = v.y;
      qr[g][2] = v.z;
      qr[g][3] = v.w;
    } else if constexpr (DPL == 2) {
      const float2 v = g < gn && lane * 2 < D
                           ? *reinterpret_cast<const float2*>(qg + lane * 2)
                           : make_float2(0.f, 0.f);
      qr[g][0] = v.x;
      qr[g][1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int c = kcol<DPL>(lane, k);
        qr[g][k] = g < gn && c < D ? qg[c] : 0.f;
      }
    }
  }
  const int any = at.any_live(bs, tid, NT);

  float m_run[GMAX], l_run[GMAX], acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }
  uint32_t raw_b = 0, cram_b = 0;
  bool skip_masked = false;

  const int s_begin = j * kk;
  const int s_end = min(s_begin + kk, n);
  for (int w0 = s_begin; w0 < s_end; w0 += WIN) {
    const int nwin = min(WIN, s_end - w0);
    if (warp == 0 && lane < nwin) {         // this window's descriptors
      const int s = w0 + lane;
      int vc[LANES];
      int top = 0;
      uint32_t n_live = 0;
      at.counts(bs, s, vc);
#pragma unroll
      for (int q2 = 0; q2 < LANES; ++q2) {
        top = max(top, vc[q2]);
        n_live += vc[q2] > 0;
        sm.vc[lane][q2] = vc[q2];
      }
      // all Hkv strip tails carry the slot's marker (4-byte tail loads);
      // every tail of an all-zero strip row reads 0
      const uint32_t mk = at.marker(s);
      const int16_t* st = at.strip(bs, s);
      bool packed = st != nullptr || mk == 0u;
      for (int h0 = 0; st != nullptr && h0 < hkv; h0 += HCHUNK) {
        const int16_t* tail = st + D2;
        uint32_t t[HCHUNK];
#pragma unroll
        for (int c = 0; c < HCHUNK; ++c)
          t[c] = h0 + c < hkv ? __ldg(reinterpret_cast<const uint32_t*>(
                                    tail + (h0 + c) * srow))
                              : mk;
#pragma unroll
        for (int c = 0; c < HCHUNK; ++c) packed &= t[c] == mk;
      }
      sm.top[lane] = top;
      sm.packed[lane] = packed;
      if (books) {
        // flat-slot form of the ops.hbm_bytes_moved group model
        raw_b += n_live * (uint32_t)slot_bytes;
        cram_b += (packed && n_live > 0)
                      ? (uint32_t)(slot_bytes + strip_bytes)
                      : n_live * (uint32_t)(slot_bytes + strip_bytes);
        // lead slot: one re-probe per mispredicted live group
        if (s % LANES == 0 && at.group_live(bs, s) &&
            at.predicted(bs, s / LANES) != packed)
          cram_b += (uint32_t)slot_bytes;
      }
    }
    if (w0 == s_begin)
      skip_masked = __syncthreads_or(any) != 0;
    else
      __syncthreads();

    // rows walked in slot i of the window: through its last valid token
    // when the sequence has one, else every row
    auto tend = [&](int i) {
      return skip_masked ? min(sm.top[i], page) : page;
    };
    auto seek = [&](int& i, int& t) {
      while (i < nwin && t >= tend(i)) {
        ++i;
        t = 0;
      }
    };
    auto load = [&](int i, int t, int buf) {
      const int16_t* st = at.strip(bs, w0 + i);
      stage_load<DPL, DFIX == 0>(sm.tile[buf], sm.base[buf],
                      at.slot(bs, w0 + i) + t * row_stride + h * D2,
                      st == nullptr ? nullptr : st + h * srow,
                      min(ROWS, tend(i) - t), sm.packed[i] != 0, row_stride,
                      D);
    };

    int ci = 0, ct = 0;
    seek(ci, ct);
    if (ci < nwin) load(ci, ct, 0);
    int bf = 0;
    while (ci < nwin) {
      int ni = ci, nt = ct + ROWS;
      seek(ni, nt);
      cp_async_wait_all();
      __syncthreads();            // tile ci ready; the last stage done
      if (ni < nwin) load(ni, nt, bf ^ 1);

      const int rows = min(ROWS, tend(ci) - ct);
      const bool packed = sm.packed[ci] != 0;
      const int vcj = sm.vc[ci][myj];

      // scores: a warp per row
      int bk[DPL] = {};
      float wm[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) wm[g] = NEG_INF;
      if (packed) {
        load_hi<DPL>(sm.base[bf], lane, bk);
        score_rows<LANES, DPL, GMAX, true>(sm.tile[bf], rows, ct, vcj, scale,
                                           qr, bk, sm.p, wm);
      } else {
        score_rows<LANES, DPL, GMAX, false>(sm.tile[bf], rows, ct, vcj,
                                            scale, qr, bk, sm.p, wm);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        wm[g] = fmaxf(wm[g], __shfl_xor_sync(FULL, wm[g], 16));
        if (LANES == 4)
          wm[g] = fmaxf(wm[g], __shfl_xor_sync(FULL, wm[g], 8));
        if (lane == 0) sm.wmax[warp][g] = wm[g];
      }
      __syncthreads();

      // one rescale of the running state per stage; p = exp(s - m) and the
      // stage's sum of p for head g by warp g % WARPS
      float m_new[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float mx = sm.wmax[0][g];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, sm.wmax[w][g]);
        m_new[g] = fmaxf(m_run[g], mx);
        const float alpha = __expf(m_run[g] - m_new[g]);
        m_run[g] = m_new[g];
        l_run[g] = __fmul_rn(l_run[g], alpha);
        acc[g] = __fmul_rn(acc[g], alpha);
      }
#pragma unroll
      for (int c = 0; c < (GMAX + WARPS - 1) / WARPS; ++c) {
        const int g = warp + c * WARPS;
        if (g >= GMAX) break;
        float mg = m_new[0];
#pragma unroll
        for (int k = 1; k < GMAX; ++k) mg = g == k ? m_new[k] : mg;
        float ls = 0.f;
        for (int e = lane; e < rows * LANES; e += 32) {
          const float p = __expf(sm.p[e][g] - mg);
          sm.p[e][g] = p;
          ls += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ls += __shfl_xor_sync(FULL, ls, off);
        if (lane == 0) sm.lsum[g] = ls;
      }
      __syncthreads();

      // P.V: thread tid owns column tid of V (zero past D); a row's page
      // lanes are summed before they join the accumulator
#pragma unroll
      for (int g = 0; g < GMAX; ++g) l_run[g] += sm.lsum[g];
      if (packed) {
        const int bv = ((int)sm.base[bf][DP + tid]) << 16;
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const int rv = sm.tile[bf][r][DP + tid];
          float t[GMAX];
#pragma unroll
          for (int jj = 0; jj < LANES; ++jj) {
            float p[GMAX];
            load_p<GMAX>(sm.p[r * LANES + jj], p);
            const float vf = decode_lane<LANES>(rv, bv, jj);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              t[g] = jj == 0 ? p[g] * vf : fmaf(p[g], vf, t[g]);
          }
#pragma unroll
          for (int g = 0; g < GMAX; ++g) acc[g] += t[g];
        }
      } else {                              // zero pages add nothing
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          float p[GMAX];
          load_p<GMAX>(sm.p[r * LANES], p);
          const float vf = raw_bf16(sm.tile[bf][r][DP + tid]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) acc[g] = fmaf(p[g], vf, acc[g]);
        }
      }
      ci = ni;
      ct = nt;
      bf ^= 1;
    }
    __syncthreads();              // before the next window's descriptors
  }

  if (books && warp == 0) {              // this split's byte pair
    raw_b = __reduce_add_sync(FULL, raw_b);
    cram_b = __reduce_add_sync(FULL, cram_b);
    if (lane == 0) {
      part_bytes[((long long)b * nj + j) * 2] = (int32_t)raw_b;
      part_bytes[((long long)b * nj + j) * 2 + 1] = (int32_t)cram_b;
    }
  }

  const long long bh0 = (long long)b * hq + h * G + g0;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < gn) {
      const long long idx = (bh0 + g) * nj + j;
      if (DFIX != 0 || tid < D) part_acc[idx * D + tid] = acc[g];
      if (tid == 0) {
        part_m[idx] = m_run[g];
        part_l[idx] = l_run[g];
      }
    }
}

// blockIdx.y (K3) / blockIdx.x (K6) is KV head h times nc head chunks of
// gc query heads (the last may be shorter); a chunk of at most 4 heads is
// the KV head's whole group (nc == 1), known at compile time
template <int GMAX>
__device__ __forceinline__ void head_chunk(int y, int nc, int gc, int G,
                                           int& h, int& g0, int& gn) {
  if constexpr (GMAX < MAXG) {
    h = y;
    g0 = 0;
    gn = G;
  } else {
    h = y / nc;
    g0 = (y % nc) * gc;
    gn = min(gc, G - g0);
  }
}

// at least 5 CTAs per SM where the per-head arrays are small; the padded
// body at DPL 4 spills within the registers that 4 or 5 CTAs of 128
// threads leave, so it is bounded to 3
template <int DPL, int GMAX, int DFIX>
__host__ __device__ constexpr int min_ctas() {
  return GMAX > 4 ? 1 : DFIX == 0 && DPL == 4 ? 3 : 5;
}

// K3 on either addressing (FlatSlots: the flat entry; LeafSlots: the
// in-place entry, whose shared cache has batch strides 0)
template <int LANES, int DPL, int GMAX, int DFIX, class Slots>
__global__ void __launch_bounds__(32 * DPL, min_ctas<DPL, GMAX, DFIX>())
cram_decode_kernel(const float* __restrict__ q, const Slots at, int page,
                   int hkv, int G, int nc, int gc, int D, int kk, int shared,
                   float scale, int slot_bytes, int strip_bytes,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc,
                   int32_t* __restrict__ part_bytes) {
  const int b = blockIdx.x;
  int h, g0, gn;
  head_chunk<GMAX>(blockIdx.y, nc, gc, G, h, g0, gn);
  decode_split<LANES, DPL, GMAX, true, DFIX>(
      q, at, b, shared ? 0 : b, h, g0, gn, blockIdx.z, gridDim.z, page, hkv,
      G, D, kk, scale, slot_bytes, strip_bytes, part_m, part_l, part_acc,
      part_bytes);
}

template <int LANES, int DPL, int GMAX, int DFIX>
__global__ void __launch_bounds__(32 * DPL, min_ctas<DPL, GMAX, DFIX>())
cram_decode_single_kernel(const float* __restrict__ q,
                          const FlatSlots<LANES> at, int page, int hkv, int G,
                          int nc, int gc, int D, int kk, float scale,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc) {
  int h, g0, gn;
  head_chunk<GMAX>(blockIdx.x, nc, gc, G, h, g0, gn);
  decode_split<LANES, DPL, GMAX, false, DFIX>(
      q, at, 0, 0, h, g0, gn, blockIdx.y, gridDim.y, page, hkv, G, D, kk,
      scale, 0, 0, part_m, part_l, part_acc, nullptr);
}

// the G query heads of a KV head in the fewest chunks of at most MAXG, as
// even as they go: (chunks, heads per chunk)
inline void head_chunks(int G, int& nc, int& gc) {
  nc = (G + MAXG - 1) / MAXG;
  gc = (G + nc - 1) / nc;
}

template <int V>
using Int = std::integral_constant<int, V>;

// The split kernel of one call (K3 or K6, LANES page lanes) on the
// instantiation that fits: EXACT takes head_dim 64 or 128 at compile time
// (DPL 2 or 4, GMAX 2, 3, 4 or 8 by the chunk's head count); the general
// body takes any head_dim a multiple of 8 from 8 to 128 at run time (DPL
// 1..4, GMAX 2, 4 or 8).
template <bool EXACT, int LANES>
int launch_splits(const cram_att::DecodeArgs& a, cudaStream_t s) {
  const int G = a.hq / a.hkv;
  int nc, gc;
  head_chunks(G, nc, gc);
  const int nj = (a.n + a.kk - 1) / a.kk;
  const long long slot_elems = (long long)a.page * a.hkv * 2 * a.D;
  const long long strip_elems = (long long)a.hkv * (2 * a.D + 2);
  const FlatSlots<LANES> flat{a.slots, a.strips, a.markers, a.valid,
                              (const int32_t*)a.pred, a.n, slot_elems,
                              strip_elems};
  auto launch = [&](auto P, auto M) {
    constexpr int DPL = decltype(P)::value;
    constexpr int GMAX = decltype(M)::value;
    constexpr int DFIX = EXACT ? 32 * DPL : 0;
    const dim3 grid(a.B, a.hkv * nc, nj);
    if (a.leaves != nullptr) {
      const cram_att::Leaves& l = *a.leaves;
      const LeafSlots<LANES> leaf{
          a.slots, l.over, a.strips, a.markers, l.mask, a.valid,
          (const uint8_t*)a.pred, l.sb_slots, l.sb_over, l.sb_strips,
          l.sb_mask, l.sb_valid, l.sb_pred, a.n, slot_elems, strip_elems};
      cram_decode_kernel<LANES, DPL, GMAX, DFIX><<<grid, 32 * DPL, 0, s>>>(
          a.q, leaf, a.page, a.hkv, G, nc, gc, a.D, a.kk, 0, a.scale,
          a.slot_bytes, a.strip_bytes, a.part_m, a.part_l, a.part_acc,
          a.part_bytes);
    } else if (a.batched) {
      cram_decode_kernel<LANES, DPL, GMAX, DFIX><<<grid, 32 * DPL, 0, s>>>(
          a.q, flat, a.page, a.hkv, G, nc, gc, a.D, a.kk, a.shared, a.scale,
          a.slot_bytes, a.strip_bytes, a.part_m, a.part_l, a.part_acc,
          a.part_bytes);
    } else {
      cram_decode_single_kernel<LANES, DPL, GMAX, DFIX>
          <<<dim3(a.hkv * nc, nj), 32 * DPL, 0, s>>>(
          a.q, flat, a.page, a.hkv, G, nc, gc, a.D, a.kk, a.scale, a.part_m,
          a.part_l, a.part_acc);
    }
  };
  auto by_g = [&](auto P) {
    if (gc > 4)
      launch(P, Int<8>{});
    else if (gc > 2 && (!EXACT || gc == 4))
      launch(P, Int<4>{});
    else if constexpr (EXACT)
      gc == 3 ? launch(P, Int<3>{}) : launch(P, Int<2>{});
    else
      launch(P, Int<2>{});
  };
  if constexpr (EXACT) {
    if (a.D == 64) by_g(Int<2>{}); else by_g(Int<4>{});
  } else {
    switch ((a.D + 31) / 32) {
      case 1: by_g(Int<1>{}); break;
      case 2: by_g(Int<2>{}); break;
      case 3: by_g(Int<3>{}); break;
      default: by_g(Int<4>{});
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace
