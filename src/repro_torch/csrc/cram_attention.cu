// K3: batched decode attention over the CRAM-packed paged KV cache, and
// K6: the single-sequence decode over one sequence's physical slots.
//
// K3 replaces the Pallas kernel repro/kernels/cram_attention.py:272
// (cram_decode_attention_batched, its pallas_call at :309).  Inputs are the
// flat physical view that kernels/ops.py:physical_view /
// physical_view_quad builds:
//
//   q (B, Hq, D) f32; slots (Bc, n, page, Hkv, D2) i16; strips (Bc, n, Hkv,
//   D2+2) i16; markers (n,) i32; valid (Bc, n, LANES) i32; pred (Bc, n/LANES)
//   i32, with Bc = 1 for a shared cache and B otherwise
//   -> out (B, Hq, D) f32 and bytes (B, 2) i32 = (raw, cram) bytes the step
//      moves for exactly the layout walked, LLP re-probe included.
//
// K6 replaces repro/kernels/cram_attention.py:128 (cram_decode_attention,
// its pallas_call at :137, grid=(n,)): q (Hq, D) f32 and one sequence's
// slots (n, page, Hkv, D2), strips, markers (n,), valid (n, LANES) ->
// out (Hq, D) f32, with no predictor and no bytes, at any n (n need not be
// a multiple of LANES).  Both entries run one device body (decode_split)
// and one merge, so K6 on a sequence equals K3's row for it bit for bit
// when the two take the same split width.
//
// Semantics, per flat slot: a slot is packed only when the strip tails of
// all Hkv heads carry its marker; a packed slot delta-decodes LANES pages
// against its strip base, a raw slot is one page and LANES-1 zero pages;
// bf16 K||V; the valid mask; softmax in f32.  Masked scores are -1e30 as
// in the reference, so a sequence with no valid token at all averages V
// over every position walked; when the sequence has a valid token, masked
// positions contribute exactly 0 and rows past a slot's last valid token
// are not read.
//
// Bound on the H100: bytes.  Decoding is a few integer operations per
// element and the products are G = Hq/Hkv dot products of length D per
// token, far below the card's operations-per-byte balance, so the floor is
// the live slot rows + strips + q / 3.35 TB/s.  At the serve shape (16
// flat slots) that floor is a fraction of a microsecond and a launch is
// bound by latency: how many CTAs run side by side and how long the chain
// of dependent steps in each is.  Over thousands of tokens it is bound by
// the instructions each staged row costs.
//
// Design.  The grid is (B, Hkv, splits) for K3 and (Hkv, splits) for K6; a
// split is a run of kk flat slots (the last may be shorter), kk chosen in
// Python from n alone (at most 16 splits), so K3 and K6 split a sequence
// the same way whatever B is.  One CTA of D threads (D/32 warps) owns the
// G query heads of one KV head over its split and walks it in stages of
// at most ROWS token rows of one slot:
//   * warp 0 reads the split's slot descriptors, one slot per lane, 32 at a
//     time (valid counts; the marker compare over the Hkv strip tails as
//     4-byte loads issued together); with K3's head 0 it also books the
//     split's byte pair in integers;
//   * a stage's rows of the head (page x D2 int16, 8 KB at head_dim 128)
//     and its strip base row are copied to shared memory with cp.async,
//     double-buffered: stage i+1 is in flight while stage i computes;
//   * scores: a warp per row, two rows at a time where the registers
//     allow; each lane holds D/32 elements of q for every head and decodes
//     its D/32 raw K values into the LANES pages (prmt / shifts against
//     base << 16); the LANES x G partial dot products reduce across the
//     warp, the first one or two butterfly steps sending the page lanes to
//     different half-warps.  No step is guarded per head: a guard around a
//     shuffle makes ptxas branch around each one and run them one by one;
//   * softmax per stage: the maximum from per-warp maxima, one rescale of
//     the running state per stage instead of per token, p = exp(s - m)
//     once per score and the stage's sum by warp g % WARPS;
//   * P.V: thread d owns column d of V for every head, decodes its raw V
//     value from the staged tile and sums a row's page lanes before they
//     join the accumulator;
//   * a second kernel merges the splits in split order (so the result does
//     not depend on which CTA ends first) and adds K3's per-split byte
//     pairs, exact in integers and with nothing to zero beforehand.
// The per-head register arrays are sized by GMAX: G itself for G of 3 or
// 4, 2 for G of 1 or 2, 8 above; at GMAX <= 4 the CTAs are bounded to 5
// per SM (at most 102 registers).  Static shared memory: 2 tiles of ROWS x
// D2 int16, 2 base rows, the stage's ROWS x LANES x GMAX scores and the
// descriptors (under 21 KB).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// DPL consecutive int16 (8 or 4 bytes, aligned) -> each value << 16
template <int DPL>
__device__ __forceinline__ void load_hi(const int16_t* p, int (&out)[DPL]) {
  if constexpr (DPL == 4) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    out[0] = v.x << 16;
    out[1] = v.x & (int)0xFFFF0000;
    out[2] = v.y << 16;
    out[3] = v.y & (int)0xFFFF0000;
  } else {
    const int v = *reinterpret_cast<const int*>(p);
    out[0] = v << 16;
    out[1] = v & (int)0xFFFF0000;
  }
}

// DPL consecutive int16 -> sign-extended ints
template <int DPL>
__device__ __forceinline__ void load_i16(const int16_t* p, int (&out)[DPL]) {
  if constexpr (DPL == 4) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    out[0] = (int)(int16_t)v.x;
    out[1] = v.x >> 16;
    out[2] = (int)(int16_t)v.y;
    out[3] = v.y >> 16;
  } else {
    const int v = *reinterpret_cast<const int*>(p);
    out[0] = (int)(int16_t)v;
    out[1] = v >> 16;
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

// rows [t0, t0 + rows) of one slot's head (src) and, for a packed slot,
// its strip base row (sb) -> shared memory, with cp.async
template <int DPL>
__device__ __forceinline__ void stage_load(int16_t (*tile)[64 * DPL],
                                           int16_t* base,
                                           const int16_t* src,
                                           const int16_t* sb, int rows,
                                           bool packed, long long row_stride) {
  constexpr int D2 = 64 * DPL;
  constexpr int CPR = D2 / 8;                 // 16-byte chunks per row
  constexpr int NT = 32 * DPL;
  for (int c = threadIdx.x; c < rows * CPR; c += NT) {
    const int r = c / CPR;
    const int k = c % CPR;
    cp_async16(&tile[r][k * 8], src + r * row_stride + k * 8);
  }
  if (packed)
    for (int c = threadIdx.x; c < D2 / 2; c += NT)
      cp_async4(base + 2 * c, sb + 2 * c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the splits of one (query row, query head) bh in split order, column d:
// MCHUNK splits' partials are loaded together, then folded one by one
// into a running (max, sum, acc), so the order of the float operations is
// fixed whatever nj is
constexpr int MCHUNK = 16;
__device__ __forceinline__ float merge_splits(const float* part_m,
                                              const float* part_l,
                                              const float* part_acc,
                                              long long bh, int nj, int D,
                                              int d) {
  float mx = NEG_INF, lsum = 0.f, asum = 0.f;
  for (int j0 = 0; j0 < nj; j0 += MCHUNK) {
    float m[MCHUNK], l[MCHUNK], a[MCHUNK];
#pragma unroll
    for (int c = 0; c < MCHUNK; ++c) {
      const bool in = j0 + c < nj;
      const long long idx = bh * nj + j0 + c;
      m[c] = in ? __ldcg(part_m + idx) : NEG_INF;
      l[c] = in ? __ldcg(part_l + idx) : 0.f;
      a[c] = in ? __ldcg(part_acc + idx * D + d) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < MCHUNK; ++c) {
      const float m_new = fmaxf(mx, m[c]);
      const float fo = expf(mx - m_new);
      const float fc = expf(m[c] - m_new);
      lsum = fmaf(l[c], fc, __fmul_rn(lsum, fo));
      asum = fmaf(a[c], fc, __fmul_rn(asum, fo));
      mx = m_new;
    }
  }
  return asum / fmaxf(lsum, 1e-30f);
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
      load_i16<DPL>(&tile[min(r0 + u * WARPS, ROWS - 1)][lane * DPL], rk);
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

// One CTA's split: query heads h*G .. h*G+G-1 of query row b (cache row
// bs) over the flat slots [j*kk, min((j+1)*kk, n)); BYTES books K3's byte
// pair.  blockDim.x == D == 32 * DPL; G <= GMAX (2, 3, 4 or 8) sizes the
// per-head registers.
template <int LANES, int DPL, int GMAX, bool BYTES>
__device__ __forceinline__ void decode_split(
    const float* __restrict__ q, const int16_t* __restrict__ slots,
    const int16_t* __restrict__ strips, const int32_t* __restrict__ markers,
    const int32_t* __restrict__ valid, const int32_t* __restrict__ pred, int b,
    int bs, int h, int j, int nj, int n, int page, int hkv, int G, int kk,
    float scale, int slot_bytes, int strip_bytes, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int32_t* __restrict__ part_bytes) {
  constexpr int D = 32 * DPL;
  constexpr int D2 = 2 * D;
  constexpr int NT = D;
  constexpr int WARPS = DPL;
  __shared__ __align__(16) Smem<LANES, DPL, GMAX> sm;

  const int hq = hkv * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int srow = D2 + 2;
  const int myj = LANES == 2 ? (lane >> 4) & 1
                             : ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
  const long long row_stride = (long long)hkv * D2;
  const int32_t* vseq = valid + (long long)bs * n * LANES;

  float qr[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const float* qg = q + ((long long)b * hq + h * G + g) * D + lane * DPL;
    if constexpr (DPL == 4) {
      const float4 v = g < G ? *reinterpret_cast<const float4*>(qg)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[g][0] = v.x;
      qr[g][1] = v.y;
      qr[g][2] = v.z;
      qr[g][3] = v.w;
    } else {
      const float2 v = g < G ? *reinterpret_cast<const float2*>(qg)
                             : make_float2(0.f, 0.f);
      qr[g][0] = v.x;
      qr[g][1] = v.y;
    }
  }
  int any = 0;
  for (int i = tid; i < n * LANES; i += NT) any |= vseq[i] > 0;

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
#pragma unroll
      for (int q2 = 0; q2 < LANES; ++q2) {
        vc[q2] = vseq[s * LANES + q2];
        top = max(top, vc[q2]);
        n_live += vc[q2] > 0;
        sm.vc[lane][q2] = vc[q2];
      }
      // all Hkv strip tails carry the slot's marker (4-byte tail loads)
      const uint32_t mk = (uint32_t)markers[s];
      const int16_t* tail =
          strips + ((long long)bs * n + s) * hkv * srow + D2;
      bool packed = true;
      for (int h0 = 0; h0 < hkv; h0 += HCHUNK) {
        uint32_t t[HCHUNK];
#pragma unroll
        for (int c = 0; c < HCHUNK; ++c)
          t[c] = h0 + c < hkv ? *reinterpret_cast<const uint32_t*>(
                                    tail + (h0 + c) * srow)
                              : mk;
#pragma unroll
        for (int c = 0; c < HCHUNK; ++c) packed &= t[c] == mk;
      }
      sm.top[lane] = top;
      sm.packed[lane] = packed;
      if (BYTES && h == 0) {
        // flat-slot form of the ops.hbm_bytes_moved group model
        raw_b += n_live * (uint32_t)slot_bytes;
        cram_b += (packed && n_live > 0)
                      ? (uint32_t)(slot_bytes + strip_bytes)
                      : n_live * (uint32_t)(slot_bytes + strip_bytes);
        // lead slot: one re-probe per mispredicted live group
        if (s % LANES == 0) {
          int glive = 0;
#pragma unroll
          for (int q2 = 0; q2 < LANES * LANES; ++q2)
            glive |= vseq[s * LANES + q2] > 0;
          const bool p = pred[(long long)bs * (n / LANES) + s / LANES] != 0;
          if (glive && p != packed) cram_b += (uint32_t)slot_bytes;
        }
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
      const long long slot = (long long)bs * n + w0 + i;
      stage_load<DPL>(sm.tile[buf], sm.base[buf],
                      slots + (slot * page + t) * row_stride + h * D2,
                      strips + (slot * hkv + h) * srow,
                      min(ROWS, tend(i) - t), sm.packed[i] != 0, row_stride);
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
        load_hi<DPL>(&sm.base[bf][lane * DPL], bk);
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

      // P.V: thread tid owns column tid of V; a row's page lanes are summed
      // before they join the accumulator
#pragma unroll
      for (int g = 0; g < GMAX; ++g) l_run[g] += sm.lsum[g];
      if (packed) {
        const int bv = ((int)sm.base[bf][D + tid]) << 16;
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const int rv = sm.tile[bf][r][D + tid];
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
          const float vf = raw_bf16(sm.tile[bf][r][D + tid]);
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

  if (BYTES && h == 0 && warp == 0) {     // this split's byte pair
    raw_b = __reduce_add_sync(FULL, raw_b);
    cram_b = __reduce_add_sync(FULL, cram_b);
    if (lane == 0) {
      part_bytes[((long long)b * nj + j) * 2] = (int32_t)raw_b;
      part_bytes[((long long)b * nj + j) * 2 + 1] = (int32_t)cram_b;
    }
  }

  const long long bh0 = (long long)b * hq + h * G;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) {
      const long long idx = (bh0 + g) * nj + j;
      part_acc[idx * D + tid] = acc[g];
      if (tid == 0) {
        part_m[idx] = m_run[g];
        part_l[idx] = l_run[g];
      }
    }
}

template <int LANES, int DPL, int GMAX>
__global__ void __launch_bounds__(32 * DPL, GMAX <= 4 ? 5 : 1)
cram_decode_kernel(const float* __restrict__ q,
                   const int16_t* __restrict__ slots,
                   const int16_t* __restrict__ strips,
                   const int32_t* __restrict__ markers,
                   const int32_t* __restrict__ valid,
                   const int32_t* __restrict__ pred, int n, int page, int hkv,
                   int G, int kk, int shared, float scale, int slot_bytes,
                   int strip_bytes, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int32_t* __restrict__ part_bytes) {
  const int b = blockIdx.x;
  decode_split<LANES, DPL, GMAX, true>(
      q, slots, strips, markers, valid, pred, b, shared ? 0 : b, blockIdx.y,
      blockIdx.z, gridDim.z, n, page, hkv, G, kk, scale, slot_bytes,
      strip_bytes, part_m, part_l, part_acc, part_bytes);
}

template <int LANES, int DPL, int GMAX>
__global__ void __launch_bounds__(32 * DPL, GMAX <= 4 ? 5 : 1)
cram_decode_single_kernel(const float* __restrict__ q,
                          const int16_t* __restrict__ slots,
                          const int16_t* __restrict__ strips,
                          const int32_t* __restrict__ markers,
                          const int32_t* __restrict__ valid, int n, int page,
                          int hkv, int G, int kk, float scale,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc) {
  decode_split<LANES, DPL, GMAX, false>(
      q, slots, strips, markers, valid, nullptr, 0, 0, blockIdx.x, blockIdx.y,
      gridDim.y, n, page, hkv, G, kk, scale, 0, 0, part_m, part_l, part_acc,
      nullptr);
}

// one block per (query row, query head); K3's byte pair of each query row
// is the sum of its splits' pairs (integers, in split order)
__global__ void cram_decode_combine(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    const int32_t* __restrict__ part_bytes,
                                    int nj, int D, int hq,
                                    float* __restrict__ out,
                                    int32_t* __restrict__ bytes) {
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[(long long)blockIdx.x * D + d] =
        merge_splits(part_m, part_l, part_acc, blockIdx.x, nj, D, d);
  if (part_bytes != nullptr && blockIdx.x % hq == 0 && threadIdx.x < 2) {
    const long long b = blockIdx.x / hq;
    uint32_t sum = 0;
    for (int j = 0; j < nj; ++j)
      sum += (uint32_t)part_bytes[(b * nj + j) * 2 + threadIdx.x];
    bytes[b * 2 + threadIdx.x] = (int32_t)sum;
  }
}

bool geometry_ok(int hq, int D, int n, int hkv, int lanes, int kk) {
  return n > 0 && hkv > 0 && hq % hkv == 0 && hq / hkv <= MAXG && kk > 0 &&
         (D == 64 || D == 128) && (lanes == 2 || lanes == 4);
}

template <int V>
using Int = std::integral_constant<int, V>;

// launch(Int<LANES>, Int<DPL>, Int<GMAX>) for the instantiation that fits
template <typename F>
void dispatch(int lanes, int D, int G, F&& launch) {
  auto by_g = [&](auto L, auto P) {
    switch (G <= 2 ? 2 : G <= 4 ? G : 8) {
      case 2: launch(L, P, Int<2>{}); break;
      case 3: launch(L, P, Int<3>{}); break;
      case 4: launch(L, P, Int<4>{}); break;
      default: launch(L, P, Int<8>{});
    }
  };
  if (lanes == 2) {
    if (D == 64) by_g(Int<2>{}, Int<2>{}); else by_g(Int<2>{}, Int<4>{});
  } else {
    if (D == 64) by_g(Int<4>{}, Int<2>{}); else by_g(Int<4>{}, Int<4>{});
  }
}

}  // namespace

extern "C" int cram_decode_attention(const void* q, const void* slots,
                                     const void* strips, const void* markers,
                                     const void* valid, const void* pred, int B,
                                     int hq, int D, int n, int page, int hkv,
                                     int lanes, int kk, int shared, float scale,
                                     int slot_bytes, int strip_bytes,
                                     void* part_m, void* part_l, void* part_acc,
                                     void* part_bytes, void* out, void* bytes,
                                     void* stream) {
  if (!geometry_ok(hq, D, n, hkv, lanes, kk) || n % lanes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = hq / hkv;
  const int nj = (n + kk - 1) / kk;
  const dim3 grid(B, hkv, nj);
  dispatch(lanes, D, G, [&](auto L, auto P, auto M) {
    constexpr int DPL = decltype(P)::value;
    cram_decode_kernel<decltype(L)::value, DPL, decltype(M)::value>
        <<<grid, 32 * DPL, 0, s>>>(
        (const float*)q, (const int16_t*)slots, (const int16_t*)strips,
        (const int32_t*)markers, (const int32_t*)valid, (const int32_t*)pred,
        n, page, hkv, G, kk, shared, scale, slot_bytes, strip_bytes,
        (float*)part_m, (float*)part_l, (float*)part_acc,
        (int32_t*)part_bytes);
  });
  int err = (int)cudaGetLastError();
  if (err) return err;
  cram_decode_combine<<<B * hq, D, 0, s>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (const int32_t*)part_bytes, nj, D, hq, (float*)out, (int32_t*)bytes);
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
  if (!geometry_ok(hq, D, n, hkv, lanes, kk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = hq / hkv;
  const int nj = (n + kk - 1) / kk;
  const dim3 grid(hkv, nj);
  dispatch(lanes, D, G, [&](auto L, auto P, auto M) {
    constexpr int DPL = decltype(P)::value;
    cram_decode_single_kernel<decltype(L)::value, DPL, decltype(M)::value>
        <<<grid, 32 * DPL, 0, s>>>(
        (const float*)q, (const int16_t*)slots, (const int16_t*)strips,
        (const int32_t*)markers, (const int32_t*)valid, n, page, hkv, G, kk,
        scale, (float*)part_m, (float*)part_l, (float*)part_acc);
  });
  int err = (int)cudaGetLastError();
  if (err) return err;
  cram_decode_combine<<<hq, D, 0, s>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      nullptr, nj, D, hq, (float*)out, nullptr);
  return (int)cudaGetLastError();
}
