// The device body of A1 (the model's decode attention), shared by
// gqa_decode.cu (bf16 K/V, the merge and the host entry) and
// gqa_decode_f16.cu / gqa_decode_f32.cu (fp16 and float32 K/V), which
// compile in parallel.  The design note is at the top of gqa_decode.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gqa_att {


constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int VEC = 8;            // elements of a row a lane holds
constexpr int MAXG = 8;           // query heads a CTA serves
constexpr int MAX_SPLITS = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the element types, as the wrapper codes them
enum DType { F32 = 0, F16 = 1, BF16 = 2 };

struct GqaArgs {
  const void* q;
  const void* k;
  const void* v;
  long long q_sb, q_sh;           // q's batch and head strides (elements)
  int B, T, hkv, hq, D, g, hchunks, splits, width, length, qtype, state;
  float scale2;                   // log2(e) / sqrt(D)
  float* part_m;                  // (B, Hq, splits), log2 units
  float* part_l;
  float* part_o;                  // (B, Hq, splits, D)
  float* m;                       // (B, Hq), natural units (state only)
  float* l;
  void* o;                        // (B, Hq, D): f32 state or q's type
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 elements of a row: one 16-byte word in 2-byte types, two in float32
template <typename T>
struct Row {
  static constexpr int N = VEC * (int)sizeof(T) / 16;
  uint4 w[N];
};

template <typename T>
__device__ __forceinline__ void load_row(Row<T>& r, const T* p) {
#pragma unroll
  for (int i = 0; i < Row<T>::N; ++i)
    r.w[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
}

template <typename T>
__device__ __forceinline__ void zero_row(Row<T>& r) {
#pragma unroll
  for (int i = 0; i < Row<T>::N; ++i) r.w[i] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void to_float(const Row<__nv_bfloat16>& r,
                                         float (&x)[VEC]) {
  const unsigned u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void to_float(const Row<__half>& r,
                                         float (&x)[VEC]) {
  const unsigned u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __half2 h;
    *reinterpret_cast<unsigned*>(&h) = u[i];
    const float2 f = __half22float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_float(const Row<float>& r,
                                         float (&x)[VEC]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[4 * i] = __uint_as_float(r.w[i].x);
    x[4 * i + 1] = __uint_as_float(r.w[i].y);
    x[4 * i + 2] = __uint_as_float(r.w[i].z);
    x[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}

__device__ __forceinline__ float load_elem(const void* p, int type,
                                           long long i) {
  if (type == BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (type == F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_elem(void* p, int type, long long i,
                                           float x) {
  if (type == BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else if (type == F16)
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// the final result of one (sequence, query head) row at column c: m2 the
// max in log2 units (NEG_INF: no valid position), L the sum, o the
// unnormalised column
__device__ __forceinline__ void write_final(const GqaArgs& a, int row, int c,
                                            float m2, float L, float o) {
  const long long i = (long long)row * a.D + c;
  if (a.state) {
    if (c == 0) {
      a.m[row] = m2 <= NEG_INF ? NEG_INF : m2 * LN2;
      a.l[row] = L;
    }
    static_cast<float*>(a.o)[i] = o;
  } else {
    store_elem(a.o, a.qtype, i, o / fmaxf(L, 1e-30f));
  }
}

template <typename T, int G, int P2, int J>
__global__ void __launch_bounds__(THREADS)
gqa_decode_split_kernel(const GqaArgs a) {
  constexpr int GPW = 32 / P2;          // position groups a warp
  constexpr int NG = WARPS * GPW;       // position groups a CTA
  constexpr int COLS = P2 * VEC;        // columns the lanes of a group hold
  __shared__ float sm_m[NG][G];
  __shared__ float sm_l[NG][G];
  __shared__ __align__(16) float sm_o[NG][G][COLS];

  const int lane = threadIdx.x & 31;
  const int sub = lane % P2;            // columns [8 sub, 8 sub + 8)
  const int gid = (threadIdx.x >> 5) * GPW + lane / P2;
  long long blk = blockIdx.x;
  const int split = (int)(blk % a.splits);
  blk /= a.splits;
  const int hc = (int)(blk % a.hchunks);
  blk /= a.hchunks;
  const int kvh = (int)(blk % a.hkv);
  const int b = (int)(blk / a.hkv);
  const int h0 = kvh * a.g + hc * MAXG;           // first query head
  const int gn = min(MAXG, a.g - hc * MAXG);      // heads served, <= G
  const int len = min(a.length, a.T);
  const int t0 = split * a.width;
  if (t0 >= len) {
    if (a.splits == 1)        // the only split: the empty state is final
      for (int i = threadIdx.x; i < gn * a.D; i += THREADS)
        write_final(a, b * a.hq + h0 + i / a.D, i % a.D, NEG_INF, 0.f, 0.f);
    return;
  }
  const int t1 = min(t0 + a.width, len);
  const bool live = sub * VEC < a.D;

  float q[G][VEC];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      q[h][e] = (h < gn && live)
                    ? load_elem(a.q, a.qtype,
                                b * a.q_sb + (long long)(h0 + h) * a.q_sh +
                                    sub * VEC + e) * a.scale2
                    : 0.f;
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[h][e] = 0.f;
  }

  const long long rs = (long long)a.hkv * a.D;    // row stride (elements)
  const long long head = ((long long)b * a.T * a.hkv + kvh) * a.D + sub * VEC;
  const T* kp = static_cast<const T*>(a.k) + head;
  const T* vp = static_cast<const T*>(a.v) + head;

  for (int pass = t0; pass < t1; pass += NG * J) {
    const int tb = pass + gid * J;
    Row<T> kr[J], vr[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (live && tb + j < t1) {
        load_row(kr[j], kp + (long long)(tb + j) * rs);
        load_row(vr[j], vp + (long long)(tb + j) * rs);
      } else {
        zero_row(kr[j]);
        zero_row(vr[j]);
      }
    }
    float s[J][G];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float kf[VEC];
      to_float(kr[j], kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(q[h][e], kf[e], d);
        s[j][h] = d;
      }
    }
#pragma unroll
    for (int off = P2 / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int h = 0; h < G; ++h)
          s[j][h] += __shfl_xor_sync(FULL, s[j][h], off);
    float vf[J][VEC];
#pragma unroll
    for (int j = 0; j < J; ++j) to_float(vr[j], vf[j]);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float cm = NEG_INF;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (tb + j < t1) cm = fmaxf(cm, s[j][h]);
      const float mn = fmaxf(m[h], cm);
      const float alpha = fast_exp2(m[h] - mn);
      float p[J], ps = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        p[j] = tb + j < t1 ? fast_exp2(s[j][h] - mn) : 0.f;
        ps += p[j];
      }
      l[h] = l[h] * alpha + ps;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x = acc[h][e] * alpha;
#pragma unroll
        for (int j = 0; j < J; ++j) x = fmaf(p[j], vf[j][e], x);
        acc[h][e] = x;
      }
      m[h] = mn;
    }
  }

  // the CTA's groups -> one (m, l, o) per head
  if (sub == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) sm_m[gid][h] = m[h];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float top = NEG_INF;
#pragma unroll
    for (int i = 0; i < NG; ++i) top = fmaxf(top, sm_m[i][h]);
    const float f = fast_exp2(m[h] - top);
    if (sub == 0) sm_l[gid][h] = l[h] * f;
    float4* dst = reinterpret_cast<float4*>(&sm_o[gid][h][sub * VEC]);
    dst[0] = make_float4(acc[h][0] * f, acc[h][1] * f, acc[h][2] * f,
                         acc[h][3] * f);
    dst[1] = make_float4(acc[h][4] * f, acc[h][5] * f, acc[h][6] * f,
                         acc[h][7] * f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * a.D; i += THREADS) {
    const int h = i / a.D, c = i - h * a.D;
    float top = NEG_INF, L = 0.f, o = 0.f;
    for (int k = 0; k < NG; ++k) {
      top = fmaxf(top, sm_m[k][h]);
      L += sm_l[k][h];
      o += sm_o[k][h][c];
    }
    const int row = b * a.hq + h0 + h;
    if (a.splits == 1) {
      write_final(a, row, c, top, L, o);
    } else {
      const long long pi = (long long)row * a.splits + split;
      if (c == 0) {
        a.part_m[pi] = top;
        a.part_l[pi] = L;
      }
      a.part_o[pi * a.D + c] = o;
    }
  }
}

template <typename T, int G, int P2>
int launch_split(const GqaArgs& a, cudaStream_t s) {
  constexpr int BUDGET = G <= 2 ? 128 : G <= 4 ? 64 : 32;  // bytes a lane
  constexpr int RAW = BUDGET / (VEC * (int)sizeof(T));
  constexpr int J = RAW < 2 ? 2 : RAW > 8 ? 8 : RAW;
  const long long grid = (long long)a.B * a.hkv * a.hchunks * a.splits;
  gqa_decode_split_kernel<T, G, P2, J><<<(unsigned)grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int by_lanes(const GqaArgs& a, cudaStream_t s) {
  const int chunks = a.D / VEC;
  if (chunks <= 8) return launch_split<T, G, 8>(a, s);
  if (chunks <= 16) return launch_split<T, G, 16>(a, s);
  return launch_split<T, G, 32>(a, s);
}

template <typename T>
int by_heads(const GqaArgs& a, cudaStream_t s) {
  const int gm = a.g < MAXG ? a.g : MAXG;
  switch (gm) {
    case 1: return by_lanes<T, 1>(a, s);
    case 2: return by_lanes<T, 2>(a, s);
    case 3: return by_lanes<T, 3>(a, s);
    case 4: return by_lanes<T, 4>(a, s);
    default: return by_lanes<T, 8>(a, s);
  }
}

// the split kernel over K/V of each element type, one per source file
int launch_bf16(const GqaArgs& a, cudaStream_t s);
int launch_f16(const GqaArgs& a, cudaStream_t s);
int launch_f32(const GqaArgs& a, cudaStream_t s);

}  // namespace gqa_att
