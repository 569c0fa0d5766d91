// A1: GQA split-KV decode attention over the model's own KV cache
// ("flash-decoding"), the CUDA side of models/attention.py:
// decode_attention_state and chunked_decode_attention.
//
// Replaces no TPU kernel: the reference's decode attention
// (repro/models/attention.py:chunked_decode_attention) is plain jnp that
// XLA fuses.  The port's plain version (models/attention.py:
// decode_attention_state_plain) walks every 1,024-position chunk of the cache
// masked by `length`, repeats each K/V chunk for its query heads, and runs
// two einsums whose operands are copied first: ~200 eager operations a
// layer, and several times the cache's bytes moved.
//
//   q (B, Hq, D) bf16 / f16 / f32, any batch and head strides, unit column
//   stride; k, v (B, T, Hkv, D) contiguous, bf16 / f16 / f32 (the same
//   type); `length`: positions [0, min(length, T)) are attended
//   -> with `state`: the online-softmax state m, l (B, Hq) and o (B, Hq, D)
//      float32, m in natural-log units (no valid position: m = -1e30,
//      l = 0, o = 0, a state of weight 0 where ranks combine theirs);
//      without: o / max(l, 1e-30) (B, Hq, D) in q's type.
// Query head h reads KV head h / (Hq / Hkv), as repeat_interleave orders
// them.  Scale, scores, softmax and sums are float32.
//
// Bound on the H100: bytes.  Each valid K/V row of a head is D elements
// read once for the G = Hq / Hkv query heads it serves: 4 G FLOPs per
// element, 2 G FLOPs a byte in bf16 (1.5 at phi4's G = 3), far below the
// card's ~295 FLOPs a byte.  The floor is the valid rows' bytes at
// 3.35 TB/s (phi4-mini, B 48 at ~2,300 positions: ~450 MB a layer,
// ~0.14 ms).
//
// Design.
//   * Work split: one CTA per (sequence, KV head, chunk of at most 8 of its
//     query heads, split of positions).  It serves all the chunk's query
//     heads from the same K/V rows, so nothing is repeated and each K/V
//     byte leaves HBM once.  A head's row is D contiguous elements
//     (256 bytes at D 128 in bf16: two whole 128-byte lines) at a stride
//     of Hkv * D; the other split, a CTA per (sequence, split) over whole
//     rows of all KV heads, reads the same lines with fewer CTAs to spread
//     over the SMs, and needs every head's query rows in registers.
//   * Splits: `width` positions each, chosen in Python from B, Hkv, the
//     head chunks and T alone (never from `length`), so the grid of a
//     cache shape is fixed and the step can later be captured as a graph.
//     A split that starts at or past `length` returns at once; the split
//     that holds `length` stops there.  Rows past `length` are not read.
//   * Lanes: a group of P2 lanes (8, 16 or 32: the head's D / 8 rounded up
//     to a power of two) owns one position at a time; each lane holds 8
//     elements of the row as one 16-byte load (two in float32) and 8
//     elements of each query head, pre-scaled by log2(e) / sqrt(D).  A
//     group takes J consecutive positions a pass, J set by the registers
//     the heads leave (8 at G <= 2 in 2-byte types, down to 2): its J K
//     rows and J V rows are loaded together, so each warp keeps
//     J x 2 x 32 x 16 bytes in flight with no shared-memory staging (no
//     byte is used by two threads).  The partial dot products reduce
//     across the group by butterfly shuffles, unguarded per head.
//   * Softmax: base 2 (ex2.approx), one running max and one rescale per J
//     positions and head; masked positions weigh exactly 0.
//   * The CTA's groups merge their (m, l, o) in shared memory; with one
//     split the CTA writes the final state or output itself and the merge
//     is not launched.  Otherwise it writes its split's (m, l, o) to
//     scratch the wrapper allocates, and gqa_decode_merge_kernel (a warp
//     per (sequence, query head)) combines the splits that hold a valid
//     position, in split order, so the result does not depend on which
//     CTA ends first.
// The device body is gqa_decode.cuh; the split kernel over fp16 and
// float32 K/V compiles in gqa_decode_f16.cu and gqa_decode_f32.cu, in
// parallel with this file (bf16, the merge, the host entry).

#include "gqa_decode.cuh"

namespace gqa_att {

int launch_bf16(const GqaArgs& a, cudaStream_t s) {
  return by_heads<__nv_bfloat16>(a, s);
}

// the splits that hold a valid position -> the final state or output; a
// warp per (sequence, query head) row
__global__ void __launch_bounds__(THREADS)
gqa_decode_merge_kernel(const GqaArgs a) {
  __shared__ float sw[WARPS][MAX_SPLITS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= (long long)a.B * a.hq) return;
  const int len = min(a.length, a.T);
  const int n = len <= 0 ? 0 : (len + a.width - 1) / a.width;
  const float* pm = a.part_m + row * a.splits;
  const float* pl = a.part_l + row * a.splits;
  float top = NEG_INF;
  for (int s = lane; s < n; s += 32) top = fmaxf(top, pm[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = fmaxf(top, __shfl_xor_sync(FULL, top, off));
  float L = 0.f;
  for (int s = lane; s < n; s += 32) {
    const float w = fast_exp2(pm[s] - top);
    sw[warp][s] = w;
    L += w * pl[s];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(FULL, L, off);
  __syncwarp();
  const float* po = a.part_o + row * a.splits * a.D;
  for (int c = lane; c < a.D; c += 32) {
    float o = 0.f;
    for (int s = 0; s < n; ++s)
      o = fmaf(sw[warp][s], po[(long long)s * a.D + c], o);
    write_final(a, (int)row, c, top, L, o);
  }
}

}  // namespace gqa_att

using namespace gqa_att;

// q, k, v, q's batch and head strides, B, T, Hkv, Hq, D, K/V type, q type
// (0 f32, 1 f16, 2 bf16), length, split width, splits, state (1: write
// m, l, o float32; 0: write the output in q's type), scratch part_m,
// part_l, part_o (unused with one split), m, l, o, stream

extern "C" int cram_gqa_decode(const void* q, const void* k, const void* v,
                               long long q_sb, long long q_sh, int B, int T,
                               int hkv, int hq, int D, int kv_type,
                               int q_type, int length, int width, int splits,
                               int state, void* part_m, void* part_l,
                               void* part_o, void* m, void* l, void* o,
                               void* stream) {
  if (B <= 0 || T <= 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0 ||
      D % VEC != 0 || D < VEC || D > 256 || kv_type < F32 ||
      kv_type > BF16 || q_type < F32 || q_type > BF16 || width <= 0 ||
      splits < 1 || splits > MAX_SPLITS ||
      (long long)(splits - 1) * width >= T ||
      (long long)splits * width < T || o == nullptr ||
      (state && (m == nullptr || l == nullptr)) ||
      (splits > 1 &&
       (part_m == nullptr || part_l == nullptr || part_o == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  const int hchunks = (g + MAXG - 1) / MAXG;
  if ((long long)B * hkv * hchunks * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const GqaArgs a{q, k, v, q_sb, q_sh, B, T, hkv, hq, D, g, hchunks, splits,
                  width, length, q_type, state, LOG2E / sqrtf((float)D),
                  (float*)part_m, (float*)part_l, (float*)part_o, (float*)m,
                  (float*)l, o};
  cudaStream_t s = (cudaStream_t)stream;
  const int err = kv_type == BF16  ? launch_bf16(a, s)
                  : kv_type == F16 ? launch_f16(a, s)
                                   : launch_f32(a, s);
  if (err || splits == 1) return err;
  const long long rows = (long long)B * hq;
  gqa_decode_merge_kernel<<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS,
                            0, s>>>(a);
  return (int)cudaGetLastError();
}
