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
// K3 has a second entry, cram_decode_attention_leaves, that takes the
// cache state's own leaves (slots, slots_overflow, strips, markers,
// packed_mask, valid_per_page, predictor) with their batch strides, so the
// serve tier's attend reads its cache in place instead of copying the flat
// view first.  Only the addressing differs (LeafSlots against FlatSlots in
// cram_attention.cuh: flat slot s is page lane s % LANES of group
// s / LANES; an overflow slot's all-zero strip row is made in shared
// memory); the body, the splits and the merge are the same, so the two
// entries give the same bits.
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
// Design.  The grid is (B, Hkv x head chunks, splits) for K3 and (Hkv x
// head chunks, splits) for K6; a split is a run of kk flat slots (the last
// may be shorter), kk chosen in Python from n alone (at most 16 splits),
// so K3 and K6 split a sequence the same way whatever B is.  A KV head's G
// query heads go to the fewest chunks of at most 8 (G = 12: two of 6);
// each chunk's CTA stages the split's rows again (an L2 hit after the
// first), and only chunk 0 of KV head 0 books K3's byte pair.  One CTA of
// DP = 32 * ceil(D / 32) threads (the head_dim padded to whole warps, so
// head_dim 8..128 in steps of 8 run on DPL = DP / 32 of 1..4) owns the gn
// query heads of its chunk over its split and walks it in stages of at
// most ROWS token rows of one slot:
//   * warp 0 reads the split's slot descriptors, one slot per lane, 32 at a
//     time (valid counts; the marker compare over the Hkv strip tails as
//     4-byte loads issued together); where it books K3's byte pair it
//     also counts the split's (raw, cram) bytes in integers;
//   * a stage's rows of the head (page x 2D int16, 8 KB at head_dim 128)
//     and its strip base row are copied to shared memory with cp.async,
//     double-buffered: stage i+1 is in flight while stage i computes.  The
//     staged row puts K at [0, D) and V at [DP, DP + D); the pad columns
//     are zeroed once per CTA and never loaded, and q's pad columns are 0,
//     so a pad column adds exactly 0 to every dot product;
//   * scores: a warp per row, two rows at a time where the registers
//     allow; each lane holds DPL elements of q for every head (consecutive
//     columns for DPL 2 and 4, every 32nd for DPL 1 and 3) and decodes its
//     DPL raw K values into the LANES pages (prmt / shifts against base <<
//     16); the LANES x GMAX partial dot products reduce across the warp,
//     the first one or two butterfly steps sending the page lanes to
//     different half-warps.  No step is guarded per head: a guard around a
//     shuffle makes ptxas branch around each one and run them one by one;
//   * softmax per stage: the maximum from per-warp maxima, one rescale of
//     the running state per stage instead of per token, p = exp(s - m)
//     once per score and the stage's sum by warp g % WARPS;
//   * P.V: thread d owns column d of V for every head, decodes its raw V
//     value from the staged tile and sums a row's page lanes before they
//     join the accumulator; columns past D are not written;
//   * a second kernel merges the splits in split order (so the result does
//     not depend on which CTA ends first) and adds K3's per-split byte
//     pairs, exact in integers and with nothing to zero beforehand.
// The per-head register arrays are sized by GMAX: the chunk's head count
// itself for 3 or 4, 2 for 1 or 2, 8 above; at GMAX <= 4 the CTAs are
// bounded to 5 per SM (4 for the padded body at DPL 4).  Static shared
// memory: 2 tiles of ROWS x 2 DP int16, 2 base rows, the stage's ROWS x
// LANES x GMAX scores and the descriptors (under 21 KB).
//
// Two instantiation sets of the one body (cram_attention.cuh), built as
// three translation units in parallel: this file fixes head_dim 64 and
// 128 at compile time (no pad, the per-head arrays sized for G = 2, 3, 4
// or 8), cram_attention_general_{pair,quad}.cu take every other head_dim
// at run time (GMAX 2, 4 or 8).  A runtime head_dim costs the fixed shapes registers:
// at head_dim 128 with G = 3 or 4 it pushed ptxas past the 102 registers
// that 5 CTAs of 128 threads leave, and it spilled.

#include "cram_attention.cuh"

namespace {

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

// head_dim a multiple of 8 (16-byte row chunks) up to 128 (four V columns
// a thread); any whole GQA group
bool geometry_ok(int hq, int D, int n, int hkv, int lanes, int kk) {
  return n > 0 && hkv > 0 && hq > 0 && hq % hkv == 0 && kk > 0 && D >= 8 &&
         D <= 32 * 4 && D % 8 == 0 && (lanes == 2 || lanes == 4);
}

}  // namespace

// the split kernel on the body that fits head_dim D
static int launch_splits_for(const cram_att::DecodeArgs& a, cudaStream_t s) {
  const bool fixed = a.D == 64 || a.D == 128;
  if (a.lanes == 2)
    return fixed ? launch_splits<true, 2>(a, s)
                 : cram_att::launch_general_pair(a, s);
  return fixed ? launch_splits<true, 4>(a, s)
               : cram_att::launch_general_quad(a, s);
}

// K3's split kernel and its merge
static int run_k3(const cram_att::DecodeArgs& a, void* out, void* bytes,
                  cudaStream_t s) {
  const int err = launch_splits_for(a, s);
  if (err) return err;
  const int nj = (a.n + a.kk - 1) / a.kk;
  cram_decode_combine<<<a.B * a.hq, a.D, 0, s>>>(
      a.part_m, a.part_l, a.part_acc, a.part_bytes, nj, a.D, a.hq,
      (float*)out, (int32_t*)bytes);
  return (int)cudaGetLastError();
}

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
  const cram_att::DecodeArgs a{
      (const float*)q, (const int16_t*)slots, (const int16_t*)strips,
      (const int32_t*)markers, (const int32_t*)valid, pred, B, hq, D, n, page,
      hkv, lanes, kk, shared, scale, slot_bytes, strip_bytes, (float*)part_m,
      (float*)part_l, (float*)part_acc, (int32_t*)part_bytes, true, nullptr};
  return run_k3(a, out, bytes, (cudaStream_t)stream);
}

// K3 reading the cache state's leaves in place: slots (B?, n, page, Hkv,
// D2), over (B?, n, page, ...) or (B?, n, 3, page, ...), strips (B?, n,
// Hkv, D2+2), markers (n,), mask (B?, n) bool, valid (B?, lanes * n),
// pred (B?, n) bool, for n groups; each batch stride in elements (0 for a
// shared cache).  The same body and merge as the flat entry over the slot
// list physical_view would build from them, so the same bits.
extern "C" int cram_decode_attention_leaves(
    const void* q, const void* slots, const void* over, const void* strips,
    const void* markers, const void* mask, const void* valid, const void* pred,
    long long sb_slots, long long sb_over, long long sb_strips,
    long long sb_mask, long long sb_valid, long long sb_pred, int B, int hq,
    int D, int n_groups, int page, int hkv, int lanes, int kk, float scale,
    int slot_bytes, int strip_bytes, void* part_m, void* part_l,
    void* part_acc, void* part_bytes, void* out, void* bytes, void* stream) {
  const int n = n_groups * lanes;
  if (!geometry_ok(hq, D, n, hkv, lanes, kk)) return (int)cudaErrorInvalidValue;
  const cram_att::Leaves leaves{(const int16_t*)over, (const uint8_t*)mask,
                                sb_slots, sb_over, sb_strips, sb_mask,
                                sb_valid, sb_pred};
  const cram_att::DecodeArgs a{
      (const float*)q, (const int16_t*)slots, (const int16_t*)strips,
      (const int32_t*)markers, (const int32_t*)valid, pred, B, hq, D, n, page,
      hkv, lanes, kk, 0, scale, slot_bytes, strip_bytes, (float*)part_m,
      (float*)part_l, (float*)part_acc, (int32_t*)part_bytes, true, &leaves};
  return run_k3(a, out, bytes, (cudaStream_t)stream);
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
  const cram_att::DecodeArgs a{
      (const float*)q, (const int16_t*)slots, (const int16_t*)strips,
      (const int32_t*)markers, (const int32_t*)valid, nullptr, 1, hq, D, n,
      page, hkv, lanes, kk, 0, scale, 0, 0, (float*)part_m, (float*)part_l,
      (float*)part_acc, nullptr, false, nullptr};
  const int err = launch_splits_for(a, s);
  if (err) return err;
  const int nj = (n + kk - 1) / kk;
  cram_decode_combine<<<hq, D, 0, s>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      nullptr, nj, D, hq, (float*)out, nullptr);
  return (int)cudaGetLastError();
}
