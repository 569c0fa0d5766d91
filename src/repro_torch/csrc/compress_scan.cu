// K7: one-pass compressibility scan of a whole memory image.
//
// Replaces the Pallas kernel repro/kernels/compress_scan.py:_scan_kernel
// (launched by _scan_call, via compress_scan).  For every 64-byte line i:
//
//   lines (N, 64) u8  ->  out (4, N) i32 = sizes | fpc | bdi | status
//
//   fpc    FPC size in bytes: per 32-bit word a 3-bit prefix plus 4/8/16/32
//          payload bits (last-wins chain raw < half-se8 < pad16 < se16 <
//          repb < se8 < se4), zero runs at ceil(L/8) chunks of 6 bits,
//          the total rounded up to whole bytes;
//   bdi    best Base-Delta-Immediate payload over the six (base, delta)
//          modes, the base being the first non-immediate element and the
//          delta wrapped into the element width; rep8 forces 8, an
//          all-zero line 0;
//   sizes  min(min(fpc, bdi), 64) + 1 header byte;
//   status implicit-metadata class against slot i's device markers:
//          m2/m4 = (2i+1) * M + key on the tail word, the 16-word
//          Marker-IL (16i + j + 1) * IL + key, and their complements.
//
// Bound on the H100: the floor counted is bytes, 64 read and 16 written
// per line over 3.35 TB/s (0.376 ms for the 15.7 M-line Fig. 4 image).
// The work is integer compares, adds and logic on the ALU pipe (64 lanes
// a clock per SM; IMADs go to the FMA pipe), so the instructions a line
// costs decide whether a source runs at the memory's pace or the ALU's.
// The first kernel of this file spent some 1,400 a line in six full BDI
// mode tests in 64-bit arithmetic (111 registers, 4.1x the byte floor).
// This design spends them where the data needs them:
//
//   * 32-bit arithmetic wherever the element fits: 2- and 4-byte modes in
//     uint32_t, where "v fits d bytes" is one add and one unsigned compare
//     and the delta's wrap into the element width is the 32-bit add's own
//     (B = 4) or a test of the sum's second byte (B = 2); 8-byte modes as
//     (hi, lo) word pairs with the reference's test hi == lo >> 31.
//   * cheap lines first: an all-zero line (from FPC's zero mask) is BDI 0,
//     a rep8 line BDI 8, before any mode test.
//   * the six modes searched by base width, smallest payload first, with
//     the lemma (B, d') fits => (B, d) fits for d' < d: a failing (8, 4)
//     skips (8, 2) and (8, 1), a failing (4, 2) skips (4, 1).  An
//     incompressible line runs three mode tests, not six.
//   * each mode test decides from elements 0 and 1 where it can (random
//     data), from the mask of non-immediate elements where at most one is
//     (sparse data), and from the base and the next non-immediate element,
//     read by index from the line's copy in shared memory, where that one
//     is out of reach; only lines that fit with many non-immediate
//     elements compare all of them.
//   * FPC classes each word from t = x ^ (x << 1), whose bit j says that
//     bits j and j-1 of x differ: se4 / se8 / se16 are t < 2^4 / 2^8 /
//     2^16 and half-se8 is (t & 0xFF00FF00) == 0; repb is one byte
//     permute; zero words sit in a 16-bit mask whose run starts and
//     9-in-a-row ends give the zero-run chunks in one popc.
//   * classify compares one word against the Marker-IL family and walks
//     the other fifteen only when it matches.
//
// On an H100 SXM at 700 W (chip_smoke.py) this takes about 0.50 ms on the
// Fig. 4 image, 1.3x the byte floor, 45 registers and no spills: random,
// text, fp32-weight and token lines run at 1.2-1.3x their byte floor, at
// the memory's pace; bf16-weight, Adam-moment, pointer and sparse lines,
// which reach more mode tests, run at the ALU's pace, 1.5-2.1x theirs.
// FPC's fifteen or so instructions a word are then the largest fixed cost
// a line pays.
//
// One thread per line, the line in 16 registers from four 16-byte loads
// and in a shared-memory row that only its thread reads, four coalesced
// int32 stores.  The slot index of a line is its global index, so the
// kernel needs no padding of N.  Each bit trick has a numpy model in
// tests/test_torch_scan_rules.py, named beside it below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// compression.framing's multipliers, passed by kernels/cuda_lib.py as
// -DCRAM_<name>=<value>u (framing_defines), so that no copy can drift
#if !defined(CRAM_M2_MULT) || !defined(CRAM_M4_MULT) || !defined(CRAM_IL_MULT)
#error "build through repro_torch.kernels.cuda_lib, which passes framing's multipliers"
#endif
constexpr uint32_t M2_MULT = CRAM_M2_MULT;
constexpr uint32_t M4_MULT = CRAM_M4_MULT;
constexpr uint32_t IL_MULT = CRAM_IL_MULT;
constexpr int LINE_BYTES = 64;
constexpr int HEADER_BYTES = 1;
// compression.marker.LineStatus
constexpr int UNCOMP = 0, COMP2 = 1, COMP4 = 2, INVALID = 3, MAYBE_INVERTED = 4;

// ------------------------------------------------------------------- FPC

// Payload bits of one word (zero words give 4; the caller takes them out).
// t = x ^ (x << 1): x fits k signed bits iff t < 2^k
// (test_significant_bit_class_matches_the_range_chain).
__device__ __forceinline__ int fpc_word_bits(uint32_t x) {
  const uint32_t t = x ^ (x << 1);
  int b = 32;
  if (t < 0x10000u || (t & 0xFF00FF00u) == 0u || (x & 0xFFFFu) == 0u)
    b = 16;                                       // se16, half-se8, pad16
  if (t < 0x100u || __byte_perm(x, 0, 0) == x) b = 8;   // se8, repb
  if (t < 0x10u) b = 4;                                 // se4
  return b;
}

// Zero-run chunks of a 16-bit zero mask: a run of L <= 16 words costs
// ceil(L/8) chunks, one at its start and one more at its ninth word
// (test_zero_run_chunks_from_the_mask, all 2^16 masks).
__device__ __forceinline__ int zero_run_chunks(uint32_t z) {
  const uint32_t starts = z & ~(z << 1);
  uint32_t a = z & (z << 1);  // bit i: words i-1, i zero
  a &= a << 2;                // i-3 .. i
  a &= a << 4;                // i-7 .. i
  const uint32_t ninth = a & (z << 8) & ~(z << 9);
  return __popc(starts | ninth);
}

// --------------------------------------------------------------------- BDI
// (B, D): elements of B bytes, deltas of D.  A mode fits when every element
// is immediate (fits D bytes) or within D bytes of the base, the first
// non-immediate element, the delta wrapped into the element width.
//
// Each test first takes elements 0 and 1: where both are non-immediate and
// 1 is not within D bytes of 0 the mode fails, and incompressible data ends
// there.  Otherwise it builds the mask of non-immediate elements and passes
// with at most one of them (the common case of sparse data).  Else it reads
// the base (the lowest set bit) and the next non-immediate element by index
// from the line's copy in shared memory and fails if that one is out of
// reach (the common case of sparse data that does not fit); only then are
// the remaining elements compared, branch-free, in registers.  Every step is
// exact, so the result is the reference's
// (test_mode_tests_match_the_reference).

template <int D>
__device__ __forceinline__ bool fits_u32(uint32_t v) {
  if (D == 4) return true;
  constexpr uint32_t L = 1u << (8 * D - 1);
  return v + L < 2u * L;
}

// B = 8: the element (hi, lo) fits D bytes iff hi == lo >> 31 and lo fits
template <int D>
__device__ __forceinline__ bool fits_pair(uint32_t hi, uint32_t lo) {
  return hi == (uint32_t)((int32_t)lo >> 31) && fits_u32<D>(lo);
}

template <int D>
__device__ __forceinline__ bool delta_fits_pair(uint64_t e, uint64_t base) {
  const uint64_t d = e - base;  // 64-bit wrap
  return fits_pair<D>((uint32_t)(d >> 32), (uint32_t)d);
}

template <int D>
__device__ __forceinline__ bool mode_fits_b8(const uint32_t (&w)[16],
                                             const uint64_t* row) {
  const uint64_t e0 = ((uint64_t)w[1] << 32) | w[0];
  const uint64_t e1 = ((uint64_t)w[3] << 32) | w[2];
  if (!fits_pair<D>(w[1], w[0]) && !fits_pair<D>(w[3], w[2]) &&
      !delta_fits_pair<D>(e1, e0))
    return false;
  uint32_t far = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    far |= (uint32_t)!fits_pair<D>(w[2 * k + 1], w[2 * k]) << k;
  if ((far & (far - 1)) == 0) return true;
  const uint64_t base = row[__ffs(far) - 1];
  far &= far - 1;
  if (!delta_fits_pair<D>(row[__ffs(far) - 1], base)) return false;
  far &= far - 1;
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    ok &= !((far >> k) & 1) ||
          delta_fits_pair<D>(((uint64_t)w[2 * k + 1] << 32) | w[2 * k], base);
  return ok;
}

template <int D>
__device__ __forceinline__ bool mode_fits_b4(const uint32_t (&w)[16],
                                             const uint32_t* row) {
  if (!fits_u32<D>(w[0]) && !fits_u32<D>(w[1]) && !fits_u32<D>(w[1] - w[0]))
    return false;
  uint32_t far = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) far |= (uint32_t)!fits_u32<D>(w[i]) << i;
  if ((far & (far - 1)) == 0) return true;
  const uint32_t base = row[__ffs(far) - 1];
  far &= far - 1;
  if (!fits_u32<D>(row[__ffs(far) - 1] - base)) return false;  // 32-bit wrap
  far &= far - 1;
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    ok &= !((far >> i) & 1) || fits_u32<D>(w[i] - base);
  return ok;
}

// B = 2, D = 1 on whole words: the low halfword of x fits a signed byte
// iff byte 1 of x + 0x80 is 0, the high one iff byte 3 of x + 0x800000 is
// 0 (no carry crosses into the high half), and a delta h - b, taken on
// zero-extended halfwords, wraps mod 2^16 in the same byte-1 test
// (test_halfword_tests_on_whole_words).
__device__ __forceinline__ bool far_lo(uint32_t x) {
  return (x + 0x80u) & 0xFF00u;
}
__device__ __forceinline__ bool far_hi(uint32_t x) {
  return (x + 0x800000u) & 0xFF000000u;
}

// The mask of non-immediate halfwords, in integer arithmetic (built from
// per-halfword predicates, the card's compiler packed the bits of this
// mask into the wrong places): bit i for the low half of word i, bit 16 + i
// for its high half.  t holds byte 1 of x + 0x80 and byte 3 of
// x + 0x800000; bit 15 / 31 of ((t & 0x7F007F00) + 0x7F007F00) | t is set
// iff that byte is not 0 (test_halfword_far_mask).
__device__ __forceinline__ uint32_t far_b2(const uint32_t (&w)[16]) {
  uint32_t far = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t t = __byte_perm(w[i] + 0x80u, w[i] + 0x800000u, 0x7610);
    far |= ((((t & 0x7F007F00u) + 0x7F007F00u) | t) & 0x80008000u) >> (15 - i);
  }
  return far;
}

__device__ __forceinline__ bool mode_fits_b2(const uint32_t (&w)[16],
                                             const uint16_t* row) {
  if (far_lo(w[0]) && far_hi(w[0]) && far_lo((w[0] >> 16) - w[0])) return false;
  uint32_t far = far_b2(w);
  if ((far & (far - 1)) == 0) return true;
  // the base is the first non-immediate halfword: in the first word that
  // has one, its low half if that is non-immediate, else its high half
  const int k = __ffs((far | far >> 16) & 0xFFFFu) - 1;
  const int low = (far >> k) & 1;
  const uint32_t base = row[2 * k + 1 - low];
  far &= ~(1u << (k + 16 * (1 - low)));
  const int p = __ffs(far) - 1;  // halfword 2 (p & 15) + (p >> 4)
  if (far_lo((uint32_t)row[2 * (p & 15) + (p >> 4)] - base)) return false;
  far &= far - 1;
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    ok &= !((far >> i) & 1) || !far_lo(w[i] - base);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    ok &= !((far >> (16 + i)) & 1) || !far_lo((w[i] >> 16) - base);
  return ok;
}

// Smallest payload first within each base width, skipping what the lemma
// (B, d') fits => (B, d) fits for d' < d rules out: 17 (8,1) < 22 (4,1) <
// 25 (8,2) < 38 (4,2) = 38 (2,1) < 41 (8,4)
// (test_mode_search_matches_the_reference,
// test_lemma_smaller_delta_fit_implies_larger).
__device__ __forceinline__ int bdi_bytes(const uint32_t (&w)[16], uint32_t z,
                                         const uint4* row) {
  const uint64_t* r8 = reinterpret_cast<const uint64_t*>(row);
  const uint32_t* r4 = reinterpret_cast<const uint32_t*>(row);
  const uint16_t* r2 = reinterpret_cast<const uint16_t*>(row);
  if (z == 0xFFFFu) return 0;
  bool rep8 = true;
#pragma unroll
  for (int i = 2; i < 16; ++i) rep8 &= w[i] == w[i & 1];
  if (rep8) return 8;
  int best = LINE_BYTES;
  if (mode_fits_b8<4>(w, r8)) {
    if (mode_fits_b8<1>(w, r8)) return 17;
    best = mode_fits_b8<2>(w, r8) ? 25 : 41;
  }
  if (best == 25) return mode_fits_b4<1>(w, r4) ? 22 : 25;
  if (mode_fits_b4<2>(w, r4)) return mode_fits_b4<1>(w, r4) ? 22 : 38;
  if (mode_fits_b2(w, r2)) return 38;
  return best;
}

// ---------------------------------------------------------------- classify

// il_j = il_0 + j * IL and w == ~il iff w + il == 0xFFFFFFFF, so one word
// decides whether the other fifteen are compared at all.
__device__ __forceinline__ int classify(const uint32_t (&w)[16], uint32_t idx,
                                        uint32_t key) {
  const uint32_t two = 2u * idx + 1u;
  const uint32_t m2 = two * M2_MULT + key;
  const uint32_t m4 = two * M4_MULT + key;
  const uint32_t tail = w[15];
  const uint32_t il0 = (idx * 16u + 1u) * IL_MULT + key;
  bool is_il = false, inv_il = false;
  if (w[0] == il0 || w[0] + il0 == 0xFFFFFFFFu) {
    is_il = inv_il = true;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t il = il0 + (uint32_t)j * IL_MULT;
      is_il &= w[j] == il;
      inv_il &= w[j] + il == 0xFFFFFFFFu;
    }
  }
  int s = UNCOMP;
  if (tail == ~m2 || tail == ~m4 || inv_il) s = MAYBE_INVERTED;
  if (is_il) s = INVALID;
  if (tail == m4) s = COMP4;
  if (tail == m2) s = COMP2;
  return s;
}

__global__ void __launch_bounds__(256)
compress_scan_kernel(const uint4* __restrict__ lines, long long n, uint32_t key,
                     int32_t* __restrict__ out) {
  // each thread's line, in rows of 80 bytes: four 16-byte stores of 8
  // threads at a time land on 32 distinct banks; a thread reads back only
  // its own row
  __shared__ uint4 stage[256 * 5];
  uint4* row = stage + threadIdx.x * 5;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = lines[i * 4 + q];
    row[q] = v;
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  int bits = 3 * 16;
  uint32_t z = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bits += fpc_word_bits(w[j]);
    z |= (uint32_t)(w[j] == 0u) << j;
  }
  // a zero word is 3 + 4 bits in the sum above and 0 outside its run
  bits += 6 * zero_run_chunks(z) - 7 * __popc(z);
  const int f = (bits + 7) >> 3;
  const int b = bdi_bytes(w, z, row);
  out[i] = min(min(f, b), LINE_BYTES) + HEADER_BYTES;
  out[n + i] = f;
  out[2 * n + i] = b;
  out[3 * n + i] = classify(w, (uint32_t)i, key);
}

}  // namespace

extern "C" int cram_compress_scan(const void* lines, long long n, uint32_t key,
                                  void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  compress_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)lines, n, key, (int32_t*)out);
  return (int)cudaGetLastError();
}
