// K3 / K6 on the general body for pair slots (2 page lanes): head_dim
// any multiple of 8 from 8 to 128 other than 64 and 128, padded inside the
// CTA to whole warps (DPL 1..4) and known at run time.  A translation unit
// of its own, so that nvcc builds it beside the others; the design note
// is at the top of cram_attention.cu.

#include "cram_attention.cuh"

int cram_att::launch_general_pair(const DecodeArgs& a, cudaStream_t s) {
  return launch_splits<false, 2>(a, s);
}
