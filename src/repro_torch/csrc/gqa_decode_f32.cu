// A1's split kernel over float32 K/V (see gqa_decode.cu).

#include "gqa_decode.cuh"

namespace gqa_att {

int launch_f32(const GqaArgs& a, cudaStream_t s) {
  return by_heads<float>(a, s);
}

}  // namespace gqa_att
