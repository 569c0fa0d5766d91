// A1's split kernel over fp16 K/V (see gqa_decode.cu).

#include "gqa_decode.cuh"

namespace gqa_att {

int launch_f16(const GqaArgs& a, cudaStream_t s) {
  return by_heads<__half>(a, s);
}

}  // namespace gqa_att
