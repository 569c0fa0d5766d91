// R1 fixture: a CUDA source that retypes framing's multipliers instead of
// taking them as -D defines from kernels/cuda_lib.py.
#include <stdint.h>

constexpr uint32_t M4_MULT = 0x85EBCA6Bu;  // framing.M4_MULT, retyped

/* a literal in a comment is no violation: 0x27D4EB2F */
__device__ uint32_t mix(uint32_t slot) {
  const char* note = "nor in a string: 0x9E3779B1";
  (void)note;
  return slot * 0x27D4EB2FU + 0x5eed;
}
