// Shared by the port's CUDA sources: each is built into its own shared
// library with a plain C interface (see kernels/_build.py), so the helpers
// below are compiled once per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// cudaGetErrorString for the code an entry point returned.
RT_EXPORT const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bit positions set in `mask`, ascending; returns how many (at most `cap`).
static inline int rt_mask_bits(unsigned long long mask, int* out, int cap) {
  int k = 0;
  for (int b = 0; b < 64 && k < cap; ++b)
    if ((mask >> b) & 1ull) out[k++] = b;
  return k;
}

static inline int rt_popcount(unsigned long long mask) {
  return __builtin_popcountll(mask);
}
