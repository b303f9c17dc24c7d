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

static inline int rt_popcount(unsigned long long mask) {
  return __builtin_popcountll(mask);
}

// -- launch plans -------------------------------------------------------------
// The host plans of kernels/apply_gate/ops.py arrive as packed int64 arrays.
// A bit-run table maps the low bits of a compact index to scattered bit
// positions: run i covers `len[i]` bits from bit `lo[i]`, which take the
// compact bits from `off[i]`.  Packed as [count, lo[32], len[32], off[32]];
// unused runs are all 0 and contribute nothing.
constexpr int RT_MAX_RUNS = 32;

struct RtRuns {
  int count;
  int lo[RT_MAX_RUNS];
  int len[RT_MAX_RUNS];
  int off[RT_MAX_RUNS];
};

static inline const long long* rt_unpack_runs(const long long* p,
                                              RtRuns* r) {
  r->count = (int)p[0];
  for (int i = 0; i < RT_MAX_RUNS; ++i) {
    r->lo[i] = (int)p[1 + i];
    r->len[i] = (int)p[1 + RT_MAX_RUNS + i];
    r->off[i] = (int)p[1 + 2 * RT_MAX_RUNS + i];
  }
  return p + 1 + 3 * RT_MAX_RUNS;
}

// Scatter the compact bits of x to the runs' positions (NR > 0: the first NR
// runs, unrolled; NR == 0: all `count` runs).
template <int NR, typename T>
__device__ __forceinline__ T rt_pdep(T x, const RtRuns& r) {
  T out = 0;
  if constexpr (NR > 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
      out |= ((x >> r.off[i]) & ((T(1) << r.len[i]) - T(1))) << r.lo[i];
  } else {
    for (int i = 0; i < r.count; ++i)
      out |= ((x >> r.off[i]) & ((T(1) << r.len[i]) - T(1))) << r.lo[i];
  }
  return out;
}

// Gather the bits of x at the runs' positions into a compact index.
template <int NR, typename T>
__device__ __forceinline__ T rt_pext(T x, const RtRuns& r) {
  T out = 0;
  if constexpr (NR > 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
      out |= ((x >> r.lo[i]) & ((T(1) << r.len[i]) - T(1))) << r.off[i];
  } else {
    for (int i = 0; i < r.count; ++i)
      out |= ((x >> r.lo[i]) & ((T(1) << r.len[i]) - T(1))) << r.off[i];
  }
  return out;
}

// -- asynchronous copies (sm_80+) ----------------------------------------------
__device__ __forceinline__ void rt_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void rt_cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void rt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void rt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Persistent grid size: as many blocks of `kernel` as fit on the card at
// once, at most `work`.  The kernel is first allowed `smem` bytes of dynamic
// shared memory.
template <typename F>
static inline cudaError_t rt_persistent_grid(F kernel, int threads,
                                             size_t smem, long long work,
                                             int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(work < cap ? (work > 0 ? work : 1) : cap);
  return cudaSuccess;
}
