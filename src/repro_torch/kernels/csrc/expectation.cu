// <Z_q> = sum_x (-1)^{bit_q(x)} |amp_x|^2, one value per batch row, in one
// read of the state and with no state written back.
//
// Replaces: src/repro/kernels/expectation/expectation.py::_kernel, launched by
// expectation_z_kernel (the Pallas streaming reduction).
//
// Bound on an H100 SXM: the state is read once (8 bytes per amplitude with
// both planes) for 4 flops, so the kernel is bound by memory: 2.6 ms at
// n = 30 (3.35 TB/s).
//
// Design: the Pallas kernel adds into one (1, 1) output across grid steps
// that run in order; blocks on the GPU run in parallel and in no order.  Pass
// 1 has each block reduce a grid-stride slice of one row to one fp32 partial
// (neighbouring threads on neighbouring amplitudes, so the reads coalesce) in
// scratch[B, nblocks]; pass 2 has one block per row sum that row's partials.
// Both passes reduce in a fixed order (per-thread sums, then warp shuffles
// and one shared-memory step), and there are no float atomics, so a result
// repeats bit for bit from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Sum of `v` over the block, valid in thread 0; fixed reduction order.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < 32) {
    s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
z_partial_kernel(const float* __restrict__ in, float* __restrict__ partials,
                 int n, int q, int nblocks) {
  const unsigned long long N = 1ull << n;
  const int b = blockIdx.y;
  const float* re = in + (size_t)b * 2 * N;
  const float* im = re + N;
  const unsigned long long stride = (unsigned long long)nblocks * kThreads;
  float acc = 0.f;
  for (unsigned long long x =
           (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
       x < N; x += stride) {
    const float a = re[x];
    const float c = im[x];
    const float p = a * a + c * c;
    acc += ((x >> q) & 1ull) ? -p : p;
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[(size_t)b * nblocks + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
z_final_kernel(const float* __restrict__ partials, float* __restrict__ out,
               int nblocks) {
  const int b = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += kThreads)
    acc += partials[(size_t)b * nblocks + i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[b] = s;
}

}  // namespace

// in: f32[batch, 2, 2^n]; partials: f32[batch, nblocks] scratch; out:
// f32[batch].
RT_EXPORT int rt_expectation_z(const void* in, void* partials, void* out,
                               int batch, int n, int q, int nblocks,
                               void* stream) {
  if (n < 1 || n > 38 || q < 0 || q >= n || batch < 1 || batch > 65535 ||
      nblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  z_partial_kernel<<<dim3(nblocks, batch), kThreads, 0, s>>>(
      static_cast<const float*>(in), static_cast<float*>(partials), n, q,
      nblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  z_final_kernel<<<batch, kThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), nblocks);
  return (int)cudaGetLastError();
}
