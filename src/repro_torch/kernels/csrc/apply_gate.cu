// Fused dense gate on the planar state: a 2^k x 2^k complex unitary U applied
// to every gate-bit group of an n-qubit state, optionally controlled.
//
// Replaces: src/repro/kernels/apply_gate/apply_gate.py::_kernel, launched by
// apply_fused_gate_kernel (the Pallas fused-gate kernel).
//
// Layout: the state is f32[B, 2, 2^n] (re plane, then im plane, per row);
// U is given as re and im planes f32[Bu, 2^k, 2^k] with Bu = 1 (broadcast)
// or Bu = B (one unitary per parameter binding).  Gate qubits arrive as a
// bit mask (ascending bit m of the mask <-> bit m of U's index, i.e. the
// qubits are sorted); control qubits as a second mask.
//
// Bound on an H100 SXM: each amplitude is read once and written once
// (16 bytes with both planes) and takes 8 * 2^k fp32 flops, so at n = 30 the
// kernel is bound by memory (3.35 TB/s) for k <= 5 (5.1 ms; choose_f(H100) =
// 4) and by fp32 FMA (67 TFLOP/s) for k >= 6 (16.4 ms at k = 7).
//
// Design: one block owns a tile of GT neighbouring gate-bit groups (group =
// the 2^k amplitudes that share a base index with the gate bits cleared) of
// one batch row.  It stages U (transposed) and the tile's inputs in shared
// memory — U alone is 128 KB at k = 7, above 48 KB, hence dynamic shared
// memory — with neighbouring threads on neighbouring bases so the loads and
// stores coalesce whenever the lowest gate bit is >= 5.  Inputs never sit in
// registers as a whole group (k = 7 would need 256 live floats): each thread
// computes a TR x 4 register tile of outputs (TR rows of U, 4 neighbouring
// groups), reading 4-wide vectors of inputs and TR entries of U per column,
// so a column costs 2 + 2 TR shared loads for 16 TR FMAs and the FMA pipes,
// not shared memory, bound the large-k case.  Sums are plain fp32 FMA: no
// TF32, no tensor cores.  Results go back through shared memory so the final
// stores coalesce.  The kernel is out of place: a group whose control bits
// are not all 1 is copied through from the input.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 7;

struct GateBits {
  int q[kMaxK];  // gate bit positions, ascending
};

template <int K>
__device__ __forceinline__ unsigned long long insert_zero_bits(
    unsigned long long g, const GateBits& bits) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const unsigned long long lo = g & ((1ull << bits.q[i]) - 1ull);
    g = ((g >> bits.q[i]) << (bits.q[i] + 1)) | lo;
  }
  return g;
}

template <int K>
struct Tile {
  static constexpr int D = 1 << K;               // group size
  static constexpr int TR = D < 4 ? D : 4;       // U rows per thread
  static constexpr int TG = 4;                   // groups per thread
  static constexpr int GT = kThreads * TR * TG / D;  // groups per block
  static constexpr int QUADS = GT / TG;
  static constexpr size_t smem_bytes =
      8 * (GT + D) + 4 * (2 * D * D + 2 * D * GT);
};

template <int K>
__global__ void __launch_bounds__(kThreads)
fused_gate_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ u_re,
                  const float* __restrict__ u_im, long long u_stride, int n,
                  GateBits bits, unsigned long long cmask, int gt_valid) {
  using T = Tile<K>;
  constexpr int D = T::D, TR = T::TR, GT = T::GT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* s_base = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* s_off = s_base + GT;
  float* s_ur = reinterpret_cast<float*>(s_off + D);   // transposed: [c][r]
  float* s_ui = s_ur + D * D;
  float* s_xr = s_ui + D * D;                          // [c][group]
  float* s_xi = s_xr + D * GT;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const unsigned long long N = 1ull << n;
  const unsigned long long g0 = (unsigned long long)blockIdx.x * gt_valid;
  const float* xin = in + (size_t)b * 2 * N;
  float* xout = out + (size_t)b * 2 * N;
  const float* ur = u_re + (size_t)b * u_stride;
  const float* ui = u_im + (size_t)b * u_stride;

  for (int i = tid; i < D * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s_ur[c * D + r] = ur[i];
    s_ui[c * D + r] = ui[i];
  }
  for (int r = tid; r < D; r += kThreads) {
    unsigned long long off = 0;
#pragma unroll
    for (int m = 0; m < K; ++m)
      if ((r >> m) & 1) off |= 1ull << bits.q[m];
    s_off[r] = off;
  }
  for (int gi = tid; gi < GT; gi += kThreads)
    s_base[gi] = gi < gt_valid ? insert_zero_bits<K>(g0 + gi, bits) : 0ull;
  __syncthreads();

  for (int e = tid; e < D * GT; e += kThreads) {
    const int c = e / GT, gi = e % GT;
    float vr = 0.f, vi = 0.f;
    if (gi < gt_valid) {
      const unsigned long long idx = s_base[gi] | s_off[c];
      vr = xin[idx];
      vi = xin[N + idx];
    }
    s_xr[e] = vr;
    s_xi[e] = vi;
  }
  __syncthreads();

  const int gq = (tid % T::QUADS) * 4;
  const int r0 = (tid / T::QUADS) * TR;
  float acc_r[TR][4], acc_i[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float4 xr4 = *reinterpret_cast<const float4*>(s_xr + c * GT + gq);
    const float4 xi4 = *reinterpret_cast<const float4*>(s_xi + c * GT + gq);
    const float xr[4] = {xr4.x, xr4.y, xr4.z, xr4.w};
    const float xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float a = s_ur[c * D + r0 + i];
      const float bb = s_ui[c * D + r0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_r[i][j] = fmaf(a, xr[j], acc_r[i][j]);
        acc_r[i][j] = fmaf(-bb, xi[j], acc_r[i][j]);
        acc_i[i][j] = fmaf(a, xi[j], acc_i[i][j]);
        acc_i[i][j] = fmaf(bb, xr[j], acc_i[i][j]);
      }
    }
  }
  __syncthreads();  // every thread is done reading the staged inputs
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    *reinterpret_cast<float4*>(s_xr + (r0 + i) * GT + gq) =
        make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
    *reinterpret_cast<float4*>(s_xi + (r0 + i) * GT + gq) =
        make_float4(acc_i[i][0], acc_i[i][1], acc_i[i][2], acc_i[i][3]);
  }
  __syncthreads();

  for (int e = tid; e < D * GT; e += kThreads) {
    const int r = e / GT, gi = e % GT;
    if (gi >= gt_valid) continue;
    const unsigned long long base = s_base[gi];
    const unsigned long long idx = base | s_off[r];
    if ((base & cmask) == cmask) {
      xout[idx] = s_xr[e];
      xout[N + idx] = s_xi[e];
    } else {
      xout[idx] = xin[idx];
      xout[N + idx] = xin[N + idx];
    }
  }
}

template <int K>
cudaError_t launch(const float* in, float* out, const float* u_re,
                   const float* u_im, long long u_stride, int batch, int n,
                   const GateBits& bits, unsigned long long cmask,
                   cudaStream_t stream) {
  using T = Tile<K>;
  const int log_groups = n - K;
  const int log_gt = __builtin_ctz(T::GT);
  const int log_valid = log_groups < log_gt ? log_groups : log_gt;
  const unsigned int blocks = 1u << (log_groups - log_valid);
  const size_t smem = T::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_gate_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_gate_kernel<K><<<dim3(blocks, batch), kThreads, smem, stream>>>(
      in, out, u_re, u_im, u_stride, n, bits, cmask, 1 << log_valid);
  return cudaGetLastError();
}

}  // namespace

// in/out: f32[batch, 2, 2^n] (distinct buffers); u_re/u_im: f32[Bu, 2^k, 2^k]
// with u_batched = (Bu == batch); gmask: the k gate bits; cmask: control bits.
RT_EXPORT int rt_apply_fused_gate(const void* in, void* out, const void* u_re,
                                  const void* u_im, int u_batched, int batch,
                                  int n, unsigned long long gmask,
                                  unsigned long long cmask, void* stream) {
  GateBits bits = {};
  const int k = rt_popcount(gmask);
  if (k < 1 || k > kMaxK || n < k || n > 38 || batch < 1 || batch > 65535 ||
      (gmask & cmask) != 0)
    return (int)cudaErrorInvalidValue;
  rt_mask_bits(gmask, bits.q, kMaxK);
  const long long d = 1ll << k;
  const long long u_stride = u_batched ? d * d : 0;
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  const float* ur = static_cast<const float*>(u_re);
  const float* ui = static_cast<const float*>(u_im);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
    case 2: return (int)launch<2>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
    case 3: return (int)launch<3>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
    case 4: return (int)launch<4>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
    case 5: return (int)launch<5>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
    case 6: return (int)launch<6>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
    default: return (int)launch<7>(i, o, ur, ui, u_stride, batch, n, bits, cmask, s);
  }
}
