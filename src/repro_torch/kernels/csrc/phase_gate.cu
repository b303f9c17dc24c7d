// Diagonal / permutation (monomial) fused gate on the planar state:
//   out[x] = phase[r(x)] * in[src(x)]
// where r(x) is the cluster row formed by the w cluster bits of amplitude
// index x, and src(x) is x with its cluster bits replaced by perm[r(x)].
// The gather is optional (pure phase) and so is the phase (pure
// permutation).  Controls were folded into the phase at lowering, so there
// is no predication.
//
// Replaces: src/repro/kernels/apply_gate/apply_gate.py::_diag_kernel,
// launched by apply_diag_gate_kernel (the Pallas diagonal/permutation
// kernel).
//
// Layout: state f32[B, 2, 2^n]; phase planes f32[Bp, 2^w] with Bp = 1
// (broadcast) or Bp = B (parameterized phases differ per binding); perm
// int32[2^w].  Cluster qubits arrive as a bit mask.
//
// Bound on an H100 SXM: each amplitude is read once and written once (16
// bytes with both planes) for 6 flops, so the kernel is bound by memory:
// 5.1 ms at n = 30 (3.35 TB/s), plus the phase and perm vectors read once.
//
// Design: a flat elementwise pass, one thread per output amplitude, so the
// writes are always coalesced and the reads are whenever the permutation
// leaves the low five bits alone.  The Pallas block of 2^w rows x lanes is
// not carried over: w reaches n - 5 for a diagonal cluster (25 at n = 30), and
// a 2^25-entry phase vector cannot live in shared memory.  Each thread reads
// its phase entry from global memory instead (neighbouring threads share
// entries whenever the cluster bits are not the lowest, so the reads are
// served from L1/L2).  The cluster bits are gathered run by run: a cluster
// of contiguous qubits costs one shift and mask.  The kernel is out of place,
// since a gather in place would race.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRuns = 32;

struct Runs {
  int lo[kMaxRuns];   // lowest state bit of the run
  int len[kMaxRuns];  // its length
  int off[kMaxRuns];  // the cluster-row bit its lowest bit maps to
  int count;
};

__global__ void __launch_bounds__(kThreads)
phase_gate_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ p_re,
                  const float* __restrict__ p_im, long long p_stride,
                  const int* __restrict__ perm, int n, Runs runs,
                  unsigned long long cluster_mask) {
  const unsigned long long N = 1ull << n;
  const unsigned long long x =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (x >= N) return;
  const int b = blockIdx.y;
  unsigned long long r = 0;
  for (int j = 0; j < runs.count; ++j)
    r |= ((x >> runs.lo[j]) & ((1ull << runs.len[j]) - 1ull)) << runs.off[j];
  unsigned long long src = x;
  if (perm != nullptr) {
    const unsigned long long pr = (unsigned int)perm[r];
    src = x & ~cluster_mask;
    for (int j = 0; j < runs.count; ++j)
      src |= ((pr >> runs.off[j]) & ((1ull << runs.len[j]) - 1ull))
             << runs.lo[j];
  }
  const float* xin = in + (size_t)b * 2 * N;
  float re = xin[src];
  float im = xin[N + src];
  if (p_re != nullptr) {
    const float a = p_re[(size_t)b * p_stride + r];
    const float c = p_im[(size_t)b * p_stride + r];
    const float nr = a * re - c * im;
    const float ni = a * im + c * re;
    re = nr;
    im = ni;
  }
  float* xo = out + (size_t)b * 2 * N;
  xo[x] = re;
  xo[N + x] = im;
}

}  // namespace

// in/out: f32[batch, 2, 2^n] (distinct buffers); p_re/p_im: f32[Bp, 2^w] or
// both NULL (pure permutation), p_batched = (Bp == batch); perm: int32[2^w]
// or NULL (pure phase); cluster_mask: the w cluster bits.
RT_EXPORT int rt_apply_phase_gate(const void* in, void* out, const void* p_re,
                                  const void* p_im, int p_batched,
                                  const void* perm, int batch, int n,
                                  unsigned long long cluster_mask,
                                  void* stream) {
  const int w = rt_popcount(cluster_mask);
  if (w < 1 || w > 31 || n < w || n > 38 || batch < 1 || batch > 65535 ||
      (cluster_mask >> n) != 0 || (p_re == nullptr) != (p_im == nullptr))
    return (int)cudaErrorInvalidValue;
  Runs runs = {};
  int bit_pos[64];
  rt_mask_bits(cluster_mask, bit_pos, 64);
  for (int m = 0; m < w; ++m) {
    if (m > 0 && bit_pos[m] == bit_pos[m - 1] + 1) {
      runs.len[runs.count - 1] += 1;
    } else {
      runs.lo[runs.count] = bit_pos[m];
      runs.len[runs.count] = 1;
      runs.off[runs.count] = m;
      runs.count += 1;
    }
  }
  const unsigned long long N = 1ull << n;
  const unsigned int blocks = (unsigned int)((N + kThreads - 1) / kThreads);
  phase_gate_kernel<<<dim3(blocks, batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(p_re), static_cast<const float*>(p_im),
      p_batched ? (1ll << w) : 0ll, static_cast<const int*>(perm), n, runs,
      cluster_mask);
  return (int)cudaGetLastError();
}
