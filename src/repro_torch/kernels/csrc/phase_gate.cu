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
// int32[2^w].  The launch plan (kernels/apply_gate/ops.py, phase_plan)
// arrives as a packed int64 array.
//
// Bound on an H100 SXM: each amplitude is read once and written once (16
// bytes with both planes) for 6 flops, and each phase / perm entry is read
// once, so the kernel is bound by memory: 5.2 ms at n = 30, w = 25.
//
// Design.  The plan's cut s splits the amplitude index into spans of 2^s
// contiguous amplitudes; every access to the state is a 16-byte chunk,
// neighbouring threads on neighbouring chunks, with 32-bit offsets inside a
// span.  Three modes:
// - stream (pure phase on a cluster with free bits above its lowest bit):
//   a work item fixes the batch row, the cluster bits at or above s and the
//   top free bits; it stages the 2^(cluster bits below s) phase entries its
//   spans need in shared memory once and streams its spans past them.  A
//   wide cluster on the low bits (qft's and qrc's bits 0..23 plus one high
//   bit) would otherwise stream its 256 MB phase vector once per value of
//   the free bits; here each entry is read once.  The Pallas kernel keeps
//   its phase block resident the same way.
// - tile (a permutation that moves bits below s): a tile is the spans the
//   cluster bits at or above s select, at one value of the free bits; it is
//   staged by cp.async through a ring of two buffers in a persistent block
//   and gathered from shared memory, and the output leaves as contiguous
//   16-byte chunks.  On the card this beat gathering from global memory
//   at every permutation tried that has cluster bits below s.
// - direct (a pure phase on the cluster bits c..n-1, a permutation of bits
//   at or above s only, or one too wide for a tile): one chunk per thread
//   reads its phase entry and gathers its source from global memory, as
//   whole chunks when the lowest cluster bit is at least 2; consecutive
//   chunks meet a top-run cluster's entries in order, each once.
// Stream and direct launch one block per work item (a flat grid) rather
// than persistent blocks: for a pure stream the flat grid kept more loads
// in flight and measured faster on the card.  The bit gathers and
// scatters use run tables (specialised for 1, 2 and up to 4 runs, and
// general).  Out of place, since a gather in place would race.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSliceLog = 12;           // stream: phase entries per item
constexpr int kItemSpansLog = 8;        // stream: spans per item, 2^m
constexpr int kMaxItemSpans = 1 << kItemSpansLog;
constexpr int kMaxSpanLog = 24;         // stream: 32-bit offsets in a span
constexpr int kTileLog = 13;            // tile: amplitudes per buffer, plane
constexpr int kTile = 1 << kTileLog;
constexpr int kMaxTileSpans = 1 << (kTileLog - 2);
constexpr int kStages = 2;              // tile: buffers in the ring
constexpr int kMaxGrid = 1 << 22;       // stream, direct: blocks

enum Mode { kStream = 0, kTileMode = 1, kDirect = 2 };

struct PhaseParams {
  int n, w, s, m, w_low, h, nfree;
  int low_mask;                     // cluster bits below s
  unsigned long long cluster_mask;
  RtRuns low, hi, freeh, all;
  long long items_per_row, total_items, p_stride;
};

__device__ __forceinline__ float4 cmul4(float4 re, float4 im, float2 p0,
                                       float2 p1, float2 p2, float2 p3,
                                       float4* out_im) {
  *out_im = make_float4(p0.x * im.x + p0.y * re.x, p1.x * im.y + p1.y * re.y,
                        p2.x * im.z + p2.y * re.z, p3.x * im.w + p3.y * re.w);
  return make_float4(p0.x * re.x - p0.y * im.x, p1.x * re.y - p1.y * im.y,
                     p2.x * re.z - p2.y * im.z, p3.x * re.w - p3.y * im.w);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
phase_stream_kernel(const float* __restrict__ in, float* __restrict__ out,
                    const float* __restrict__ p_re,
                    const float* __restrict__ p_im,
                    const __grid_constant__ PhaseParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* s_base = reinterpret_cast<unsigned long long*>(smem_raw);
  float2* s_ph = reinterpret_cast<float2*>(s_base + kMaxItemSpans);
  const int tid = threadIdx.x;
  const unsigned long long N = 1ull << p.n;
  const int chunk_log = p.s - 2;
  const int span_chunks = 1 << chunk_log;
  const int item_chunks = 1 << (p.m + chunk_log);
  const int fh_hi_bits = p.nfree - p.m;
  // the 4 amplitudes of a chunk share their phase entry
  const bool uniform = p.w_low == 0 || p.low.lo[0] >= 2;

  for (long long it = blockIdx.x; it < p.total_items; it += gridDim.x) {
    const long long b = it / p.items_per_row;
    const unsigned long long rem = (unsigned long long)(it % p.items_per_row);
    const unsigned long long hc = rem >> fh_hi_bits;
    const unsigned long long fh_hi = rem & ((1ull << fh_hi_bits) - 1ull);
    __syncthreads();   // every thread is done with the previous item
    const float* pr = p_re + b * p.p_stride + (hc << p.w_low);
    const float* pi = p_im + b * p.p_stride + (hc << p.w_low);
    for (int i = tid; i < (1 << p.w_low); i += kThreads)
      s_ph[i] = make_float2(pr[i], pi[i]);
    const unsigned long long hbase = rt_pdep<0>(hc, p.hi);
    for (int i = tid; i < (1 << p.m); i += kThreads)
      s_base[i] = hbase | rt_pdep<0>((fh_hi << p.m) | i, p.freeh);
    __syncthreads();
    const float* src = in + (size_t)b * 2 * N;
    float* dst = out + (size_t)b * 2 * N;
#pragma unroll 4
    for (int e = tid; e < item_chunks; e += kThreads) {
      const int o = (e & (span_chunks - 1)) << 2;
      const unsigned long long g = s_base[e >> chunk_log] + o;
      const float4 re = __ldg(reinterpret_cast<const float4*>(src + g));
      const float4 im = __ldg(reinterpret_cast<const float4*>(src + N + g));
      float2 q0, q1, q2, q3;
      if (uniform) {
        q0 = q1 = q2 = q3 = s_ph[rt_pext<NR>(o, p.low)];
      } else {
        q0 = s_ph[rt_pext<NR>(o, p.low)];
        q1 = s_ph[rt_pext<NR>(o + 1, p.low)];
        q2 = s_ph[rt_pext<NR>(o + 2, p.low)];
        q3 = s_ph[rt_pext<NR>(o + 3, p.low)];
      }
      float4 nim;
      const float4 nre = cmul4(re, im, q0, q1, q2, q3, &nim);
      *reinterpret_cast<float4*>(dst + g) = nre;
      *reinterpret_cast<float4*>(dst + N + g) = nim;
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
phase_tile_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ p_re,
                  const float* __restrict__ p_im,
                  const int* __restrict__ perm,
                  const __grid_constant__ PhaseParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);      // [stage][plane][tile]
  unsigned long long* s_span =
      reinterpret_cast<unsigned long long*>(buf + 2 * kStages * kTile);

  const long long t_begin = p.total_items * blockIdx.x / gridDim.x;
  const long long t_end = p.total_items * (blockIdx.x + 1) / gridDim.x;
  if (t_begin >= t_end) return;   // the whole block leaves together

  const int tid = threadIdx.x;
  const unsigned long long N = 1ull << p.n;
  const int s = p.s, w_low = p.w_low;
  const int span_mask = (1 << s) - 1;
  const int chunks = 1 << (s + p.h - 2);
  const int entry_mask = (1 << w_low) - 1;
  for (int j = tid; j < (1 << p.h); j += kThreads)
    s_span[j] = rt_pdep<0>((unsigned long long)j, p.hi);

  auto tile_base = [&](long long t) {
    return rt_pdep<0>((unsigned long long)(t % p.items_per_row), p.freeh);
  };
  auto issue_load = [&](long long t, int stage) {
    const float* src =
        in + (size_t)(t / p.items_per_row) * 2 * N + tile_base(t);
    float* dre = buf + stage * 2 * kTile;
    for (int e = tid; e < chunks; e += kThreads) {
      const int a = e << 2;
      const unsigned long long g = s_span[a >> s] + (a & span_mask);
      rt_cp_async16(dre + a, src + g);
      rt_cp_async16(dre + kTile + a, src + N + g);
    }
    rt_cp_async_commit();
  };

  __syncthreads();   // span table ready
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_begin + i < t_end) issue_load(t_begin + i, i);
    else rt_cp_async_commit();
  }
  for (long long t = t_begin; t < t_end; ++t) {
    const int stage = (int)((t - t_begin) % kStages);
    rt_cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t staged; every thread done with tile t - 1
    const long long next = t + kStages - 1;   // into tile t - 1's buffer
    if (next < t_end) issue_load(next, (int)((next - t_begin) % kStages));
    else rt_cp_async_commit();
    const long long b = t / p.items_per_row;
    const float* xr = buf + stage * 2 * kTile;
    const float* xi = xr + kTile;
    const float* pr = p_re ? p_re + b * p.p_stride : nullptr;
    const float* pi = p_im ? p_im + b * p.p_stride : nullptr;
    float* dst = out + (size_t)b * 2 * N + tile_base(t);
    for (int e = tid; e < chunks; e += kThreads) {
      const int a = e << 2;
      const int j = a >> s;
      const int o = a & span_mask;
      float vr[4], vi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int oi = o + i;
        const int r = (j << w_low) | rt_pext<NR>(oi, p.low);
        const int pr_ = __ldg(perm + r);
        const int sl = ((pr_ >> w_low) << s) | (oi & ~p.low_mask) |
                       rt_pdep<NR>(pr_ & entry_mask, p.low);
        vr[i] = xr[sl];
        vi[i] = xi[sl];
        if (pr != nullptr) {
          const float c = __ldg(pr + r), d = __ldg(pi + r);
          const float nr = c * vr[i] - d * vi[i];
          vi[i] = c * vi[i] + d * vr[i];
          vr[i] = nr;
        }
      }
      const unsigned long long g = s_span[j] + o;
      __stcs(reinterpret_cast<float4*>(dst + g),
             make_float4(vr[0], vr[1], vr[2], vr[3]));
      __stcs(reinterpret_cast<float4*>(dst + N + g),
             make_float4(vi[0], vi[1], vi[2], vi[3]));
    }
  }
}

template <int NR, int V>
__global__ void __launch_bounds__(kThreads)
phase_direct_kernel(const float* __restrict__ in, float* __restrict__ out,
                    const float* __restrict__ p_re,
                    const float* __restrict__ p_im,
                    const int* __restrict__ perm,
                    const __grid_constant__ PhaseParams p) {
  const unsigned long long N = 1ull << p.n;
  const unsigned long long per_row = N / V;
  const unsigned long long keep = ~p.cluster_mask;
  // the V amplitudes of a chunk share their cluster row
  const bool uniform = V == 1 || p.all.lo[0] >= 2;
  for (unsigned long long e =
           (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
       e < (unsigned long long)p.total_items;
       e += (unsigned long long)gridDim.x * kThreads) {
    const unsigned long long b = e / per_row;
    const unsigned long long x0 = (e % per_row) * V;
    const float* src = in + b * 2 * N;
    float* dst = out + b * 2 * N;
    const float* pr = p_re ? p_re + b * p.p_stride : nullptr;
    const float* pi = p_im ? p_im + b * p.p_stride : nullptr;
    float vr[V], vi[V];
    if (uniform) {
      const unsigned long long r = rt_pext<NR>(x0, p.all);
      unsigned long long s0 = x0;
      if (perm != nullptr)
        s0 = (x0 & keep) |
             rt_pdep<NR>((unsigned long long)(unsigned)__ldg(perm + r), p.all);
      if constexpr (V == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src + s0));
        const float4 c = __ldg(reinterpret_cast<const float4*>(src + N + s0));
        vr[0] = a.x, vr[1] = a.y, vr[2] = a.z, vr[3] = a.w;
        vi[0] = c.x, vi[1] = c.y, vi[2] = c.z, vi[3] = c.w;
      } else {
        vr[0] = src[s0];
        vi[0] = src[N + s0];
      }
      if (pr != nullptr) {
        const float c = __ldg(pr + r), d = __ldg(pi + r);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float nr = c * vr[i] - d * vi[i];
          vi[i] = c * vi[i] + d * vr[i];
          vr[i] = nr;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const unsigned long long x = x0 + i;
        const unsigned long long r = rt_pext<NR>(x, p.all);
        unsigned long long sx = x;
        if (perm != nullptr)
          sx = (x & keep) |
               rt_pdep<NR>((unsigned long long)(unsigned)__ldg(perm + r),
                           p.all);
        vr[i] = __ldg(src + sx);
        vi[i] = __ldg(src + N + sx);
        if (pr != nullptr) {
          const float c = __ldg(pr + r), d = __ldg(pi + r);
          const float nr = c * vr[i] - d * vi[i];
          vi[i] = c * vi[i] + d * vr[i];
          vr[i] = nr;
        }
      }
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst + x0) =
          make_float4(vr[0], vr[1], vr[2], vr[3]);
      *reinterpret_cast<float4*>(dst + N + x0) =
          make_float4(vi[0], vi[1], vi[2], vi[3]);
    } else {
      dst[x0] = vr[0];
      dst[N + x0] = vi[0];
    }
  }
}

// Run-table specialisation: 1, 2, up to 4 runs, or any number.
template <template <int> class Launch, typename... A>
cudaError_t by_runs(int runs, A... args) {
  if (runs <= 1) return Launch<1>::run(args...);
  if (runs == 2) return Launch<2>::run(args...);
  if (runs <= 4) return Launch<4>::run(args...);
  return Launch<0>::run(args...);
}

struct Args {
  const float* in;
  float* out;
  const float* p_re;
  const float* p_im;
  const int* perm;
  cudaStream_t stream;
};

template <int NR>
struct LaunchStream {
  static cudaError_t run(const Args& a, const PhaseParams& p) {
    const size_t smem = kMaxItemSpans * sizeof(unsigned long long) +
                        (sizeof(float2) << kSliceLog);
    cudaError_t err = cudaFuncSetAttribute(
        phase_stream_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    // one block per item where the grid allows (faster than persistent)
    const int grid = (int)(p.total_items < kMaxGrid ? p.total_items
                                                    : kMaxGrid);
    phase_stream_kernel<NR><<<grid, kThreads, smem, a.stream>>>(
        a.in, a.out, a.p_re, a.p_im, p);
    return cudaGetLastError();
  }
};

template <int NR>
struct LaunchTile {
  static cudaError_t run(const Args& a, const PhaseParams& p) {
    const size_t smem = 2 * kStages * kTile * sizeof(float) +
                        kMaxTileSpans * sizeof(unsigned long long);
    int grid = 0;
    cudaError_t err = rt_persistent_grid(phase_tile_kernel<NR>, kThreads,
                                         smem, p.total_items, &grid);
    if (err != cudaSuccess) return err;
    phase_tile_kernel<NR><<<grid, kThreads, smem, a.stream>>>(
        a.in, a.out, a.p_re, a.p_im, a.perm, p);
    return cudaGetLastError();
  }
};

template <int NR>
struct LaunchDirect {
  template <int V>
  static cudaError_t go(const Args& a, const PhaseParams& p) {
    // one chunk per thread where the grid allows: a flat stream keeps more
    // loads in flight than a persistent grid-stride loop
    const long long blocks = (p.total_items + kThreads - 1) / kThreads;
    const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
    phase_direct_kernel<NR, V><<<grid, kThreads, 0, a.stream>>>(
        a.in, a.out, a.p_re, a.p_im, a.perm, p);
    return cudaGetLastError();
  }
  static cudaError_t run(const Args& a, const PhaseParams& p) {
    return p.n >= 2 ? go<4>(a, p) : go<1>(a, p);
  }
};

}  // namespace

// in/out: f32[batch, 2, 2^n] (distinct buffers); p_re/p_im: f32[Bp, 2^w] or
// both NULL (pure permutation), p_batched = (Bp == batch); perm: int32[2^w]
// or NULL (pure phase); plan: int64[] from ops.phase_plan().pack() (host
// memory): [mode, n, w, s, m, low runs, high runs, free runs, all runs].
RT_EXPORT int rt_apply_phase_gate(const void* in, void* out, const void* p_re,
                                  const void* p_im, int p_batched,
                                  const void* perm, int batch,
                                  const void* plan, void* stream) {
  const long long* P = static_cast<const long long*>(plan);
  PhaseParams p = {};
  const int mode = (int)P[0];
  p.n = (int)P[1];
  p.w = (int)P[2];
  p.s = (int)P[3];
  p.m = (int)P[4];
  const long long* q = rt_unpack_runs(P + 5, &p.low);
  q = rt_unpack_runs(q, &p.hi);
  q = rt_unpack_runs(q, &p.freeh);
  rt_unpack_runs(q, &p.all);
  for (int i = 0; i < p.low.count; ++i) {
    p.w_low += p.low.len[i];
    p.low_mask |= ((1 << p.low.len[i]) - 1) << p.low.lo[i];
  }
  for (int i = 0; i < p.all.count; ++i)
    p.cluster_mask |= ((1ull << p.all.len[i]) - 1ull) << p.all.lo[i];
  p.h = p.w - p.w_low;
  p.nfree = p.n - p.s - p.h;
  const bool has_phase = p_re != nullptr;
  if (p.w < 1 || p.w > 31 || p.n < p.w || p.n > 38 || batch < 1 ||
      batch > 65535 || (p.cluster_mask >> p.n) != 0 ||
      rt_popcount(p.cluster_mask) != p.w || has_phase != (p_im != nullptr) ||
      p.nfree < 0 || p.m < 0 || p.m > p.nfree)
    return (int)cudaErrorInvalidValue;
  p.p_stride = p_batched ? (1ll << p.w) : 0;
  Args a = {static_cast<const float*>(in), static_cast<float*>(out),
            static_cast<const float*>(p_re), static_cast<const float*>(p_im),
            static_cast<const int*>(perm), static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case kStream:
      if (!has_phase || perm != nullptr || p.s < 2 || p.s > kMaxSpanLog ||
          p.w_low > kSliceLog || p.m > kItemSpansLog)
        return (int)cudaErrorInvalidValue;
      p.items_per_row = 1ll << (p.h + p.nfree - p.m);
      p.total_items = p.items_per_row * batch;
      return (int)by_runs<LaunchStream>(p.low.count, a, p);
    case kTileMode:
      if (perm == nullptr || p.s < 2 || p.w_low < 1 ||
          p.s + p.h > kTileLog)
        return (int)cudaErrorInvalidValue;
      p.items_per_row = 1ll << p.nfree;
      p.total_items = p.items_per_row * batch;
      return (int)by_runs<LaunchTile>(p.low.count, a, p);
    case kDirect:
      p.total_items = (long long)batch << (p.n >= 2 ? p.n - 2 : p.n);
      return (int)by_runs<LaunchDirect>(p.all.count, a, p);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
