// Fused dense gate on the planar state: a 2^k x 2^k complex unitary U applied
// to every gate-bit group of an n-qubit state, optionally controlled.
//
// Replaces: src/repro/kernels/apply_gate/apply_gate.py::_kernel, launched by
// apply_fused_gate_kernel (the Pallas fused-gate kernel).
//
// Layout: the state is f32[B, 2, 2^n] (re plane, then im plane, per row);
// U is given as re and im planes f32[Bu, 2^k, 2^k] with Bu = 1 (broadcast)
// or Bu = B (one unitary per parameter binding).  Bit m of U's index is the
// m-th lowest gate qubit.  The launch plan (kernels/apply_gate/ops.py,
// fused_plan) arrives as a packed int64 array.
//
// Bound on an H100 SXM: each amplitude is read once and written once (16
// bytes with both planes) and takes 8 * 2^k fp32 flops, so at n = 30 the
// kernel is bound by memory (3.35 TB/s) for k <= 5 (5.1 ms; choose_f(H100) =
// 4) and by fp32 FMA (67 TFLOP/s) for k >= 6 (16.4 ms at k = 7).
//
// Design.  Memory first: a tile is cut by address, not by group.  The plan's
// cut s splits the gate bits into L below s and h at or above it; a tile is
// the 2^h spans of 2^s contiguous amplitudes that the high gate bits select
// (2^(s+h) <= 4096 amplitudes), so every global load and store is a run of
// 16-byte chunks, neighbouring threads on neighbouring addresses, at any
// placement of the gate bits.  Gate bits below s are resolved in shared
// memory by index arithmetic; the tile is stored there with a swizzle (the
// 16-byte chunk index XOR the 128-byte row index) and the plan deals a
// tile's groups to lanes so that the addresses one column reads fall in
// distinct banks wherever the placement allows.
// Overlap: each block is persistent and walks a contiguous range of tiles
// through a ring of two buffers fed by cp.async, so tile i+1 is in flight
// while tile i computes and stores (on the card, a grid of one block per
// tile was clearly slower, and a third buffer, which costs a block per SM,
// too).  The tile leaves with streaming stores: it is not read again soon.
// U is staged in shared memory (transposed) once per block, and again only
// when the block's range crosses into another batch row with its own U.
// Compute: each thread holds a TR x TG register tile (rows of U x groups:
// 4 x 4 for k = 2..5, 8 x 2 for k = 6, 7) and per column reads TG inputs
// per plane and TR entries of U per plane as 16-byte vectors, so the FMA
// pipes, not shared memory, bound the large-k case.  Sums are plain fp32
// FMA: no TF32, no tensor cores.  Results go back into the staged tile, and
// the tile is stored from there.  Controls: a tile whose control bits at or
// above s are not all 1 is stored as it was staged; a group whose control
// bits below s are not all 1 is left as staged.  Out of place.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 7;
constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;   // amplitudes per buffer and plane
constexpr int kMaxSpans = 1 << kMaxK;
constexpr int kMaxGbits = 16;
constexpr int kStages = 2;             // tile buffers in the ring

struct FusedParams {
  int n, s, low, ngb;
  unsigned long long cmask_lo, cmask_hi;
  int q[8];
  int gbits[kMaxGbits];
  RtRuns tile_runs;
  long long tiles_per_row, total_tiles, u_stride;
};

template <int K>
struct Cfg {
  static constexpr int D = 1 << K;
  static constexpr int TR = K == 1 ? 2 : (K <= 5 ? 4 : 8);   // rows of U
  static constexpr int TG = 16 / TR;                          // groups
  static constexpr int RB = D / TR;                           // row blocks
  static constexpr size_t smem_bytes =
      2 * kStages * kTile * sizeof(float) +
      kMaxSpans * sizeof(unsigned long long) +
      2 * D * D * sizeof(float) + D * sizeof(int);
};

__device__ __forceinline__ int swz(int a) { return a ^ (((a >> 5) & 7) << 2); }

template <int TR>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[TR]) {
  if constexpr (TR == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < TR; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
fused_gate_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ u_re,
                  const float* __restrict__ u_im,
                  const __grid_constant__ FusedParams p) {
  using C = Cfg<K>;
  constexpr int D = C::D, TR = C::TR, TG = C::TG, RB = C::RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);      // [stage][plane][tile]
  unsigned long long* s_span =
      reinterpret_cast<unsigned long long*>(buf + 2 * kStages * kTile);
  float* s_ur = reinterpret_cast<float*>(s_span + kMaxSpans);  // [c][r]
  float* s_ui = s_ur + D * D;
  int* s_off = reinterpret_cast<int*>(s_ui + D * D);   // swizzled, per row

  const long long t_begin = p.total_tiles * blockIdx.x / gridDim.x;
  const long long t_end = p.total_tiles * (blockIdx.x + 1) / gridDim.x;
  if (t_begin >= t_end) return;   // the whole block leaves together

  const int tid = threadIdx.x;
  const unsigned long long N = 1ull << p.n;
  const int s = p.s, low = p.low, h = K - low;
  const int span_mask = (1 << s) - 1;
  const int vec = s >= 2 ? 4 : 1;
  const int chunks = (1 << (s + h)) / vec;
  const int groups = 1 << (s - low);

  for (int j = tid; j < (1 << h); j += kThreads) {
    unsigned long long off = 0;
    for (int m = 0; m < h; ++m)
      if ((j >> m) & 1) off |= 1ull << p.q[low + m];
    s_span[j] = off;
  }
  for (int r = tid; r < D; r += kThreads) {
    int off = (r >> low) << s;
    for (int m = 0; m < low; ++m)
      if ((r >> m) & 1) off |= 1 << p.q[m];
    s_off[r] = swz(off);
  }

  // this thread's rows and groups (the same in every tile)
  const int units = RB * ((groups + TG - 1) / TG);
  const bool active = tid < units;
  const int r0 = (tid % RB) * TR;
  const int gs = tid / RB;
  int sb[TG];
  bool on[TG];
#pragma unroll
  for (int j = 0; j < TG; ++j) {
    const int gi = gs * TG + j;
    int base = 0;
    for (int i = 0; i < p.ngb; ++i)
      if ((gi >> i) & 1) base |= 1 << p.gbits[i];
    const bool valid = active && gi < groups;
    sb[j] = valid ? swz(base) : 0;
    on[j] = valid && ((unsigned long long)base & p.cmask_lo) == p.cmask_lo;
  }

  auto tile_base = [&](long long t) {
    return rt_pdep<0>((unsigned long long)(t % p.tiles_per_row), p.tile_runs);
  };
  auto issue_load = [&](long long t, int stage) {
    const float* src =
        in + (size_t)(t / p.tiles_per_row) * 2 * N + tile_base(t);
    float* dre = buf + stage * 2 * kTile;
    float* dim = dre + kTile;
    for (int e = tid; e < chunks; e += kThreads) {
      const int a = e * vec;
      const unsigned long long g = s_span[a >> s] + (a & span_mask);
      const int sa = swz(a);
      if (vec == 4) {
        rt_cp_async16(dre + sa, src + g);
        rt_cp_async16(dim + sa, src + N + g);
      } else {
        rt_cp_async4(dre + sa, src + g);
        rt_cp_async4(dim + sa, src + N + g);
      }
    }
    rt_cp_async_commit();
  };

  long long cur_row = -1;
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
    const long long row = t / p.tiles_per_row;
    if (cur_row < 0 || (p.u_stride != 0 && row != cur_row)) {
      const float* ur = u_re + row * p.u_stride;
      const float* ui = u_im + row * p.u_stride;
      for (int i = tid; i < D * D; i += kThreads) {
        const int r = i >> K, c = i & (D - 1);
        s_ur[c * D + r] = ur[i];
        s_ui[c * D + r] = ui[i];
      }
      __syncthreads();
    }
    cur_row = row;
    const bool tile_on = (tile_base(t) & p.cmask_hi) == p.cmask_hi;
    float* xr = buf + stage * 2 * kTile;
    float* xi = xr + kTile;

    float acc_r[TR][TG], acc_i[TR][TG];
    if (tile_on && active) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TG; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const int oc = s_off[c];
        float vr[TG], vi[TG], ar[TR], ai[TR];
#pragma unroll
        for (int j = 0; j < TG; ++j) {
          vr[j] = xr[oc ^ sb[j]];
          vi[j] = xi[oc ^ sb[j]];
        }
        load_rows<TR>(s_ur + c * D + r0, ar);
        load_rows<TR>(s_ui + c * D + r0, ai);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TG; ++j) {
            acc_r[i][j] = fmaf(ar[i], vr[j], acc_r[i][j]);
            acc_r[i][j] = fmaf(-ai[i], vi[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(ar[i], vi[j], acc_i[i][j]);
            acc_i[i][j] = fmaf(ai[i], vr[j], acc_i[i][j]);
          }
      }
    }
    __syncthreads();   // every thread is done reading the staged inputs
    if (tile_on && active) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int orow = s_off[r0 + i];
#pragma unroll
        for (int j = 0; j < TG; ++j)
          if (on[j]) {
            xr[orow ^ sb[j]] = acc_r[i][j];
            xi[orow ^ sb[j]] = acc_i[i][j];
          }
      }
    }
    __syncthreads();   // results in place
    float* dst = out + (size_t)row * 2 * N + tile_base(t);
    for (int e = tid; e < chunks; e += kThreads) {
      const int a = e * vec;
      const unsigned long long g = s_span[a >> s] + (a & span_mask);
      const int sa = swz(a);
      if (vec == 4) {
        __stcs(reinterpret_cast<float4*>(dst + g),
               *reinterpret_cast<const float4*>(xr + sa));
        __stcs(reinterpret_cast<float4*>(dst + N + g),
               *reinterpret_cast<const float4*>(xi + sa));
      } else {
        dst[g] = xr[sa];
        dst[N + g] = xi[sa];
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* in, float* out, const float* u_re,
                   const float* u_im, const FusedParams& p,
                   cudaStream_t stream) {
  const size_t smem = Cfg<K>::smem_bytes;
  int grid = 0;
  cudaError_t err = rt_persistent_grid(fused_gate_kernel<K>, kThreads, smem,
                                       p.total_tiles, &grid);
  if (err != cudaSuccess) return err;
  fused_gate_kernel<K><<<grid, kThreads, smem, stream>>>(in, out, u_re,
                                                         u_im, p);
  return cudaGetLastError();
}

}  // namespace

// in/out: f32[batch, 2, 2^n] (distinct buffers); u_re/u_im: f32[Bu, 2^k, 2^k]
// with u_batched = (Bu == batch); plan: int64[] from ops.fused_plan().pack()
// (host memory): [n, k, s, L, tr, tg, cmask_lo, cmask_hi, ngb, q[8],
// gbits[16], tile runs].
RT_EXPORT int rt_apply_fused_gate(const void* in, void* out, const void* u_re,
                                  const void* u_im, int u_batched, int batch,
                                  const void* plan, void* stream) {
  const long long* P = static_cast<const long long*>(plan);
  FusedParams p = {};
  p.n = (int)P[0];
  const int k = (int)P[1];
  p.s = (int)P[2];
  p.low = (int)P[3];
  const int tr = (int)P[4], tg = (int)P[5];
  p.cmask_lo = (unsigned long long)P[6];
  p.cmask_hi = (unsigned long long)P[7];
  p.ngb = (int)P[8];
  for (int i = 0; i < 8; ++i) p.q[i] = (int)P[9 + i];
  for (int i = 0; i < kMaxGbits; ++i) p.gbits[i] = (int)P[17 + i];
  rt_unpack_runs(P + 17 + kMaxGbits, &p.tile_runs);
  const int h = k - p.low;
  const int want_tr = k == 1 ? 2 : (k <= 5 ? 4 : 8);
  if (k < 1 || k > kMaxK || p.n < k || p.n > 38 || batch < 1 ||
      batch > 65535 || tr != want_tr || tg != 16 / want_tr || p.low < 0 ||
      h < 0 || p.s + h > kTileLog || p.s + h > p.n ||
      p.ngb != p.s - p.low || p.ngb > kMaxGbits)
    return (int)cudaErrorInvalidValue;
  p.tiles_per_row = 1ll << (p.n - p.s - h);
  p.total_tiles = p.tiles_per_row * batch;
  p.u_stride = u_batched ? (1ll << (2 * k)) : 0;
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  const float* ur = static_cast<const float*>(u_re);
  const float* ui = static_cast<const float*>(u_im);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(i, o, ur, ui, p, s);
    case 2: return (int)launch<2>(i, o, ur, ui, p, s);
    case 3: return (int)launch<3>(i, o, ur, ui, p, s);
    case 4: return (int)launch<4>(i, o, ur, ui, p, s);
    case 5: return (int)launch<5>(i, o, ur, ui, p, s);
    case 6: return (int)launch<6>(i, o, ur, ui, p, s);
    default: return (int)launch<7>(i, o, ur, ui, p, s);
  }
}
