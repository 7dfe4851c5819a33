// The sparse-expert (mixture-of-experts) feed-forward for Hopper (sm_90a) without a host
// synchronization: every row count is produced and read on the device.  The Python wrapper is
// loongx_tpu_torch/ops/moe.py; every kernel's name starts with moe_ (and holds none of the dense
// path's names), so a profiler's trace tells the expert path from the dense GEMMs.
//
//   * moe_route_kernel: one warp a token.  The router logits x . W_g^T in fp32 from the bf16
//     row and the fp32 router weight [E, D], a softmax, the top k (largest first, ties to the
//     lower expert index); the weights are not renormalised.
//   * moe_plan_kernel: one block over every (token, slot) pair in token order.  Each expert's
//     row count, its rows' start in the grouped buffer padded up to the GEMM's 128-row tile (so
//     no tile straddles two experts), each pair's row (the pairs of one expert keep token
//     order, so the layout is deterministic), the token each row holds (-1 on padding) and its
//     routing weight (0 on padding).
//   * moe_quant_kernel: one warp a (row, activation group).  The W8A8 codes of a bf16 row
//     (scale absmax / 127, 1 when absmax is 0; quant8::codes8, IEEE division's codes), read
//     through an optional row map (the gather: -1 writes zero codes and scale 1); rows at or
//     past an optional device-side count are left alone.
//   * moe_gemm_kernel: the grouped W8A8 GEMM, the persistent pipeline of w8a8_pipeline.cuh
//     (qmm_wgmma_kernel's) over a buffer of row groups: group g holds rows [start_g, start_g +
//     count_g), read from device memory when the kernel starts, its weight the g-th slice of a
//     stack stored K-major ([G, N, K] in memory: the [G, K, N] stack's slices transposed) and
//     its scales the g-th row of [G, N].  The TMA maps cover the whole buffer (its size, a
//     bound the host knows), so a launch serves every group.  Epilogues (fp32, then one cast
//     to bf16): EPI_SWIGLU over a gate/up weight whose columns are
//     interleaved per 128-wide tile (64 gate columns, then the 64 up columns that pair with
//     them), h = silu(z_gate) * z_up written as a [M, N / 2] tile of 64 columns; EPI_ROWS,
//     z = acc * scale, times the row's routing weight where one is given.
//   * moe_combine_kernel: one warp a token.  out = resid + gate_seg * ((routed rows of the
//     token, in slot order) + its shared row), in fp32 from the bf16 rows, one cast: a gather,
//     no atomics, so the sum is the same on every run.
//
// What bounds the GEMM: as qmm_wgmma_kernel, int8 tensor work (the expert products at M of a
// few thousand rows a group do ~2000 operations a weight byte); a skipped tile costs a read of
// the group bounds in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "quant8.cuh"
#include "w8a8_pipeline.cuh"

namespace {

constexpr int MAX_GROUPS = 8;  // experts a launch (the router's E, the GEMM's G)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __low2float(h[i]);
    f[2 * i + 1] = __high2float(h[i]);
  }
}

// ---- routing --------------------------------------------------------------------------------

constexpr int ROUTE_WARPS = 4;

__global__ void __launch_bounds__(ROUTE_WARPS * 32)
moe_route_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ wg, int M, int D,
                 int E, int top_k, int* __restrict__ idx, float* __restrict__ wts) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * ROUTE_WARPS + threadIdx.x / 32;
  if (t >= M) return;
  float acc[MAX_GROUPS];
#pragma unroll
  for (int e = 0; e < MAX_GROUPS; ++e) acc[e] = 0.f;
  const __nv_bfloat16* row = x + static_cast<long long>(t) * D;
  for (int c = lane; c < D / 8; c += 32) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(row + 8 * c), f);
#pragma unroll
    for (int e = 0; e < MAX_GROUPS; ++e) {
      if (e >= E) break;
      const float* w = wg + static_cast<long long>(e) * D + 8 * c;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[e] = fmaf(f[i], w[i], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < MAX_GROUPS; ++e)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane != 0) return;
  float mx = acc[0];
  for (int e = 1; e < E; ++e) mx = fmaxf(mx, acc[e]);
  float p[MAX_GROUPS], sum = 0.f;
  for (int e = 0; e < E; ++e) {
    p[e] = expf(acc[e] - mx);
    sum += p[e];
  }
  for (int e = 0; e < E; ++e) p[e] = p[e] / sum;
  unsigned used = 0u;
  for (int k = 0; k < top_k; ++k) {
    int best = -1;
    for (int e = 0; e < E; ++e)
      if (!(used & (1u << e)) && (best < 0 || p[e] > p[best])) best = e;
    used |= 1u << best;
    idx[t * top_k + k] = best;
    wts[t * top_k + k] = p[best];
  }
}

// ---- planning -------------------------------------------------------------------------------

constexpr int PLAN_THREADS = 1024;
constexpr int ROW_TILE = 128;  // the GEMM's M tile: each group's rows start on a multiple

__global__ void __launch_bounds__(PLAN_THREADS)
moe_plan_kernel(const int* __restrict__ idx, const float* __restrict__ wts, int pairs, int top_k,
                int E, int cap, int* __restrict__ counts, int* __restrict__ offsets,
                int* __restrict__ dest, int* __restrict__ src, float* __restrict__ row_w) {
  __shared__ int warp_sum[32][MAX_GROUPS];
  __shared__ int s_off[MAX_GROUPS + 1], s_tot[MAX_GROUPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (pairs + PLAN_THREADS - 1) / PLAN_THREADS;
  const int p0 = min(pairs, tid * per), p1 = min(pairs, p0 + per);
  int cnt[MAX_GROUPS], excl[MAX_GROUPS];
#pragma unroll
  for (int e = 0; e < MAX_GROUPS; ++e) cnt[e] = 0;
  for (int q = p0; q < p1; ++q) {
    const int ex = idx[q];
#pragma unroll
    for (int e = 0; e < MAX_GROUPS; ++e) cnt[e] += ex == e;
  }
  // exclusive scan of the threads' counts, per expert: within each warp, then over the warps
#pragma unroll
  for (int e = 0; e < MAX_GROUPS; ++e) {
    int v = cnt[e];
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    excl[e] = v - cnt[e];
    if (lane == 31) warp_sum[warp][e] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int e = 0; e < MAX_GROUPS; ++e) {
      const int own = warp_sum[lane][e];
      int v = own;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      warp_sum[lane][e] = v - own;
      if (lane == 31) s_tot[e] = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_off[0] = 0;
    for (int e = 0; e < E; ++e) {
      s_off[e + 1] = s_off[e] + (s_tot[e] + ROW_TILE - 1) / ROW_TILE * ROW_TILE;
      counts[e] = s_tot[e];
      offsets[e] = s_off[e];
    }
    offsets[E] = s_off[E];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < MAX_GROUPS; ++e) excl[e] += warp_sum[warp][e];
  for (int q = p0; q < p1; ++q) {
    const int ex = idx[q];
    int d = 0;
#pragma unroll
    for (int e = 0; e < MAX_GROUPS; ++e)
      if (ex == e) d = s_off[e] + excl[e]++;
    dest[q] = d;
    src[d] = q / top_k;
    row_w[d] = wts[q];
  }
  for (int r = tid; r < cap; r += PLAN_THREADS) {
    int e = 0;
    while (e < E && r >= s_off[e + 1]) ++e;
    if (e == E || r >= s_off[e] + s_tot[e]) {
      src[r] = -1;
      row_w[r] = 0.f;
    }
  }
}

// ---- W8A8 codes of (gathered) rows ------------------------------------------------------------

constexpr int Q_WARPS = 4;
constexpr int Q_MAX_NC = 10;  // 16-byte chunks a lane: a group of at most 2560

__global__ void __launch_bounds__(Q_WARPS * 32)
moe_quant_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ src,
                 const int* __restrict__ limit, int R, int K, int group,
                 int8_t* __restrict__ codes, float* __restrict__ scales) {
  const int lane = threadIdx.x % 32;
  const int n_groups = K / group;
  const long long item = static_cast<long long>(blockIdx.x) * Q_WARPS + threadIdx.x / 32;
  if (item >= static_cast<long long>(R) * n_groups) return;
  const int r = static_cast<int>(item / n_groups), gi = static_cast<int>(item % n_groups);
  if (limit != nullptr && r >= *limit) return;
  const int s = src != nullptr ? src[r] : r;
  const int nc = group / 8;
  int8_t* dst = codes + static_cast<long long>(r) * K + static_cast<long long>(gi) * group;
  if (s < 0) {
    for (int c = lane; c < nc; c += 32) *reinterpret_cast<uint2*>(dst + 8 * c) = make_uint2(0, 0);
    if (lane == 0) scales[static_cast<long long>(r) * n_groups + gi] = 1.f;
    return;
  }
  const __nv_bfloat16* row = x + static_cast<long long>(s) * K + static_cast<long long>(gi) * group;
  uint4 raw[Q_MAX_NC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < Q_MAX_NC; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      raw[i] = *reinterpret_cast<const uint4*>(row + 8 * c);
      float f[8];
      unpack8(raw[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(f[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = quant8::scale_of(amax), rcp = __frcp_rn(scale);
#pragma unroll
  for (int i = 0; i < Q_MAX_NC; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      float f[8];
      unpack8(raw[i], f);
      *reinterpret_cast<uint2*>(dst + 8 * c) = quant8::codes8(f, scale, rcp);
    }
  }
  if (lane == 0) scales[static_cast<long long>(r) * n_groups + gi] = scale;
}

// ---- the grouped W8A8 GEMM on wgmma ---------------------------------------------------------

namespace gg {

using w8a8_pipe::BK;
using w8a8_pipe::BM;
using w8a8_pipe::BN;
using w8a8_pipe::THREADS;

enum Epilogue { EPI_SWIGLU = 0, EPI_ROWS = 1 };

struct Args {
  const float* xs;     // [M, n_groups]
  const float* scale;  // [G, N]
  const float* row_w;  // [M] or null
  const int* offsets;  // [G + 1] or null (one group of M rows)
  const int* counts;   // [G]
  __nv_bfloat16* out;  // [M, N] (EPI_ROWS) or [M, N / 2] (EPI_SWIGLU)
  int M, K, N, G, group, n_groups;
  int Kp;  // = K: the pipeline's A row (whole stages)
};

__device__ __forceinline__ float silu(float z) { return __fdiv_rn(z, __fadd_rn(1.f, expf(-z))); }

// One consumer warpgroup's 64 x 128 fp32 tile (the wgmma C fragment: d[4 nt + e] at row
// warp * 16 + lane / 4 + 8 (e / 2), column 8 nt + 2 (lane % 4) + e % 2) of group g at (m0, n0).
template <int EPI>
__device__ __forceinline__ void epilogue_store(float (&facc)[64], const Args& p, int g, int m0,
                                               int n0, uint8_t* stage) {
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const int row0 = m0 + wgi * 64 + warp * 16 + gr, row1 = row0 + 8;
  const float* scale = p.scale + static_cast<long long>(g) * p.N;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      facc[4 * nt + 2 * h] = __fmul_rn(facc[4 * nt + 2 * h], s0);
      facc[4 * nt + 2 * h + 1] = __fmul_rn(facc[4 * nt + 2 * h + 1], s1);
    }
  }
  if (EPI == EPI_SWIGLU) {
    // h = silu(gate) * up: gate columns are the tile's n-tiles 0..7, their up columns 8..15
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gr + 8 * h;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float a = __fmul_rn(silu(facc[4 * nt + 2 * h]), facc[4 * (nt + 8) + 2 * h]);
        const float b =
            __fmul_rn(silu(facc[4 * nt + 2 * h + 1]), facc[4 * (nt + 8) + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(stage + r * 128 + ((nt ^ (r % 8)) * 16) + 4 * t) =
            pack_bf16(a, b);
      }
    }
    hopper::named_barrier_sync(1 + wgi, 128);
    const int n_out = p.N / 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 128 * i, r = idx / 8, c = idx % 8;
      const int row = m0 + wgi * 64 + r, col = n0 / 2 + 8 * c;
      if (row >= p.M) continue;
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(row) * n_out + col) =
          *reinterpret_cast<const uint4*>(stage + r * 128 + ((c ^ (r % 8)) * 16));
    }
  } else {
    if (p.row_w != nullptr) {
      const float w0 = row0 < p.M ? p.row_w[row0] : 0.f, w1 = row1 < p.M ? p.row_w[row1] : 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) facc[i] = __fmul_rn(facc[i], (i % 4) < 2 ? w0 : w1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gr + 8 * h;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        *reinterpret_cast<uint32_t*>(stage + r * 256 + ((nt ^ (r % 8)) * 16) + 4 * t) =
            pack_bf16(facc[4 * nt + 2 * h], facc[4 * nt + 2 * h + 1]);
    }
    hopper::named_barrier_sync(1 + wgi, 128);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + 128 * i, r = idx / 16, c = idx % 16;
      const int row = m0 + wgi * 64 + r, col = n0 + 8 * c;
      if (row >= p.M) continue;
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(row) * p.N + col) =
          *reinterpret_cast<const uint4*>(stage + r * 256 + ((c ^ (r % 8)) * 16));
    }
  }
  hopper::named_barrier_sync(1 + wgi, 128);  // the stage is free for the next tile
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_start[MAX_GROUPS + 1], s_end[MAX_GROUPS];
  if (threadIdx.x < p.G) {
    const int g = threadIdx.x;
    const int start = p.offsets != nullptr ? p.offsets[g] : 0;
    s_start[g] = start;
    s_end[g] = p.offsets != nullptr ? start + p.counts[g] : p.M;
    if (g == p.G - 1) s_start[p.G] = p.offsets != nullptr ? p.offsets[p.G] : p.M;
  }
  // (the pipeline's __syncthreads publishes the bounds)
  w8a8_pipe::run<true>(&map_a, &map_b, p, s_start, s_end, p.G, smem_raw,
                       [&](float (&facc)[64], int g, int m0, int n0, uint8_t* stage) {
                         epilogue_store<EPI>(facc, p, g, m0, n0, stage);
                       });
}

template <int EPI>
cudaError_t launch_one(const CUtensorMap& ma, const CUtensorMap& mb, const Args& p,
                       cudaStream_t st) {
  static const bool regs_ok =
      hopper::entry_regs_are(moe_gemm_kernel<EPI>, w8a8_pipe::ENTRY_REGS);
  const int tiles = ((p.M + BM - 1) / BM) * (p.N / BN);
  return w8a8_pipe::launch(moe_gemm_kernel<EPI>, regs_ok, ma, mb, p, tiles, st);
}

}  // namespace gg

// ---- combine ----------------------------------------------------------------------------------

constexpr int C_WARPS = 4;

__global__ void __launch_bounds__(C_WARPS * 32)
moe_combine_kernel(const __nv_bfloat16* __restrict__ resid, const float* __restrict__ gate,
                   const __nv_bfloat16* __restrict__ yr, const int* __restrict__ dest, int top_k,
                   const __nv_bfloat16* __restrict__ ys, __nv_bfloat16* __restrict__ out, int M,
                   int D, int rows_per_batch, int boundary) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * C_WARPS + threadIdx.x / 32;
  if (t >= M) return;
  const int b = t / rows_per_batch, seg = (t % rows_per_batch) >= boundary ? 1 : 0;
  const float* g = gate + static_cast<long long>(2 * b + seg) * D;
  const long long at = static_cast<long long>(t) * D;
  for (int c = lane; c < D / 8; c += 32) {
    float acc[8], f[8], r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int k = 0; k < top_k; ++k) {
      const long long row = dest[t * top_k + k];
      unpack8(*reinterpret_cast<const uint4*>(yr + row * D + 8 * c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = k == 0 ? f[i] : __fadd_rn(acc[i], f[i]);
    }
    unpack8(*reinterpret_cast<const uint4*>(ys + at + 8 * c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = top_k == 0 ? f[i] : __fadd_rn(acc[i], f[i]);
    unpack8(*reinterpret_cast<const uint4*>(resid + at + 8 * c), r);
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ow[i] = pack_bf16(__fadd_rn(r[2 * i], __fmul_rn(g[8 * c + 2 * i], acc[2 * i])),
                        __fadd_rn(r[2 * i + 1], __fmul_rn(g[8 * c + 2 * i + 1], acc[2 * i + 1])));
    *reinterpret_cast<uint4*>(out + at + 8 * c) = o;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x bf16 [M, D] (16-byte aligned, D a multiple of 8), wg fp32 [E, D] -> idx int32 [M, top_k],
// wts fp32 [M, top_k].
extern "C" int moe_route(const void* x, const float* wg, int M, int D, int E, int top_k, int* idx,
                         float* wts, void* stream) {
  if (E < 1 || E > MAX_GROUPS || top_k < 1 || top_k > E || D % 8 || !aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int blocks = (M + ROUTE_WARPS - 1) / ROUTE_WARPS;
  moe_route_kernel<<<blocks, ROUTE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), wg, M, D, E, top_k, idx, wts);
  return static_cast<int>(cudaGetLastError());
}

// idx / wts [pairs] (token-major) -> counts [E], offsets [E + 1], dest [pairs], src [cap],
// row_w [cap]; cap must hold pairs + 127 E rows.
extern "C" int moe_plan(const int* idx, const float* wts, int pairs, int top_k, int E, int cap,
                        int* counts, int* offsets, int* dest, int* src, float* row_w,
                        void* stream) {
  if (E < 1 || E > MAX_GROUPS || top_k < 1 || cap < pairs + (ROW_TILE - 1) * E)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_plan_kernel<<<1, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, wts, pairs, top_k, E, cap, counts, offsets, dest, src, row_w);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [*, K] (rows through src [R] where given) -> codes int8 [R, K], scales fp32
// [R, K / group]; rows r >= *limit are left alone where limit is given.
extern "C" int moe_quant(const void* x, const int* src, const int* limit, int R, int K, int group,
                         void* codes, float* scales, void* stream) {
  if (group < 8 || group % 8 || K % group || group > 8 * 32 * Q_MAX_NC || !aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(R) * (K / group);
  if (items == 0) return 0;
  const long long blocks = (items + Q_WARPS - 1) / Q_WARPS;
  moe_quant_kernel<<<static_cast<unsigned>(blocks), Q_WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), src, limit, R, K, group,
      static_cast<int8_t*>(codes), scales);
  return static_cast<int>(cudaGetLastError());
}

// The grouped GEMM: a int8 [M, K] codes, xs fp32 [M, K / group], w int8 K-major [G, N, K] (each
// [K, N] slice transposed in memory, 16-byte aligned), scale fp32
// [G, N], groups from offsets [G + 1] / counts [G] on the device (null: one group of M rows);
// epilogue 0 (swiglu: out bf16 [M, N / 2]) or 1 (rows: out bf16 [M, N], times row_w [M] where
// given).  K, N and the group whole 128 tiles, G at most 8.
extern "C" int moe_gemm(int epilogue, const void* a, const float* xs, const void* w,
                        const float* scale, const float* row_w, const int* offsets,
                        const int* counts, void* out, int M, int K, int N, int G, int group,
                        void* stream) {
  using namespace gg;
  if (K % BK || N % BN || group % BK || K % group || G < 1 || G > MAX_GROUPS ||
      (offsets == nullptr && G != 1) || (offsets != nullptr && counts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap ma, mb;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t box[2] = {128, 128};
  if (!hopper::make_tensor_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, a_dims, a_strides, box) ||
      !w8a8_pipe::weight_map(&mb, w, K, static_cast<uint64_t>(G) * N))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{xs, scale, row_w, offsets, counts, static_cast<__nv_bfloat16*>(out), M, K, N, G, group,
         K / group, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case EPI_SWIGLU: return static_cast<int>(launch_one<EPI_SWIGLU>(ma, mb, p, st));
    case EPI_ROWS: return static_cast<int>(launch_one<EPI_ROWS>(ma, mb, p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [M, D] = resid + gate[b, seg] * (yr[dest[t, 0]] + ... + ys[t]), gate fp32 [B, 2, D]
// (main, cond rows), a row's batch t / rows_per_batch and its segment cond where
// t % rows_per_batch >= boundary; dest null (top_k 0) sums ys alone.
extern "C" int moe_combine(const void* resid, const float* gate, const void* yr, const int* dest,
                           int top_k, const void* ys, void* out, int M, int D,
                           int rows_per_batch, int boundary, void* stream) {
  if (D % 8 || rows_per_batch < 1 || (top_k > 0 && (dest == nullptr || yr == nullptr)) ||
      !aligned16(resid) || !aligned16(ys) || !aligned16(out) || (yr && !aligned16(yr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int blocks = (M + C_WARPS - 1) / C_WARPS;
  moe_combine_kernel<<<blocks, C_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(resid), gate, static_cast<const __nv_bfloat16*>(yr), dest,
      top_k, static_cast<const __nv_bfloat16*>(ys), static_cast<__nv_bfloat16*>(out), M, D,
      rows_per_batch, boundary);
  return static_cast<int>(cudaGetLastError());
}
