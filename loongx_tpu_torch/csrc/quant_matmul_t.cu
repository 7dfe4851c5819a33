// Transposed int8-weight matmul dx = bf16(dy * scale) @ Wq[blk]^T for Hopper (sm_90a).
//
// Replaces loongx_tpu/ops/quant_matmul.py::_qmm_t_kernel (pallas_call :248) and
// ::_qmm_t_stacked_kernel (:771): the backward of the int8-weight linears (QLoRA: the
// frozen int8 base passes the gradient to its input).  Per contraction element, as the
// TPU kernels do (:202, :721): dy[m, n] * scale[n] in fp32, rounded to bf16; the int8
// weight widened exactly to bf16; bf16 products summed in fp32; one cast of the sum to
// bf16.  The caller passes the weight (and scale) pointer already offset to block `blk`
// of the [NB, K, N] stack, so no block is sliced into a copy; the flat [K, N] weight is a
// stack of one.
//
// What bounds it on this card: at the FLUX shapes (M 512-2560, N 64-15360, K 3072-15360)
// it does 2*M*N*K operations against K*N int8 weight bytes plus the bf16 dy and dx, about
// 1000 bf16 op/byte at M 2048, far above the ridge (~295): tensor-core operations bound
// it.  The one exception is the final proj_out (N 64), which is bound by the bytes of dx.
// Three kernels share the contract (the Python wrapper's qmm_t_route is the rule):
//   * qmm_t_wgmma_kernel (below, "The transposed GEMM on wgmma"): K and N whole 128 tiles;
//   * qmm_t_narrow_kernel (below, "The transposed GEMM with a contraction of at most 64"): N
//     16..64, K whole 128 tiles (the proj_out backward);
//   * qmm_t_kernel, kept simple: 128x128 output tiles (dy rows x weight rows), 8 warps of
//     64x32, mma.sync m16n8k16 (bf16 in, fp32 accumulate).  The contraction runs over N in
//     steps of 32, double-buffered in shared memory through registers: the dy tile is scaled
//     and rounded to bf16 on its way in, the weight tile widened to bf16.  The stored [K, N]
//     weight is already contiguous along the contraction, which is the layout the mma B
//     operand ("col") wants, so unlike the forward no transpose is needed: each weight row
//     of 32 bytes becomes one shared row of 32 bf16.  No FLUX shape runs it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;        // dy rows per block
constexpr int BK = 128;        // weight rows (dx columns) per block
constexpr int BN = 32;         // contraction elements per step
constexpr int NTHREADS = 256;
constexpr int RS = 80;         // shared row stride in bytes: 32 bf16 + 16 pad

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Stage {
  uint4 dy[2];       // two 8-wide bf16 chunks of dy
  float4 sc[2][2];   // their scales
  uint4 w;           // one 16-wide int8 chunk of the weight
};

// Global -> registers for contraction step `nt`.  A: 128 rows x 4 chunks of 8 bf16
// (two per thread); B: 128 weight rows x 2 chunks of 16 int8 (one per thread).
__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ dy,
                                           const int8_t* __restrict__ w,
                                           const float* __restrict__ scale, int M, int K,
                                           int N, int m0, int k0, int nt) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = threadIdx.x + j * NTHREADS;
    const int row = c >> 2, n = nt * BN + (c & 3) * 8, m = m0 + row;
    if (m < M && n < N) {
      st.dy[j] = *reinterpret_cast<const uint4*>(dy + (long long)m * N + n);
      const float4* s4 = reinterpret_cast<const float4*>(scale + n);
      st.sc[j][0] = __ldg(s4);
      st.sc[j][1] = __ldg(s4 + 1);
    } else {
      st.dy[j] = make_uint4(0, 0, 0, 0);
      st.sc[j][0] = st.sc[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int row = threadIdx.x >> 1, n = nt * BN + (threadIdx.x & 1) * 16, k = k0 + row;
  st.w = (k < K && n < N) ? *reinterpret_cast<const uint4*>(w + (long long)k * N + n)
                          : make_uint4(0, 0, 0, 0);
}

// Registers -> shared: dy * scale rounded to bf16 (separate fp32 multiply, no fma), the
// int8 weight widened to bf16.  Both land as [row][contraction] with the contraction
// contiguous, the layout of the mma A (row-major) and B (col-major) operands.
__device__ __forceinline__ void store_stage(uint8_t* sa, uint8_t* sb, const Stage& st) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = threadIdx.x + j * NTHREADS;
    const int row = c >> 2, ch = c & 3;
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&st.dy[j]);
    const float s[8] = {st.sc[j][0].x, st.sc[j][0].y, st.sc[j][0].z, st.sc[j][0].w,
                        st.sc[j][1].x, st.sc[j][1].y, st.sc[j][1].z, st.sc[j][1].w};
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(__bfloat162float(x[e]), s[e]);
    *reinterpret_cast<uint4*>(sa + row * RS + ch * 16) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                   pack_bf16(f[6], f[7]));
  }
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const uint32_t words[4] = {st.w.x, st.w.y, st.w.z, st.w.w};
  uint32_t packed[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = static_cast<float>(static_cast<int8_t>((words[q] >> (8 * b)) & 0xffu));
    packed[2 * q] = pack_bf16(f[0], f[1]);
    packed[2 * q + 1] = pack_bf16(f[2], f[3]);
  }
  uint4* dst = reinterpret_cast<uint4*>(sb + row * RS + half * 32);
  dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

__global__ void __launch_bounds__(NTHREADS)
qmm_t_kernel(const __nv_bfloat16* __restrict__ dy, const int8_t* __restrict__ w,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ dx, int M, int K,
             int N) {
  __shared__ __align__(16) uint8_t sa[2][BM * RS];
  __shared__ __align__(16) uint8_t sb[2][BK * RS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int k0 = blockIdx.x * BK, m0 = blockIdx.y * BM;
  const int steps = (N + BN - 1) / BN;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  Stage st;
  load_stage(st, dy, w, scale, M, K, N, m0, k0, 0);
  store_stage(sa[0], sb[0], st);
  __syncthreads();

  for (int it = 0; it < steps; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < steps;
    if (more) load_stage(st, dy, w, scale, M, K, N, m0, k0, it + 1);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two k-steps of 16 (32 bytes) per tile
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint8_t* base = sa[cur] + (wm * 64 + mt * 16 + g) * RS + ks * 32 + 4 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * RS);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * RS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* base = sb[cur] + (wn * 32 + nt * 8 + g) * RS + ks * 32 + 4 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    if (more) store_stage(sa[cur ^ 1], sb[cur ^ 1], st);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = k0 + wn * 32 + nt * 8 + 2 * t;
        if (col >= K) continue;
        *reinterpret_cast<uint32_t*>(dx + (long long)row * K + col) =
            pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------------------
// The transposed GEMM on wgmma.  dx^T = W . a^T with a = bf16(dy * scale): the stored weight
// rows are contiguous along the contraction, so the weight is the register-sourced A operand
// of wgmma m64n128k16 bf16 (rs), read from its TMA-landed raw int8 tile and widened in
// registers (hopper::widen_pair, no conversion instruction), and `a` the K-major B operand in
// shared memory.  `a` comes from qmm_t_prescale_kernel, one pass over dy (2 M N bytes in and
// out): each dy * scale rounded to bf16 (__fmul_rn, then round to nearest even: the order of
// qmm_t_kernel and the TPU kernels), with the contraction permuted inside each 64-wide group
// so that a thread's A fragment of a whole stage is one 16-byte load of each of its two weight
// rows: the logical k = 2u + e of step s of a group is n = 16u + 4s + e and k = 8 + 2u + e is
// n = 16u + 4s + 2 + e (u < 4, e < 2), i.e. word s of the 16 bytes at 16u.  The fragment's rows
// are permuted too: slot g of warp w holds weight row 16w + 2 sigma(g) and slot g + 8 the row
// after it, so each dx element pair is one 32-bit store (sigma spreads a quarter-warp's loads
// over distinct banks).  One producer thread keeps a ring of STAGES in flight by TMA (a: 128 m
// rows x 128 n, two 64-wide panels; the raw weight: 128 rows x 128 n bytes); two consumer
// warpgroups own 64 weight rows each and widen each 64-n half-stage while the other half's
// products run.  dx^T tiles are staged in shared memory and written as whole rows of dx.
// Persistent blocks walk the tiles with M fastest.
// What bounds it: each 128-deep stage is 1024 cycles of bf16 tensor work an SM against 128 KB
// through shared memory (TMA 48, the weight fragments 16, the wgmma reads of a 64): near the
// SM's 128 bytes a cycle, so tensor cores and shared memory bind together; the pre-pass moves
// 4 M N bytes of device memory.
namespace wg {

constexpr int BM = 128;                 // dy rows (the wgmma's N) per tile
constexpr int BK = 128;                 // weight rows (dx columns) per tile: 2 x 64
constexpr int BN = 128;                 // contraction elements per stage
constexpr int STAGES = 3;
constexpr int PANEL = BM * 128;         // 128 rows of a x 64 bf16: one TMA box
constexpr int A_TILE = 2 * PANEL;
constexpr int W_TILE = BK * BN;         // raw int8 weight: 128 rows x 128 bytes
constexpr int OUT_TILE = BM * 64 * 2;   // one warpgroup's dx tile: 128 m x 64 k bf16
// warpgroups: two consumers and the producer (one thread starts the TMA loads); entry registers
// 65536 / 384 = 168, then 240 for the consumers and 24 for the producer (2 x 72 = 144)
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128, ENTRY_REGS = 168;
constexpr int SMEM_BYTES = STAGES * (A_TILE + W_TILE) + 2 * OUT_TILE + 2 * STAGES * 8 + 1024;

// a[m, 64G + 16s + 8h + 2u + e] = bf16(dy[m, n] * scale[n]), n = 64G + 16u + 4s + 2h + e: one
// thread per 16-byte chunk (s, h) of a 64-wide group, gathering four bf16 pairs (u = 0..3).
__global__ void __launch_bounds__(256)
qmm_t_prescale_kernel(const __nv_bfloat16* __restrict__ dy, const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ a, int M, int N) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = N / 8;
  if (idx >= (long long)M * chunks) return;
  const long long m = idx / chunks;
  const int c = static_cast<int>(idx % chunks);
  const int g64 = (c / 8) * 64, s = (c % 8) / 2, h = c % 2;
  const __nv_bfloat16* row = dy + m * N;
  uint32_t out[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = g64 + 16 * u + 4 * s + 2 * h;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + n);
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + n));
    out[u] = pack_bf16(__fmul_rn(__low2float(v), sc.x), __fmul_rn(__high2float(v), sc.y));
  }
  *reinterpret_cast<uint4*>(a + m * N + g64 + 16 * s + 8 * h) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

// The A fragments of one 64-wide group of a stage, four k-steps of 16: rows r0 and r0 + 1 of
// the raw weight tile (row r at r * 128, chunk c at c ^ (r % 8)), 16 bytes each at 64 grp + 16 t.
// widen = 0 passes the raw words on unwidened (a timing probe).
__device__ __forceinline__ void load_fragments(uint32_t (&f)[4][4], const uint8_t* wt, int r0,
                                               int grp, int t, int widen) {
  const int c = 4 * grp + t;
  const uint4 v0 = *reinterpret_cast<const uint4*>(wt + r0 * 128 + ((c ^ (r0 % 8)) * 16));
  const uint4 v1 =
      *reinterpret_cast<const uint4*>(wt + (r0 + 1) * 128 + ((c ^ ((r0 + 1) % 8)) * 16));
  const uint32_t w0[4] = {v0.x ^ 0x80808080u, v0.y ^ 0x80808080u, v0.z ^ 0x80808080u,
                          v0.w ^ 0x80808080u};
  const uint32_t w1[4] = {v1.x ^ 0x80808080u, v1.y ^ 0x80808080u, v1.z ^ 0x80808080u,
                          v1.w ^ 0x80808080u};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (!widen) {
      f[s][0] = f[s][2] = w0[s];
      f[s][1] = f[s][3] = w1[s];
      continue;
    }
    f[s][0] = hopper::widen_pair(w0[s], 0x7540, 0x7541);
    f[s][1] = hopper::widen_pair(w1[s], 0x7540, 0x7541);
    f[s][2] = hopper::widen_pair(w0[s], 0x7542, 0x7543);
    f[s][3] = hopper::widen_pair(w1[s], 0x7542, 0x7543);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
qmm_t_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, __nv_bfloat16* __restrict__ dx,
                   int M, int K, int N, int widen) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = base;
  uint8_t* sw = base + STAGES * A_TILE;
  uint8_t* sout = base + STAGES * (A_TILE + W_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sout + 2 * OUT_TILE);
  uint64_t* empty = full + STAGES;

  const int mtiles = (M + BM - 1) / BM;
  const int tiles = mtiles * (K / BK);
  const int nk = N / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mtiles) * BM, k0 = (tile / mtiles) * BK;
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], A_TILE + W_TILE);
          hopper::tma_load_2d(sa + s * A_TILE, &map_a, &full[s], j * BN, m0);
          hopper::tma_load_2d(sa + s * A_TILE + PANEL, &map_a, &full[s], j * BN + 64, m0);
          hopper::tma_load_2d(sw + s * W_TILE, &map_w, &full[s], j * BN, k0);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const int sigma = ((g & 1) << 1) | ((g >> 1) & 1) | (g & 4);
  const int r0 = wgi * 64 + warp * 16 + 2 * sigma;  // the tile's weight row of slot g
  uint8_t* stage = sout + wgi * OUT_TILE;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % mtiles) * BM, k0 = (tile / mtiles) * BK;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t fa[4][4], fb[4][4];
    int pending = -1;  // the stage whose second half's products may still read it
    for (int j = 0; j < nk; ++j, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* at = sa + s * A_TILE;
      const uint8_t* wt = sw + s * W_TILE;
      load_fragments(fa, wt, r0, 0, t, widen);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128k16_bf16_rs(acc, fa[kk],
                                         hopper::desc_sw128(at + kk * 32, 16, 1024),
                                         j > 0 || kk > 0);
      hopper::wgmma_commit();
      // the previous stage's second half is done: fb is free and that stage too
      hopper::wgmma_wait<1>();
      hopper::fence_operands(fb);
      if (pending >= 0 && lane == 0) hopper::mbar_arrive(&empty[pending]);
      load_fragments(fb, wt, r0, 1, t, widen);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128k16_bf16_rs(acc, fb[kk],
                                         hopper::desc_sw128(at + PANEL + kk * 32, 16, 1024), 1);
      hopper::wgmma_commit();
      // this stage's first half is done: fa is free
      hopper::wgmma_wait<1>();
      hopper::fence_operands(fa);
      pending = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(fb);
    hopper::fence_operands(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[pending]);

    // acc[4i + e] is dx[m0 + 8i + 2t + e][k0 + r0], acc[4i + 2 + e] the next column: one word.
    // Stage the warpgroup's 128 x 64 tile (16-byte chunk c of row r at c ^ (r % 8): conflict-
    // free both ways), then write whole 128-byte row pieces.
    const int cbyte = 2 * (warp * 16 + 2 * sigma);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * i + 2 * t + e;
        *reinterpret_cast<uint32_t*>(stage + r * 128 + (((cbyte / 16) ^ (r % 8)) * 16) +
                                     cbyte % 16) = pack_bf16(acc[4 * i + e], acc[4 * i + 2 + e]);
      }
    hopper::named_barrier_sync(1 + wgi, 128);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + 128 * i, r = idx / 8, c = idx % 8, row = m0 + r;
      if (row >= M) continue;
      *reinterpret_cast<uint4*>(dx + (long long)row * K + k0 + wgi * 64 + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * 128 + ((c ^ (r % 8)) * 16));
    }
    hopper::named_barrier_sync(1 + wgi, 128);  // the stage is free for the next tile
  }
}

int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

}  // namespace wg

// ---------------------------------------------------------------------------------------
// The transposed GEMM with a contraction of at most 64 (N <= 64: the final proj_out's backward,
// dy [1024, 64] -> dx [1024, 3072]).  What bounds it: the 2 M K bytes of dx (0.0019 ms at M 1024
// K 3072 at 3.35 TB/s); the product is 64 deep, 1/16 of a tile's store.  So each block is small
// and self-contained, and enough of them are resident at once to overlap one's loads with
// another's product and stores: a block of one warpgroup takes 64 dy rows x 128 weight rows
// (64 x 128 of dx), M 1024 K 3072 runs 16 x 24 = 384 blocks of 25 KB of shared memory, all
// resident at once, with no pre-scale pass and no persistent tail.  The block loads dy's rows
// (16-byte loads) and the scale and writes a = bf16(dy * scale) (__fmul_rn, then round to
// nearest even: qmm_t_kernel's and the TPU kernels' order) as the K-major A tile of wgmma
// m64n128k16 bf16 ss;
// it loads the int8 weight rows, which are K-major as stored ([K, N], the contraction
// contiguous), and widens them exactly (hopper::widen_pair) into the K-major B tile; both tiles
// 128-byte swizzled, the contraction past N zero.  Four wgmma steps; the fp32 tile is rounded
// once to bf16, staged in shared memory over both tiles and written as 256-byte rows of dx.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.0042-0.0045 ms at proj_out, against 0.0080
// on qmm_t_kernel and 0.0067 on qmm_t_wgmma_kernel with a half stage and its pre-scale pass
// (0.0013 of it); blocks of two warpgroups sharing one weight tile measured 0.0047.
namespace nw {

constexpr int BM = 64;       // dy rows (dx rows) a block
constexpr int BK = 128;      // weight rows (dx columns) a block
constexpr int THREADS = 128;
constexpr int A_TILE = BM * 128, B_TILE = BK * 128;
constexpr int SMEM_BYTES = A_TILE + B_TILE + 1024;

__global__ void __launch_bounds__(THREADS)
qmm_t_narrow_kernel(const __nv_bfloat16* __restrict__ dy, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ dx, int M, int K,
                    int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + A_TILE;
  uint8_t* stage = sa;  // the dx tile, [64 m][128 k] bf16, over both tiles after the products
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK, m0 = blockIdx.y * BM;

  // a: 64 rows x 8 chunks of 8 contraction elements, 4 a thread; the weight: 128 rows x 4 chunks
  // of 16 int8, 4 a thread.  Every load is issued before the first use.
  uint4 d[4], wv[4];
  float sv[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tid + j * THREADS, r = c / 8, n = 8 * (c % 8);
    const bool ok = m0 + r < M && n < N;
    d[j] = ok ? __ldg(reinterpret_cast<const uint4*>(dy + (long long)(m0 + r) * N + n))
              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < 8; ++e) sv[j][e] = ok ? __ldg(scale + n + e) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tid + j * THREADS, wr = c / 4, wn = 16 * (c % 4);
    wv[j] = wn < N ? __ldg(reinterpret_cast<const uint4*>(w + (long long)(k0 + wr) * N + wn))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tid + j * THREADS, r = c / 8, ch = c % 8;
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&d[j]);
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(__bfloat162float(x[e]), sv[j][e]);
    *reinterpret_cast<uint4*>(sa + r * 128 + ((ch ^ (r % 8)) * 16)) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                   pack_bf16(f[6], f[7]));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tid + j * THREADS, wr = c / 4, wc = 2 * (c % 4);  // two 16-byte bf16 chunks
    const uint32_t b[4] = {wv[j].x ^ 0x80808080u, wv[j].y ^ 0x80808080u, wv[j].z ^ 0x80808080u,
                           wv[j].w ^ 0x80808080u};
    *reinterpret_cast<uint4*>(sb + wr * 128 + ((wc ^ (wr % 8)) * 16)) =
        make_uint4(hopper::widen_pair(b[0], 0x7540, 0x7541), hopper::widen_pair(b[0], 0x7542, 0x7543),
                   hopper::widen_pair(b[1], 0x7540, 0x7541), hopper::widen_pair(b[1], 0x7542, 0x7543));
    *reinterpret_cast<uint4*>(sb + wr * 128 + (((wc + 1) ^ (wr % 8)) * 16)) =
        make_uint4(hopper::widen_pair(b[2], 0x7540, 0x7541), hopper::widen_pair(b[2], 0x7542, 0x7543),
                   hopper::widen_pair(b[3], 0x7540, 0x7541), hopper::widen_pair(b[3], 0x7542, 0x7543));
  }
  hopper::fence_proxy_async();
  __syncthreads();

  float acc[64];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_m64n128k16_bf16_ss(acc, hopper::desc_sw128(sa + kk * 32, 16, 1024),
                                     hopper::desc_sw128(sb + kk * 32, 16, 1024), kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
  __syncthreads();  // the products have read both tiles: the dx tile goes over them

  // acc[4i + e] is dx[m0 + 16 warp + g + 8 (e / 2)][k0 + 8i + 2t + e % 2]; 16-byte chunk c of
  // staged row r at c ^ (r % 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(stage + r * 256 + ((i ^ (r % 8)) * 16) + 4 * t) =
          pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int idx = tid + j * THREADS, r = idx / 16, c = idx % 16;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(dx + (long long)(m0 + r) * K + k0 + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * 256 + ((c ^ (r % 8)) * 16));
  }
}

}  // namespace nw

}  // namespace

// dy bf16 [M, N], w int8 [K, N] (block already offset), scale fp32 [N] -> dx bf16 [M, K].
// N must be a multiple of 16 and K even.  Returns cudaGetLastError().
extern "C" int qmm_t_gemm(const void* dy, const void* w, const float* scale, void* dx, int M,
                          int K, int N, void* stream) {
  if (N % 16 != 0 || K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + BK - 1) / BK, (M + BM - 1) / BM);
  qmm_t_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const int8_t*>(w), scale,
      static_cast<__nv_bfloat16*>(dx), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The transposed GEMM on wgmma: the arguments of qmm_t_gemm plus `a`, scratch bf16 [M, N] for
// the pre-scaled dy (16-byte aligned).  Takes K and N multiples of 128; anything else returns
// cudaErrorInvalidValue.  Launches qmm_t_prescale_kernel, then qmm_t_wgmma_kernel.  widen = 0
// leaves the weight fragments unwidened (wrong results): it measures what the widening costs.
extern "C" int qmm_t_gemm_wgmma(const void* dy, const void* w, const float* scale, void* a,
                                void* dx, int M, int K, int N, int widen, void* stream) {
  if (M < 1 || K % wg::BK || N % wg::BN || K < wg::BK || N < wg::BN)
    return static_cast<int>(cudaErrorInvalidValue);
  static const bool regs_ok = hopper::entry_regs_are(wg::qmm_t_wgmma_kernel, wg::ENTRY_REGS);
  if (!regs_ok || wg::num_sms() == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (long long)M * (N / 8);
  wg::qmm_t_prescale_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dy), scale, static_cast<__nv_bfloat16*>(a), M, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ma, mw;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t a_box[2] = {64, wg::BM};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(N)};
  const uint32_t w_box[2] = {wg::BN, wg::BK};
  if (!hopper::make_tensor_map(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, a_dims, a_strides,
                               a_box) ||
      !hopper::make_tensor_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims, w_strides,
                               w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(wg::qmm_t_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + wg::BM - 1) / wg::BM) * (K / wg::BK);
  const int blocks = tiles < wg::num_sms() ? tiles : wg::num_sms();
  wg::qmm_t_wgmma_kernel<<<blocks, wg::THREADS, wg::SMEM_BYTES, st>>>(
      ma, mw, static_cast<__nv_bfloat16*>(dx), M, K, N, widen);
  return static_cast<int>(cudaGetLastError());
}

// The pre-scale pass of qmm_t_gemm_wgmma alone (dy, scale, a as there; N a multiple of 64): a
// timing probe of its share of the transposed GEMM.
extern "C" int qmm_t_prescale(const void* dy, const float* scale, void* a, int M, int N,
                              void* stream) {
  if (M < 1 || N % 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (long long)M * (N / 8);
  wg::qmm_t_prescale_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy), scale, static_cast<__nv_bfloat16*>(a), M, N);
  return static_cast<int>(cudaGetLastError());
}

// The transposed GEMM with a contraction of at most 64 (qmm_t_narrow_kernel): the arguments of
// qmm_t_gemm (dy and w 16-byte aligned).  Takes N 16..64 a multiple of 16 and K a
// multiple of 128; anything else returns cudaErrorInvalidValue.
extern "C" int qmm_t_gemm_narrow(const void* dy, const void* w, const float* scale, void* dx, int M,
                                 int K, int N, void* stream) {
  if (M < 1 || N < 16 || N > 64 || N % 16 || K < nw::BK || K % nw::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(K / nw::BK, (M + nw::BM - 1) / nw::BM);
  nw::qmm_t_narrow_kernel<<<grid, nw::THREADS, nw::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const int8_t*>(w), scale,
      static_cast<__nv_bfloat16*>(dx), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
