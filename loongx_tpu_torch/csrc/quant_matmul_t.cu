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
// it.  The one exception is the final proj_out (N 64), which is bound by its bytes.
// Design, kept simple: 128x128 output tiles (dy rows x weight rows), 8 warps of 64x32,
// mma.sync m16n8k16 (bf16 in, fp32 accumulate).  The contraction runs over N in steps of
// 32, double-buffered in shared memory through registers: the dy tile is scaled and
// rounded to bf16 on its way in, the weight tile widened to bf16.  The stored [K, N]
// weight is already contiguous along the contraction, which is the layout the mma B
// operand ("col") wants, so unlike the forward no transpose is needed: each weight row
// of 32 bytes becomes one shared row of 32 bf16.  No wgmma/TMA pipeline yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
