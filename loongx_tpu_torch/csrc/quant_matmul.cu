// int8-weight matmul y = x @ Wq[blk] for Hopper (sm_90a): one source for three TPU kernels.
//
// Replaces loongx_tpu/ops/quant_matmul.py::_qmm_stacked_kernel (pallas_call :688),
// ::_qmm_qkv_stacked_kernel (:1255) and ::_qmm_kernel (:127; the flat [K, N] weight is a stack
// of one).  The caller passes the weight pointer already offset to block `blk` of the
// [NB, K, N] stack, so no block is ever sliced into a copy.
//
// Two MAC modes, as on the TPU (_accum_tile, quant_matmul.py:39):
//   * W8A8: the activations were quantized per (row, k-group) by qmm_act_quant
//     (x_scale = absmax/127, q = clip(rint(x / x_scale), -127, 127)); mma.sync m16n8k32
//     s8 x s8 -> s32 per group, then acc += float(i32) * x_scale in fp32 at each group end;
//   * weight-only: bf16 x, int8 weights widened exactly to bf16 (-128..127), bf16 products
//     with fp32 accumulation (mma.sync m16n8k16, or wgmma with the weight widened in registers).
// Epilogues (fp32, then one cast to bf16): z = acc * scale (+ bias); optionally gelu_tanh; or
// the fused-qkv form, per-head RMS (eps 1e-6) times the norm weights on the q and k planes,
// written into a [3, M, H] output.
//
// The fused-elementwise forms (the TPU kernels' _ln_mod_prologue :392 and _gate_res_epilogue
// :413).  Rows split into a main and a cond segment at `boundary` (row >= boundary is cond);
// every operation below is rounded on its own (__f*_rn), so no fma contraction changes a bit:
//   * LN + adaLN prologue, x' = ((x - mean) * rstd) * a_seg + b_seg in fp32 from the bf16 x, the
//     per-row (mean, rstd) precomputed (stats [M, 2]) and ab [8, K] (rows a_main, b_main,
//     a_cond, b_cond).  W8A8: the activation pass (LN = true) quantizes x' itself (no bf16 rounding
//     first).  Weight-only: on the wgmma route ln_mod_pass_kernel writes bf16(x') (the TPU
//     kernel's cast before its MXU) ahead of qmm_bf16_wgmma_kernel; on qmm_kernel the A tile goes
//     global -> registers during the k tile's MMAs, then through the prologue into shared memory;
//   * gate + residual epilogue, out = bf16(float(resid) + g_seg * z) on the fp32 z (after the
//     bias and any gelu), gate [8, N] (rows gate_main, gate_cond), resid bf16 [M, N].
// Their cost on this card: the prologue adds reads of the ab rows (L2-resident) and a few fp32
// operations per element of x, the epilogue one bf16 read of resid per output; both ride on
// passes that already read x or write out, so they move no extra bytes of device memory beyond
// resid, stats and ab (the weight-only pass moves x' once more).  The row stats are the JAX
// package's recipe (_ln_mean_rstd): mean = sum / K, then rstd = 1 / sqrt(mean((x - mean)^2) +
// 1e-6), from ln_stats_warp_kernel (the row read once, kept in registers) or ln_stats_kernel.
//
// What bounds it on this card: at the FLUX shapes (M 2048-2560, K 3072/12288, N 3072-18432)
// each call does 2*M*K*N operations against K*N weight bytes: ~2000 int8 op/byte, far above
// the ridge, so it is bound by tensor-core operations; the modulation matvecs (M = 2) are
// bound by the weight bytes.  Five kernels take the forward (the Python wrapper's qmm_route
// is the rule):
//   * qmm_wgmma_kernel (below, "The W8A8 GEMM on wgmma"): every W8A8 shape whose K, N, padded
//     K and activation group are whole 128-wide tiles, the FLUX stacked, fused-qkv and flat
//     layers from M 1 to 2560;
//   * qmm_bf16_wgmma_kernel (below, "The weight-only GEMM on bf16 wgmma"): every weight-only
//     shape whose K is whole 128-deep stages and N at least 128 (the prologue form after its
//     pass), the FLUX training layers and the T5-XXL linears from M 1 to 2560;
//   * qmm_splitk_kernel (below, "The flat GEMM at N below one 128 tile"): both MAC modes at N
//     16..112 with K whole slices of a cluster of 8 blocks (the final proj_out, N 64);
//   * qmm_k64_kernel (below, "The flat GEMM at K of one 64-wide panel"): both MAC modes at K
//     16..64 and N whole 128 tiles, W8A8 quantizing x in the kernel (x_embedder, K 64);
//   * qmm_kernel, kept simple: 128x128 output tiles, 8 warps of 64x32 on mma.sync, k tiles of
//     64 bytes double-buffered in shared memory (x by cp.async, the weight through registers
//     because mma needs it k-major: each thread transposes 4x4 int8 blocks with byte_perm);
//     the shapes no other kernel takes, and every shape under cuda_build.mma_sync_only().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "quant8.cuh"
#include "w8a8_pipeline.cuh"

namespace {

constexpr int BM = 128, BN = 128;
constexpr int NTHREADS = 256;
constexpr int TILE_BYTES = 64;  // k bytes per tile row: 64 int8 or 32 bf16
constexpr int RS = 80;          // shared row stride in bytes (64 + 16 pad)

enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_QKV = 2, EPI_GATE = 3, EPI_GELU_GATE = 4 };

struct QmmArgs {
  const uint8_t* a;     // W8A8: int8 [M, Kp]; weight-only: bf16 [M, K]
  const float* xs;      // W8A8: fp32 [M, n_groups]
  const uint8_t* w;     // int8 [K, N]; qmm_wgmma_kernel: K-major [N, K] (block already offset)
  const float* scale;   // fp32 [N]
  const float* bias;    // fp32 [N] or null
  const float* norm_w;  // fp32 [3, H] (EPI_QKV)
  const float* ab;      // fp32 [8, K] (weight-only prologue) or null
  const float* stats;   // fp32 [M, 2]: (mean, rstd) per row (prologue)
  const __nv_bfloat16* resid;  // bf16 [M, N] (EPI_GATE, EPI_GELU_GATE)
  const float* gate;    // fp32 [8, N] (EPI_GATE, EPI_GELU_GATE)
  __nv_bfloat16* out;   // [M, N] or [3, M, H]
  int M, K, Kp, N, group, n_groups, head_dim, plane_h, boundary;
  // the weight-only wgmma kernel: 0 skips widening the weight operand (a timing probe of its
  // share; wrong results)
  int prep_b;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// gelu_tanh in the operations and order of PyTorch's F.gelu(approximate="tanh") on CUDA (the
// plain version): x^3 = (x x) x, inner = k (x + 0.044715 x^3) with the sum an fma (as nvcc
// contracts it there), 0.5 x (1 + tanhf(inner)); each operation rounded as there, so the
// output equals the plain version's bit for bit.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fmaf_rn(0.044715f, x3, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

// The epilogue's value of one accumulator: z = acc * scale (+ bias), then gelu_tanh, each
// operation rounded on its own; every GEMM of this file ends in it.
template <bool GELU>
__device__ __forceinline__ float epi_value(float acc, float scale, bool has_bias, float bias) {
  float z = __fmul_rn(acc, scale);
  if (has_bias) z = __fadd_rn(z, bias);
  return GELU ? gelu_tanh(z) : z;
}

// The gate + residual store's value: float(resid) + g_seg * z on the fp32 z.
__device__ __forceinline__ float gate_res(float resid, float g, float z) {
  return __fadd_rn(resid, __fmul_rn(g, z));
}

// A head's 1 / rms from its sum of squares (eps 1e-6).
__device__ __forceinline__ float head_rstd(float sum_sq, int head_dim) {
  return 1.f / sqrtf(sum_sq / static_cast<float>(head_dim) + 1e-6f);
}

// x tile rows [m0, m0+128) x 64 k-bytes -> shared, zero past M (and past K, weight-only).
template <bool W8A8>
__device__ __forceinline__ void load_a(uint8_t* sa, const QmmArgs& p, int m0, int kt) {
  for (int c = threadIdx.x; c < BM * 4; c += NTHREADS) {
    const int row = c >> 2, ch = c & 3, gm = m0 + row;
    const uint8_t* src;
    bool ok;
    if (W8A8) {
      ok = gm < p.M;
      src = p.a + (long long)gm * p.Kp + kt * TILE_BYTES + ch * 16;
    } else {
      const int k = kt * 32 + ch * 8;
      ok = gm < p.M && k < p.K;
      src = p.a + ((long long)gm * p.K + k) * 2;
    }
    cp_async16(sa + row * RS + ch * 16, ok ? src : p.a, ok ? 16 : 0);
  }
  cp_async_commit();
}

// The prologue's value of one element: ((x - mean) * rstd) * a + b, each operation rounded.
__device__ __forceinline__ float ln_mod(float x, float mean, float rstd, float a, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), a), b);
}

// Weight-only prologue, first half: the raw bf16 x of the next tile (rows [m0, m0+128) x 32 k)
// -> registers, 16 bytes per (row, chunk) as load_a lays them out; zero past M and K.
__device__ __forceinline__ void load_a_raw(uint4 (&r)[2], const QmmArgs& p, int m0, int kt) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int gm = m0 + (c >> 2), k = kt * 32 + (c & 3) * 8;
    r[i] = (gm < p.M && k < p.K)
               ? *reinterpret_cast<const uint4*>(p.a + ((long long)gm * p.K + k) * 2)
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// x' = bf16(ln_mod(x)) of one 16-byte chunk of 8 bf16 values, `a` and `b` the segment's 8
// values of each at the chunk's k (fp32, 16-byte aligned).
__device__ __forceinline__ uint4 ln_mod8(const uint4& r, const float* a, const float* b,
                                         float mean, float rstd) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(b);
  const float4 b1 = *reinterpret_cast<const float4*>(b + 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&r);
  uint32_t packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 2 * j;
    packed[j] = pack_bf16(ln_mod(__bfloat162float(xv[e]), mean, rstd, av[e], bv[e]),
                          ln_mod(__bfloat162float(xv[e + 1]), mean, rstd, av[e + 1], bv[e + 1]));
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// Second half: x' = ln_mod(x) of the segment's (a, b) in fp32 -> bf16 -> shared.  `mean` and
// `rstd` are this thread's two rows' stats.
__device__ __forceinline__ void store_a_ln(uint8_t* sa, const uint4 (&r)[2], const QmmArgs& p,
                                           int m0, int kt, const float (&mean)[2],
                                           const float (&rstd)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int row = c >> 2, ch = c & 3, gm = m0 + row, k = kt * 32 + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gm < p.M && k < p.K) {
      const float* arow = p.ab + (gm >= p.boundary ? 2 : 0) * (long long)p.K + k;
      v = ln_mod8(r[i], arow, arow + p.K, mean[i], rstd[i]);
    }
    *reinterpret_cast<uint4*>(sa + row * RS + ch * 16) = v;
  }
}

// Weight tile (64 int8 k-rows W8A8, 32 weight-only) x 128 n -> registers, as 4x4 blocks:
// lane a = lane % 8 walks n, b = lane / 8 walks k, so each load instruction reads 4 rows of
// 32 contiguous bytes.
template <bool W8A8>
__device__ __forceinline__ void load_b(uint32_t (&r)[W8A8 ? 8 : 4], const QmmArgs& p, int n0,
                                       int kt) {
  constexpr int BLOCKS = W8A8 ? 2 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < BLOCKS; ++j) {
    const int wb = warp * BLOCKS + j;
    const int kb = lane / 8 + 4 * (wb / 4), nb = lane % 8 + 8 * (wb % 4);
    const int n = n0 + 4 * nb;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kt * (W8A8 ? 64 : 32) + 4 * kb + i;
      r[4 * j + i] = (k < p.K && n < p.N)
                         ? *reinterpret_cast<const uint32_t*>(p.w + (long long)k * p.N + n)
                         : 0u;
    }
  }
}

// Registers -> shared, transposed to [n][k] (k contiguous, as mma's B operand wants).
template <bool W8A8>
__device__ __forceinline__ void store_b(uint8_t* sb, const uint32_t (&r)[W8A8 ? 8 : 4]) {
  constexpr int BLOCKS = W8A8 ? 2 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < BLOCKS; ++j) {
    const int wb = warp * BLOCKS + j;
    const int kb = lane / 8 + 4 * (wb / 4), nb = lane % 8 + 8 * (wb % 4);
    const uint32_t w0 = r[4 * j], w1 = r[4 * j + 1], w2 = r[4 * j + 2], w3 = r[4 * j + 3];
    if (W8A8) {
      const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
      const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(sb + (4 * nb + i) * RS + 4 * kb) = col[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[q] = static_cast<float>(static_cast<int8_t>((r[4 * j + q] >> (8 * i)) & 0xffu));
        const uint2 v = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
        *reinterpret_cast<uint2*>(sb + (4 * nb + i) * RS + 8 * kb) = v;
      }
    }
  }
}

template <bool W8A8, int EPI, bool LN>
__global__ void __launch_bounds__(NTHREADS) qmm_kernel(const QmmArgs p) {
  static_assert(!(W8A8 && LN), "W8A8 takes the prologue in its activation pass");
  constexpr bool GELU = EPI == EPI_GELU || EPI == EPI_GELU_GATE;
  constexpr bool GATE = EPI == EPI_GATE || EPI == EPI_GELU_GATE;
  __shared__ __align__(16) uint8_t sa[2][BM * RS];
  __shared__ __align__(16) uint8_t sb[2][BN * RS];
  __shared__ float red[BM][4];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kloop = W8A8 ? p.Kp : p.K;
  const int nk = (kloop + (W8A8 ? 64 : 32) - 1) / (W8A8 ? 64 : 32);

  float facc[4][4][4];
  int iacc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        facc[mt][nt][e] = 0.f;
        iacc[mt][nt][e] = 0;
      }

  uint32_t breg[W8A8 ? 8 : 4];
  uint4 areg[2];
  float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
  if (LN) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + (threadIdx.x >> 2) + i * (NTHREADS >> 2);
      if (gm < p.M) {
        mean[i] = p.stats[2 * (long long)gm];
        rstd[i] = p.stats[2 * (long long)gm + 1];
      }
    }
    load_a_raw(areg, p, m0, 0);
    store_a_ln(sa[0], areg, p, m0, 0, mean, rstd);
  } else {
    load_a<W8A8>(sa[0], p, m0, 0);
  }
  load_b<W8A8>(breg, p, n0, 0);
  store_b<W8A8>(sb[0], breg);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      if (LN)
        load_a_raw(areg, p, m0, kt + 1);
      else
        load_a<W8A8>(sa[cur ^ 1], p, m0, kt + 1);
      load_b<W8A8>(breg, p, n0, kt + 1);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
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
        for (int nt = 0; nt < 4; ++nt) {
          if (W8A8)
            mma_s8(iacc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
          else
            mma_bf16(facc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
        }
    }
    if (W8A8 && ((kt + 1) * 64) % p.group == 0) {
      // end of an activation group: acc += float(i32) * x_scale(row, group)
      const int gi = (kt * 64) / p.group;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
          const float s = row < p.M ? p.xs[(long long)row * p.n_groups + gi] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              facc[mt][nt][e] =
                  __fadd_rn(facc[mt][nt][e], __fmul_rn(static_cast<float>(iacc[mt][nt][e]), s));
              iacc[mt][nt][e] = 0;
            }
        }
    }
    if (more) {
      store_b<W8A8>(sb[cur ^ 1], breg);
      if (LN) store_a_ln(sa[cur ^ 1], areg, p, m0, kt + 1, mean, rstd);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: z = acc * scale (+ bias) in fp32
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * t;
    if (col >= p.N) continue;
    const float s0 = p.scale[col], s1 = p.scale[col + 1];
    const float b0 = p.bias ? p.bias[col] : 0.f, b1 = p.bias ? p.bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        facc[mt][nt][2 * h] = epi_value<GELU>(facc[mt][nt][2 * h], s0, p.bias, b0);
        facc[mt][nt][2 * h + 1] = epi_value<GELU>(facc[mt][nt][2 * h + 1], s1, p.bias, b1);
      }
  }

  if (EPI != EPI_QKV) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (row >= p.M) continue;
        const float* grow = GATE ? p.gate + (row >= p.boundary ? p.N : 0) : nullptr;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          if (col >= p.N) continue;
          float z0 = facc[mt][nt][2 * h], z1 = facc[mt][nt][2 * h + 1];
          if (GATE) {
            // out = resid + g_seg * z on the fp32 z
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(p.resid + (long long)row * p.N + col);
            z0 = gate_res(__low2float(r), grow[col], z0);
            z1 = gate_res(__high2float(r), grow[col + 1], z1);
          }
          *reinterpret_cast<uint32_t*>(p.out + (long long)row * p.N + col) = pack_bf16(z0, z1);
        }
      }
    return;
  }

  // fused qkv: per-row sum of squares over this warp's 32 columns, then over the head
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ss += facc[mt][nt][2 * h] * facc[mt][nt][2 * h] +
              facc[mt][nt][2 * h + 1] * facc[mt][nt][2 * h + 1];
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (t == 0) red[wm * 64 + mt * 16 + g + 8 * h][wn] = ss;
    }
  __syncthreads();
  const int warps_per_head = p.head_dim / 32;
  const int w_first = (wn / warps_per_head) * warps_per_head;
  const int plane = n0 / p.plane_h;  // H is a multiple of BN: one plane per block
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r_local = wm * 64 + mt * 16 + g + 8 * h, row = m0 + r_local;
      if (row >= p.M) continue;
      float tot = 0.f;
      for (int w = w_first; w < w_first + warps_per_head; ++w) tot += red[r_local][w];
      const float rstd = head_rstd(tot, p.head_dim);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        const int hc = col - plane * p.plane_h;
        float z0 = facc[mt][nt][2 * h], z1 = facc[mt][nt][2 * h + 1];
        if (plane < 2) {
          z0 = __fmul_rn(__fmul_rn(z0, rstd), p.norm_w[plane * p.plane_h + hc]);
          z1 = __fmul_rn(__fmul_rn(z1, rstd), p.norm_w[plane * p.plane_h + hc + 1]);
        }
        *reinterpret_cast<uint32_t*>(p.out + ((long long)plane * p.M + row) * p.plane_h + hc) =
            pack_bf16(z0, z1);
      }
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < blockDim.x / 32; ++w) tot += red[w];
  return tot;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One block per row of x [M, K] (bf16 or fp32) -> stats [M, 2] = (mean, rstd): the "block"
// route of the row stats (fp32 x, a K the warp kernels below cannot hold).
template <typename T>
__global__ void __launch_bounds__(256)
ln_stats_kernel(const T* __restrict__ x, int K, float* __restrict__ stats) {
  __shared__ float red[8];
  const long long m = blockIdx.x;
  const T* row = x + m * K;
  float s = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s += to_float(row[k]);
  const float mean = block_sum(s, red) / static_cast<float>(K);
  float s2 = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float d = __fsub_rn(to_float(row[k]), mean);
    s2 = __fadd_rn(s2, __fmul_rn(d, d));
  }
  const float var = block_sum(s2, red) / static_cast<float>(K);
  if (threadIdx.x == 0) {
    stats[2 * m] = mean;
    stats[2 * m + 1] = 1.f / sqrtf(var + 1e-6f);
  }
}

// The row stats and the weight-only LN + adaLN prologue pass, one warp a row: the "warp" route
// (bf16 x, K a multiple of 8 and at most LN_ROW_MAX: every FLUX fused site).  Lane l loads the
// row's 16-byte chunks l, l + 32, ... (8 bf16 each, at most NC a lane) before the first use and
// keeps them in registers as bf16 (K 3072: 12 chunks, 48 registers); the JAX recipe's two
// passes, mean = sum / K and then var = mean((x - mean)^2), run over the registers (8 partial
// sums a lane, one per place in a chunk, then a shuffle sum), never over memory again; lane 0
// stores (mean, rstd) as one 8-byte word.  What bounds it: bytes, 2 read per element (M 2560
// K 3072: 0.0047 ms at 3.35 TB/s).  ln_stats_warp_kernel stops there (it replaces the block
// kernel above wherever it can take the row); ln_mod_pass_kernel, the weight-only prologue
// ahead of qmm_bf16_wgmma_kernel, goes on to write x' = bf16(ln_mod(x)) from the same registers,
// each operation rounded as store_a_ln rounds it, and 2 more bytes an element (0.0094 ms).  A
// pass instead of a prologue in the GEMM's producer: a warpgroup rewriting a B tile in shared
// memory would need more shared-memory bandwidth than the SM has (the weight-only GEMM's own
// widening measured so), and the pass's extra read and write of x is under 3 % of that GEMM.
constexpr int LN_WARPS = 4;
constexpr int LN_ROW_MAX = 3072;

template <bool MOD, int NC>
__device__ __forceinline__ void ln_row_warp(const __nv_bfloat16* __restrict__ x, int M, int K,
                                            float* __restrict__ stats,
                                            const float* __restrict__ ab, int boundary,
                                            __nv_bfloat16* __restrict__ out) {
  const int m = blockIdx.x * LN_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= M) return;  // whole warps
  const int nchunks = K / 8;
  const __nv_bfloat16* row = x + (long long)m * K;
  uint4 raw[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    raw[j] = c < nchunks ? __ldg(reinterpret_cast<const uint4*>(row + 8 * c))
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  float part[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {  // the zeros past K add nothing
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) part[e] += __bfloat162float(xv[e]);
  }
  const float mean =
      warp_sum(((part[0] + part[1]) + (part[2] + part[3])) +
               ((part[4] + part[5]) + (part[6] + part[7]))) / static_cast<float>(K);
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (lane + 32 * j >= nchunks) continue;
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __bfloat162float(xv[e]) - mean;
      part[e] = fmaf(d, d, part[e]);
    }
  }
  const float var =
      warp_sum(((part[0] + part[1]) + (part[2] + part[3])) +
               ((part[4] + part[5]) + (part[6] + part[7]))) / static_cast<float>(K);
  const float rstd = 1.f / sqrtf(var + 1e-6f);
  if (lane == 0) *reinterpret_cast<float2*>(stats + 2 * (long long)m) = make_float2(mean, rstd);
  if constexpr (MOD) {
    const float* arow = ab + (m >= boundary ? 2 : 0) * (long long)K;
    __nv_bfloat16* orow = out + (long long)m * K;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < nchunks)
        *reinterpret_cast<uint4*>(orow + 8 * c) =
            ln_mod8(raw[j], arow + 8 * c, arow + K + 8 * c, mean, rstd);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_stats_warp_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                     float* __restrict__ stats) {
  ln_row_warp<false, NC>(x, M, K, stats, nullptr, 0, nullptr);
}

template <int NC>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_mod_pass_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, float* __restrict__ stats,
                   const float* __restrict__ ab, int boundary, __nv_bfloat16* __restrict__ out) {
  ln_row_warp<true, NC>(x, M, K, stats, ab, boundary, out);
}

// The prologue pass with the stats given (ln_stats_kernel's: fp32 x, or a row longer than
// LN_ROW_MAX): one warp a row streams its 16-byte chunks through ln_mod.
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_mod_apply_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                    const float* __restrict__ stats, const float* __restrict__ ab, int boundary,
                    __nv_bfloat16* __restrict__ out) {
  const int m = blockIdx.x * LN_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= M) return;
  const float mean = stats[2 * (long long)m], rstd = stats[2 * (long long)m + 1];
  const float* arow = ab + (m >= boundary ? 2 : 0) * (long long)K;
  const __nv_bfloat16* row = x + (long long)m * K;
  __nv_bfloat16* orow = out + (long long)m * K;
  for (int c = lane; c < K / 8; c += 32)
    *reinterpret_cast<uint4*>(orow + 8 * c) =
        ln_mod8(__ldg(reinterpret_cast<const uint4*>(row + 8 * c)), arow + 8 * c,
                arow + K + 8 * c, mean, rstd);
}

template <bool MOD, int NC>
void launch_ln_rows_nc(const __nv_bfloat16* x, int M, int K, float* stats, const float* ab,
                       int boundary, __nv_bfloat16* out, cudaStream_t st) {
  const dim3 grid((M + LN_WARPS - 1) / LN_WARPS);
  if constexpr (MOD)
    ln_mod_pass_kernel<NC><<<grid, LN_WARPS * 32, 0, st>>>(x, M, K, stats, ab, boundary, out);
  else
    ln_stats_warp_kernel<NC><<<grid, LN_WARPS * 32, 0, st>>>(x, M, K, stats);
}

template <bool MOD>
cudaError_t launch_ln_rows(const __nv_bfloat16* x, int M, int K, float* stats, const float* ab,
                           int boundary, __nv_bfloat16* out, cudaStream_t st) {
  if (K % 8 || K > LN_ROW_MAX) return cudaErrorInvalidValue;
  const int chunks_per_lane = (K / 8 + 31) / 32;
  if (chunks_per_lane <= 1)
    launch_ln_rows_nc<MOD, 1>(x, M, K, stats, ab, boundary, out, st);
  else if (chunks_per_lane <= 2)
    launch_ln_rows_nc<MOD, 2>(x, M, K, stats, ab, boundary, out, st);
  else if (chunks_per_lane <= 4)
    launch_ln_rows_nc<MOD, 4>(x, M, K, stats, ab, boundary, out, st);
  else if (chunks_per_lane <= 6)
    launch_ln_rows_nc<MOD, 6>(x, M, K, stats, ab, boundary, out, st);
  else
    launch_ln_rows_nc<MOD, 12>(x, M, K, stats, ab, boundary, out, st);
  return cudaGetLastError();
}

// The W8A8 activation pass (the TPU kernels' _accum_tile :39, its W8A8 half), per (row, group):
// x_scale = absmax/127 (1 when absmax == 0) and q = clip(rint(v / x_scale), -127, 127) (IEEE
// division, ties to even); zero past K up to n_groups * group.  v is the bf16 x, or with LN the
// fp32 prologue value ln_mod(x) of the row's segment (never rounded to bf16).  What bounds it:
// bytes (2 read and 1 written per element; at M 2560 K 3072, 0.0070 ms at 3.35 TB/s).
//
// act_quant_block_kernel, one block of 256 threads per (group, row), takes every shape (the
// "block" route): a __syncthreads reduction, then a second read (and ln_mod) of every element.

template <bool LN>
__global__ void __launch_bounds__(256)
act_quant_block_kernel(const __nv_bfloat16* __restrict__ x, int K, int group, int n_groups,
                 int8_t* __restrict__ xq, float* __restrict__ xs, const float* __restrict__ stats,
                 const float* __restrict__ ab, int boundary) {
  __shared__ float wmax[8];
  const int m = blockIdx.y, gi = blockIdx.x, k0 = gi * group;
  const __nv_bfloat16* row = x + (long long)m * K;
  float mean = 0.f, rstd = 0.f;
  const float* arow = nullptr;
  if (LN) {
    mean = stats[2 * (long long)m];
    rstd = stats[2 * (long long)m + 1];
    arow = ab + (m >= boundary ? 2 : 0) * (long long)K;
  }
  auto value = [&](int k) {
    const float v = __bfloat162float(row[k]);
    return LN ? ln_mod(v, mean, rstd, arow[k], arow[K + k]) : v;
  };
  float amax = 0.f;
  for (int j = threadIdx.x; j < group; j += blockDim.x) {
    const int k = k0 + j;
    if (k < K) amax = fmaxf(amax, fabsf(value(k)));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = wmax[0];
  for (int w = 1; w < blockDim.x / 32; ++w) amax = fmaxf(amax, wmax[w]);
  const float scale = amax == 0.f ? 1.f : amax / 127.f;
  int8_t* qrow = xq + (long long)m * n_groups * group + k0;
  for (int j = threadIdx.x; j < group; j += blockDim.x) {
    const int k = k0 + j;
    const float v = k < K ? value(k) : 0.f;
    const float q = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
    qrow[j] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) xs[(long long)m * n_groups + gi] = scale;
}

// act_quant_warp_kernel, the "warp" route (K and group multiples of 8, group <= 3072: every
// FLUX shape): one warp per (row, group), ACTQ_WARPS of them a block.  Lane l loads the group's
// 16-byte chunks l, l + 32, ... (8 bf16 each, at most NC), all before the first use, and keeps
// them in registers (with LN their fp32 ln_mod values, computed once); the absmax is a shuffle
// reduction (no shared memory, no barrier); the codes come from the registers, 8 a lane stored
// as one 8-byte word, so a warp writes 256 contiguous bytes a step; lane 0 writes the scale.
// The codes are quant8::codes8's (csrc/quant8.cuh): IEEE division's, with no division an
// element.
// (The explicit minimum of one block a SM changes ptxas's register choice, 80 -> 84 at NC 12,
// and measured 0.046 -> 0.040 ms at M 2560 K 12288, the same at K 3072.)
constexpr int ACTQ_WARPS = 4;

template <bool LN, int NC>
__global__ void __launch_bounds__(ACTQ_WARPS * 32, 1)
act_quant_warp_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, int group, int n_groups,
                      int8_t* __restrict__ xq, float* __restrict__ xs,
                      const float* __restrict__ stats, const float* __restrict__ ab,
                      int boundary) {
  const int w = blockIdx.x * ACTQ_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= M * n_groups) return;  // whole warps
  const int m = w / n_groups, gi = w % n_groups, k0 = gi * group, nchunks = group / 8;
  const __nv_bfloat16* row = x + (long long)m * K;
  uint4 raw[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j, k = k0 + 8 * c;
    raw[j] = (c < nchunks && k < K) ? __ldg(reinterpret_cast<const uint4*>(row + k))
                                    : make_uint4(0u, 0u, 0u, 0u);
  }
  float v[LN ? 8 * NC : 1];
  float amax = 0.f;
  if constexpr (LN) {
    const float mean = stats[2 * (long long)m], rstd = stats[2 * (long long)m + 1];
    const float* arow = ab + (m >= boundary ? 2 : 0) * (long long)K;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j, k = k0 + 8 * c;
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
      if (c < nchunks && k < K) {
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(arow + k));
        const float4 a1 = __ldg(reinterpret_cast<const float4*>(arow + k + 4));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(arow + K + k));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(arow + K + k + 4));
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[8 * j + e] = ln_mod(__bfloat162float(xv[e]), mean, rstd, a[e], bb[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[8 * j + e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[8 * j + e]));
    }
  } else {
    // on bf16 pairs (exact): no fp32 copy of the group stays live up to the codes
    __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) m2 = __hmax2(m2, __habs2(xv[e]));
    }
    amax = fmaxf(__low2float(m2), __high2float(m2));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = quant8::scale_of(amax), r = __frcp_rn(scale);
  int8_t* qrow = xq + (long long)m * n_groups * group + k0;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c >= nchunks) continue;
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
    float val[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (LN)
        val[e] = v[8 * j + e];
      else
        val[e] = __bfloat162float(xv[e]);
    }
    *reinterpret_cast<uint2*>(qrow + 8 * c) = quant8::codes8(val, scale, r);
  }
  if (lane == 0) xs[(long long)m * n_groups + gi] = scale;
}

template <bool LN>
cudaError_t launch_act_quant_warp(const __nv_bfloat16* x, int M, int K, int group, int n_groups,
                                  int8_t* xq, float* xs, const float* stats, const float* ab,
                                  int boundary, cudaStream_t st) {
  const int chunks_per_lane = (group / 8 + 31) / 32;
  const dim3 grid((M * n_groups + ACTQ_WARPS - 1) / ACTQ_WARPS);
#define ACTQ_LAUNCH(NC)                                                                     \
  act_quant_warp_kernel<LN, NC><<<grid, ACTQ_WARPS * 32, 0, st>>>(x, M, K, group, n_groups, \
                                                                  xq, xs, stats, ab, boundary)
  if (chunks_per_lane <= 1)
    ACTQ_LAUNCH(1);
  else if (chunks_per_lane <= 2)
    ACTQ_LAUNCH(2);
  else if (chunks_per_lane <= 4)
    ACTQ_LAUNCH(4);
  else if (chunks_per_lane <= 6)
    ACTQ_LAUNCH(6);
  else if (chunks_per_lane <= 12)
    ACTQ_LAUNCH(12);
  else
    return cudaErrorInvalidValue;
#undef ACTQ_LAUNCH
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// The W8A8 GEMM on wgmma (kernels 2, 3 and 4 at every shape the tiling takes; the Python
// wrapper's `qmm_route` names the rule): the persistent pipeline of w8a8_pipeline.cuh (a TMA
// producer landing the activation codes and the K-major weight, [N, K], as wgmma reads them; two
// consumer warpgroups on wgmma m64n128k32 s8 x s8 -> s32 folding each activation group into fp32
// by the row's scale) over one group of every row.  Epilogues as qmm_kernel's on the wgmma
// fragment (mma.sync's C fragment repeated over the 16 n-tiles of 8 columns), gelu by the exact
// gelu_tanh (tanhf); the bf16 tile is staged in shared memory and written as whole rows.
// What bounds it: each 128-deep stage moves 80 KB through shared memory (TMA 32, wgmma 48)
// against 491 cycles of int8 tensor work at the data sheet's rate, about 625 cycles at 128 bytes
// a cycle, and 32 KB from L2 (112 KB before the weight was stored K-major, when a fourth
// warpgroup rewrote every [K, N] weight tile).  The stage probe (w8a8_pipeline.cuh) reads 457
// cycles a stage of barrier wait and wgmma at M 2560 K 3072 N 12288, and the gelu epilogue,
// run by the consumers while the producer loads the next tile's first stages, 13822 cycles a
// tile, more than the tile's 24 stages take.

namespace wg {

// the pipeline's tiles and warpgroups, transpose4x4 (the split-K and K 64 kernels below
// transpose their [K, N] weight panels with it) and the card's SM count
using w8a8_pipe::BK;
using w8a8_pipe::BM;
using w8a8_pipe::BN;
using w8a8_pipe::ENTRY_REGS;
using w8a8_pipe::num_sms;
using w8a8_pipe::OUT_TILE;
using w8a8_pipe::THREADS;
using w8a8_pipe::transpose4x4;

// The epilogue of one consumer warpgroup's 64 x 128 fp32 tile `facc` (the wgmma C fragment:
// mma.sync's C fragment repeated over the 16 n-tiles of 8 columns) at output tile (m0, n0),
// qmm_kernel's operations in its order: z = acc * scale (+ bias), gelu by the exact gelu_tanh
// (tanhf), then the gate + residual or the fused-qkv RMS; the bf16 tile is staged in shared
// memory (`stage`, OUT_TILE bytes) and written as whole rows.  Both wgmma GEMMs end in it.
template <int EPI>
__device__ __forceinline__ void epilogue_store(float (&facc)[64], const QmmArgs& p, int m0, int n0,
                                               uint8_t* stage) {
  constexpr bool GELU = EPI == EPI_GELU || EPI == EPI_GELU_GATE;
  constexpr bool GATE = EPI == EPI_GATE || EPI == EPI_GELU_GATE;
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const int row0 = m0 + wgi * 64 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    if (col >= p.N) continue;
    const float s0 = p.scale[col], s1 = p.scale[col + 1];
    const float b0 = p.bias ? p.bias[col] : 0.f, b1 = p.bias ? p.bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      facc[4 * nt + 2 * h] = epi_value<GELU>(facc[4 * nt + 2 * h], s0, p.bias, b0);
      facc[4 * nt + 2 * h + 1] = epi_value<GELU>(facc[4 * nt + 2 * h + 1], s1, p.bias, b1);
    }
  }
  int plane = 0;
  if (EPI != EPI_QKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row1 : row0;
      if (!GATE || row >= p.M) continue;
      const float* grow = p.gate + (row >= p.boundary ? p.N : 0);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
        if (col >= p.N) continue;
        // out = resid + g_seg * z on the fp32 z
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(p.resid + (long long)row * p.N + col);
        float& z0 = facc[4 * nt + 2 * h];
        float& z1 = facc[4 * nt + 2 * h + 1];
        z0 = gate_res(__low2float(r), grow[col], z0);
        z1 = gate_res(__high2float(r), grow[col + 1], z1);
      }
    }
  } else {
    // fused qkv: this warp holds whole rows of the tile, so each head's sum of squares is a
    // sum over its n-tiles and the quad (H is a multiple of BN: one plane per block)
    plane = n0 / p.plane_h;
    const int tiles_per_head = p.head_dim / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float rstd[4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float ss = 0.f;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const float a = facc[4 * nt + 2 * h], b = facc[4 * nt + 2 * h + 1];
          if (nt / tiles_per_head == hh) ss += a * a + b * b;
        }
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        rstd[hh] = head_rstd(ss, p.head_dim);
      }
      if (plane >= 2) continue;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int hh = nt / tiles_per_head;
        const float r = hh == 0 ? rstd[0] : hh == 1 ? rstd[1] : hh == 2 ? rstd[2] : rstd[3];
        const int hc = n0 + nt * 8 + 2 * t - plane * p.plane_h;
        facc[4 * nt + 2 * h] =
            __fmul_rn(__fmul_rn(facc[4 * nt + 2 * h], r), p.norm_w[plane * p.plane_h + hc]);
        facc[4 * nt + 2 * h + 1] = __fmul_rn(__fmul_rn(facc[4 * nt + 2 * h + 1], r),
                                             p.norm_w[plane * p.plane_h + hc + 1]);
      }
    }
  }
  // Stage the warpgroup's 64 x 128 bf16 results in shared memory (16-byte chunk c of row r
  // at c ^ (r % 8): conflict-free both ways), then write whole 256-byte rows.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
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
    if (row >= p.M || col >= p.N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * 256 + ((c ^ (r % 8)) * 16));
    __nv_bfloat16* dst = EPI == EPI_QKV
                             ? p.out + ((long long)plane * p.M + row) * p.plane_h +
                                   (col - plane * p.plane_h)
                             : p.out + (long long)row * p.N + col;
    *reinterpret_cast<uint4*>(dst) = v;
  }
  hopper::named_barrier_sync(1 + wgi, 128);  // the stage is free for the next tile
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const QmmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  w8a8_pipe::run<false>(&map_a, &map_b, p, nullptr, nullptr, 1, smem_raw,
                        [&](float (&facc)[64], int, int m0, int n0, uint8_t* stage) {
                          epilogue_store<EPI>(facc, p, m0, n0, stage);
                        });
}

template <int EPI>
cudaError_t launch_one(const CUtensorMap& ma, const CUtensorMap& mb, const QmmArgs& p,
                       cudaStream_t st) {
  static const bool regs_ok = hopper::entry_regs_are(qmm_wgmma_kernel<EPI>, ENTRY_REGS);
  const int tiles = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  return w8a8_pipe::launch(qmm_wgmma_kernel<EPI>, regs_ok, ma, mb, p, tiles, st);
}

cudaError_t launch(int epilogue, const QmmArgs& p, cudaStream_t st) {
  if (p.Kp % BK || p.group % BK || p.K < BK || p.N < BN || p.N % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(p.Kp), static_cast<uint64_t>(p.M)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(p.Kp)};
  const uint32_t box[2] = {128, 128};
  if (!hopper::make_tensor_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.a, a_dims, a_strides,
                               box) ||
      !w8a8_pipe::weight_map(&mb, p.w, p.K, p.N))
    return cudaErrorInvalidValue;
  switch (epilogue) {
    case EPI_BIAS: return launch_one<EPI_BIAS>(ma, mb, p, st);
    case EPI_GELU: return launch_one<EPI_GELU>(ma, mb, p, st);
    case EPI_QKV: return launch_one<EPI_QKV>(ma, mb, p, st);
    case EPI_GATE: return launch_one<EPI_GATE>(ma, mb, p, st);
    case EPI_GELU_GATE: return launch_one<EPI_GELU_GATE>(ma, mb, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------------------
// The weight-only GEMM on bf16 wgmma (kernels 2, 3 and 4 in weight-only mode at every shape the
// tiles take; `qmm_route` names the rule).  The TPU kernels' weight-only MAC (_accum_tile
// :53-57): x rounded to bf16, each int8 weight widened exactly to bf16, fp32 sums, then
// qmm_kernel's epilogues.  The mixed-input arrangement: y^T = W^T . x^T, so the int8 weight is
// the register-sourced A operand of wgmma m64n128k16 bf16 (rs) and is widened in registers, x
// the K-major B operand in shared memory as TMA lands it.  One producer thread keeps a ring of
// STAGES in flight by TMA: x (128 m rows x 128 k, two 64-wide k panels) and the raw weight tile
// as it is stored ([K, N], 128 k rows x 128 n bytes).  Two consumer warpgroups own 64 weight
// columns each; a warp takes the A fragments of four k-steps with two ldmatrix .trans (a b16
// element is a pair of adjacent weight columns, so a thread receives columns n, n + 1 of rows
// k, k + 1: slot g of warp w is column 16w + 2g, slot g + 8 the column after it) and widens them
// without a conversion instruction (hopper::widen_pair) while the other half-stage's products
// run.  The y^T tile goes through the epilogue (epilogue_store_t: qmm_kernel's operations in
// its order on the transposed fragment), is staged in shared memory and written as rows of y.
// Persistent blocks walk the output tiles with M fastest, as the W8A8 kernel does.
// What bounds it: each 128-deep stage is 1024 cycles of bf16 tensor work an SM at the data
// sheet's rate against 128 KB through shared memory (TMA 48, the two warpgroups' wgmma reads of
// x 64, their ldmatrix reads of the weight 16): near the SM's 128 bytes a cycle, so shared
// memory and the tensor cores bind together; the widening, about 2.5 integer and fp32
// instructions a weight, runs between the products of each warpgroup.  (A widening warpgroup
// that wrote a bf16 B tile for ss wgmma moved 1.5x the shared-memory bytes a FLOP and measured
// slower at every FLUX and T5 shape; PERF.md.)
namespace wo {

constexpr int BK = 128;                 // k elements per stage
constexpr int X_PANEL = BM * 128;       // 128 m rows x 64 k bf16: one TMA box
constexpr int X_TILE = 2 * X_PANEL;
constexpr int W_TILE = BK * BN;         // the int8 weight: 128 k rows x 128 n bytes
constexpr int STAGES_WO = 3;
constexpr int OUT_WO = BM * 64 * 2;     // one warpgroup's [128 m][64 n] bf16 tile
// warpgroups: two consumers and the producer; entry registers 65536 / 384 = 168, then 240 for
// the consumers and 24 for the producer (2 x 72 = 144)
constexpr int CONSUMERS_WO = 256, THREADS_WO = CONSUMERS_WO + 128, ENTRY_REGS_WO = 168;
constexpr int SMEM_WO = STAGES_WO * (X_TILE + W_TILE) + 2 * OUT_WO + BM * 8 * 4 +
                        2 * STAGES_WO * 8 + 1024;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}

// The A fragments of k-steps s0 .. s0 + 3 of a stage for the warp's 16-byte column chunk of the
// raw tile (row k at k * 128, chunk c at c ^ (k % 8)): matrix q of each x4 is rows
// 16 (s + q / 2) + 8 (q % 2) + 0..7, and a thread receives bytes (k 2t: n, n + 1), (k 2t + 1:
// n, n + 1) with n = 2g, so slot g takes bytes 0 and 2, slot g + 8 bytes 1 and 3.  widen = 0
// passes the raw words on unwidened (the timing probe of QmmArgs::prep_b).
__device__ __forceinline__ void load_fragments(uint32_t (&f)[4][4], const uint8_t* wt, int chunk,
                                               int s0, int lane, int widen) {
  const int q = lane / 8, r = lane % 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 16 * (s0 + 2 * h + q / 2) + 8 * (q % 2) + r;
    uint32_t m[4];
    ldsm_x4_trans(m, wt + k * 128 + ((chunk ^ (k % 8)) * 16));
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      if (!widen) {
        f[2 * h + ss][0] = f[2 * h + ss][1] = m[2 * ss];
        f[2 * h + ss][2] = f[2 * h + ss][3] = m[2 * ss + 1];
        continue;
      }
      const uint32_t ab = m[2 * ss] ^ 0x80808080u, cd = m[2 * ss + 1] ^ 0x80808080u;
      f[2 * h + ss][0] = hopper::widen_pair(ab, 0x7540, 0x7542);
      f[2 * h + ss][1] = hopper::widen_pair(ab, 0x7541, 0x7543);
      f[2 * h + ss][2] = hopper::widen_pair(cd, 0x7540, 0x7542);
      f[2 * h + ss][3] = hopper::widen_pair(cd, 0x7541, 0x7543);
    }
  }
}

// The epilogue of one consumer warpgroup's y^T tile: acc[4i + e] is y[m0 + 8i + 2t + e][col],
// acc[4i + 2 + e] the next column, col = n0 + 64 wgi + 16 warp + 2g.  qmm_kernel's operations
// in its order: z = acc * scale (+ bias), gelu by the exact gelu_tanh, then the gate + residual
// or the fused-qkv RMS (a head's sum of squares over its warps through `red`, [128][8] floats
// shared by both warpgroups: the 128-column tile lies in one plane); the bf16 tile is staged in
// shared memory (`stage`, [128 m][64 n]) and written as 128-byte row pieces.
template <int EPI>
__device__ __forceinline__ void epilogue_store_t(float (&acc)[64], const QmmArgs& p, int m0,
                                                 int n0, uint8_t* stage, float* red) {
  constexpr bool GELU = EPI == EPI_GELU || EPI == EPI_GELU_GATE;
  constexpr bool GATE = EPI == EPI_GATE || EPI == EPI_GELU_GATE;
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const int nloc = warp * 16 + 2 * g, col = n0 + wgi * 64 + nloc;
  const bool col_ok = col < p.N;
  const float s0 = col_ok ? p.scale[col] : 0.f, s1 = col_ok ? p.scale[col + 1] : 0.f;
  const float b0 = col_ok && p.bias ? p.bias[col] : 0.f;
  const float b1 = col_ok && p.bias ? p.bias[col + 1] : 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      acc[4 * i + e] = epi_value<GELU>(acc[4 * i + e], s0, p.bias, b0);
      acc[4 * i + 2 + e] = epi_value<GELU>(acc[4 * i + 2 + e], s1, p.bias, b1);
    }
  if (GATE && col_ok) {
    // out = resid + g_seg * z on the fp32 z
    const float gm0 = p.gate[col], gm1 = p.gate[col + 1];
    const float gc0 = p.gate[p.N + col], gc1 = p.gate[p.N + col + 1];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * i + 2 * t + e;
        if (row >= p.M) continue;
        const bool cond = row >= p.boundary;
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(p.resid + (long long)row * p.N + col);
        acc[4 * i + e] = gate_res(__low2float(r), cond ? gc0 : gm0, acc[4 * i + e]);
        acc[4 * i + 2 + e] = gate_res(__high2float(r), cond ? gc1 : gm1, acc[4 * i + 2 + e]);
      }
  }
  int plane = 0;
  if (EPI == EPI_QKV) {
    // per row: each warp's sum of squares over its 16 columns, then over the head's warps
    plane = n0 / p.plane_h;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float ss = acc[4 * i + e] * acc[4 * i + e] + acc[4 * i + 2 + e] * acc[4 * i + 2 + e];
        ss += __shfl_xor_sync(0xffffffffu, ss, 4);
        ss += __shfl_xor_sync(0xffffffffu, ss, 8);
        ss += __shfl_xor_sync(0xffffffffu, ss, 16);
        if (g == 0) red[(8 * i + 2 * t + e) * 8 + wgi * 4 + warp] = ss;
      }
    hopper::named_barrier_sync(3, CONSUMERS_WO);
    const int per_head = p.head_dim / 16, first = ((wgi * 4 + warp) / per_head) * per_head;
    const int hc = col - plane * p.plane_h;
    const float w0 = plane < 2 && col_ok ? p.norm_w[plane * p.plane_h + hc] : 1.f;
    const float w1 = plane < 2 && col_ok ? p.norm_w[plane * p.plane_h + hc + 1] : 1.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* rr = red + (8 * i + 2 * t + e) * 8;
        float tot = 0.f;
        for (int w = first; w < first + per_head; ++w) tot += rr[w];
        const float rstd = head_rstd(tot, p.head_dim);
        if (plane < 2) {
          acc[4 * i + e] = __fmul_rn(__fmul_rn(acc[4 * i + e], rstd), w0);
          acc[4 * i + 2 + e] = __fmul_rn(__fmul_rn(acc[4 * i + 2 + e], rstd), w1);
        }
      }
    hopper::named_barrier_sync(3, CONSUMERS_WO);  // red is free for the next tile
  }
  // Stage the 128 x 64 tile (16-byte chunk c of row r at c ^ (r % 8): conflict-free both ways)
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * i + 2 * t + e;
      *reinterpret_cast<uint32_t*>(stage + r * 128 + (((nloc / 8) ^ (r % 8)) * 16) +
                                   2 * (nloc % 8)) = pack_bf16(acc[4 * i + e], acc[4 * i + 2 + e]);
    }
  hopper::named_barrier_sync(1 + wgi, 128);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = tid + 128 * i, r = idx / 8, c = idx % 8;
    const int row = m0 + r, cc = n0 + wgi * 64 + 8 * c;
    if (row >= p.M || cc >= p.N) continue;
    __nv_bfloat16* dst = EPI == EPI_QKV ? p.out + ((long long)plane * p.M + row) * p.plane_h +
                                              (cc - plane * p.plane_h)
                                        : p.out + (long long)row * p.N + cc;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(stage + r * 128 + ((c ^ (r % 8)) * 16));
  }
  hopper::named_barrier_sync(1 + wgi, 128);  // the stage is free for the next tile
}

template <int EPI>
__global__ void __launch_bounds__(THREADS_WO, 1)
qmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const QmmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sx = base;
  uint8_t* sw = base + STAGES_WO * X_TILE;
  uint8_t* sout = base + STAGES_WO * (X_TILE + W_TILE);
  float* red = reinterpret_cast<float*>(sout + 2 * OUT_WO);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + BM * 8);
  uint64_t* empty = full + STAGES_WO;

  const int mtiles = (p.M + BM - 1) / BM;
  const int tiles = mtiles * ((p.N + BN - 1) / BN);
  const int nk = p.K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_WO; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS_WO / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS_WO) {
    // producer warpgroup: one thread starts the TMA loads
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS_WO) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mtiles) * BM, n0 = (tile / mtiles) * BN;
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % STAGES_WO;
          hopper::mbar_wait(&empty[s], ((it / STAGES_WO) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], X_TILE + W_TILE);
          hopper::tma_load_2d(sx + s * X_TILE, &map_x, &full[s], j * BK, m0);
          hopper::tma_load_2d(sx + s * X_TILE + X_PANEL, &map_x, &full[s], j * BK + 64, m0);
          hopper::tma_load_2d(sw + s * W_TILE, &map_w, &full[s], n0, j * BK);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int chunk = wgi * 4 + warp;  // the warp's 16 weight columns in the raw tile's rows
  uint8_t* stage = sout + wgi * OUT_WO;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % mtiles) * BM, n0 = (tile / mtiles) * BN;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t fa[4][4], fb[4][4];
    int pending = -1;  // the stage whose second half's products may still read it
    for (int j = 0; j < nk; ++j, ++it) {
      const int s = it % STAGES_WO;
      hopper::mbar_wait(&full[s], (it / STAGES_WO) & 1);
      const uint8_t* xt = sx + s * X_TILE;
      const uint8_t* wt = sw + s * W_TILE;
      load_fragments(fa, wt, chunk, 0, lane, p.prep_b);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128k16_bf16_rs(acc, fa[kk], hopper::desc_sw128(xt + kk * 32, 16, 1024),
                                         j > 0 || kk > 0);
      hopper::wgmma_commit();
      // the previous stage's second half is done: fb is free and that stage too
      hopper::wgmma_wait<1>();
      hopper::fence_operands(fb);
      if (pending >= 0 && lane == 0) hopper::mbar_arrive(&empty[pending]);
      load_fragments(fb, wt, chunk, 4, lane, p.prep_b);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128k16_bf16_rs(
            acc, fb[kk], hopper::desc_sw128(xt + X_PANEL + kk * 32, 16, 1024), 1);
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
    epilogue_store_t<EPI>(acc, p, m0, n0, stage, red);
  }
}

template <int EPI>
cudaError_t launch_one(const CUtensorMap& mx, const CUtensorMap& mw, const QmmArgs& p,
                       cudaStream_t st) {
  static const bool regs_ok = hopper::entry_regs_are(qmm_bf16_wgmma_kernel<EPI>, ENTRY_REGS_WO);
  if (!regs_ok || num_sms() == 0) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(qmm_bf16_wgmma_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_WO);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  const int blocks = tiles < num_sms() ? tiles : num_sms();
  qmm_bf16_wgmma_kernel<EPI><<<blocks, THREADS_WO, SMEM_WO, st>>>(mx, mw, p);
  return cudaGetLastError();
}

cudaError_t launch(int epilogue, const QmmArgs& p, cudaStream_t st) {
  if (p.M < 1 || p.K % BK || p.K < BK || p.N < BN || p.N % 16) return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(p.K), static_cast<uint64_t>(p.M)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(p.K) * 2};
  const uint32_t x_box[2] = {64, BM};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(p.N), static_cast<uint64_t>(p.K)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(p.N)};
  const uint32_t w_box[2] = {BN, BK};
  if (!hopper::make_tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.a, x_dims, x_strides,
                               x_box) ||
      !hopper::make_tensor_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.w, w_dims, w_strides,
                               w_box))
    return cudaErrorInvalidValue;
  switch (epilogue) {
    case EPI_BIAS: return launch_one<EPI_BIAS>(mx, mw, p, st);
    case EPI_GELU: return launch_one<EPI_GELU>(mx, mw, p, st);
    case EPI_QKV: return launch_one<EPI_QKV>(mx, mw, p, st);
    case EPI_GATE: return launch_one<EPI_GATE>(mx, mw, p, st);
    case EPI_GELU_GATE: return launch_one<EPI_GELU_GATE>(mx, mw, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wo

}  // namespace wg

// ---------------------------------------------------------------------------------------
// The flat GEMM at N below one 128 tile (kernel 4, _qmm_kernel :75, pallas_call :127, at the
// final proj_out: M 1024 K 3072 N 64), both MAC modes, split K over a thread-block cluster
// (`qmm_route`'s "splitk"; the wrapper's `splitk_plan` gives the cluster size, the slice of K
// a block takes and the rows a block).
// What bounds it: bytes.  It does 2 M K N operations against x's M K elements (2 bytes each
// weight-only, 1 byte of codes W8A8): 64 operations a bf16 byte at N 64, far below the ridge,
// so the design's job is to put the whole card on reading x.  qmm_kernel's 128 x 128 tiles give
// M / 128 = 8 blocks at M 1024, each walking K 3072 alone.  Here the CLUSTER (8, the portable
// maximum) blocks of a cluster share one 64-row tile and split K into equal slices, so M 1024
// runs 16 x 8 = 128 blocks, two of which fit an SM.  Lane 0 of each warp starts the TMA loads of
// its share of the slice's panels at once (x in panels 128 bytes wide, 64 bf16 or 128 codes,
// 128-byte swizzle; the raw weight rows of each panel as 128-byte rows), one mbarrier a panel,
// so the whole slice is in flight and the products start as the first panel lands.
//   * W8A8: 8-bit wgmma takes B only K-major, so the warpgroup transposes each raw weight panel
//     into a ring of two K-major B slots (the rows past N zero), then runs wgmma m64nNTk32 s8
//     ss on it while it transposes the next; NT (64 or 128) is the N tile.
//   * Weight-only: qmm_bf16_wgmma_kernel's y^T = W^T x^T: the weight is the register operand of
//     wgmma m64n64k16 bf16 (rs), read from the raw panel by ldmatrix .trans and widened in
//     registers (hopper::widen_pair), the x panel the K-major B; two fragment buffers, so a
//     panel's fragments load while the other's products run, and no panel waits on a shared-
//     memory write or a block barrier (the transposing form measured 0.0093 ms against this
//     form's 0.0077 at proj_out).
// The reduction: each block stages its fp32 (W8A8: s32) partial tile in its shared memory, then
// pushes row r to block r / (64 / CLUSTER) of the cluster, 16 bytes a store (st.async into the
// receiver's slot for this block, counted on the receiver's mbarrier: one-way, no round trip);
// each block sums its rows over the blocks in rank order and runs the epilogue on them, its
// epilogue operands loaded while the partial tiles travel.  No partial goes to device memory and
// no atomic is used: the result does not depend on timing.  W8A8: no slice straddles an
// activation group (`splitk_plan`), so a group's s32 partials sum exactly to qmm_kernel's i32,
// and facc = fadd(facc, fmul(float(i32), x_scale)) runs in group order and the epilogue in
// qmm_kernel's operations: the output equals the mma.sync kernel's bit for bit.  Weight-only:
// fixed-order fp32 sums, within one bf16 rounding of qmm_plain.  Ragged M: TMA zero-fills the rows
// past M (and, W8A8, the weight rows past K up to Kp) and the store masks them.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.0072-0.0079 ms W8A8 (0.0126-0.0131 with
// its activation pass) and 0.0075-0.0080 weight-only at proj_out, against 0.059-0.063 and
// 0.083-0.087 on qmm_kernel; a single cluster (M 64) takes 0.0055-0.0062, so the latency chain
// (launch, first panel, cluster exchange), not the bytes, holds it above its 0.002 bound.
namespace sk {

constexpr int ROWS = 64;      // rows of x a block: one m64 wgmma
constexpr int THREADS = 128;  // one warpgroup
constexpr int CLUSTER = 8;    // blocks a cluster, each one slice of K: the portable maximum
constexpr int X_PANEL = ROWS * 128;
constexpr int MAX_PANELS = 16;
constexpr int SMEM_LIMIT = 232448;  // the dynamic shared memory a block may take

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Bytes of the x panels and, W8A8, the ring of two K-major B panels, which the partial tile
// (ROWS rows of nt + 8 words) reuses after the products.
__host__ __device__ inline int tile_bytes(bool w8a8, int panels, int nt) {
  const int tiles = panels * X_PANEL + (w8a8 ? (panels < 2 ? panels : 2) * nt * 128 : 0);
  const int red = ROWS * (nt + 8) * 4;
  return round_up(tiles > red ? tiles : red, 1024);
}

// Bytes of the receive buffer: the block's ROWS / CLUSTER rows of every block's partial tile,
// rows nt + 4 words apart.
__host__ __device__ constexpr int recv_bytes(int nt) { return CLUSTER * (ROWS / CLUSTER) * (nt + 4) * 4; }

// Shared memory a block takes: the tiles above, the raw weight slice, the receive buffer, one
// mbarrier a panel and one for the receive buffer, and the slack that aligns the base to 1024
// bytes.  `splitk_smem` in ops/quant_matmul.py computes the same.
__host__ __device__ inline int smem_bytes(bool w8a8, int slice_k, int nt, int n) {
  const int panels = slice_k / (w8a8 ? 128 : 64);
  return 1024 + tile_bytes(w8a8, panels, nt) + round_up(slice_k * n, 1024) +
         round_up(recv_bytes(nt), 1024) + 8 * (panels + 1);
}

// W8A8: one raw weight panel (128 rows of n_cols bytes, row-major) -> the K-major B tile (8-bit
// wgmma takes B only K-major): NT rows of 128 codes, 16-byte chunk c of row n at c ^ (n % 8),
// the rows past n_cols zero.  A task is 4 weight columns x 16 rows.
template <int NT>
__device__ __forceinline__ void transpose_panel(const uint8_t* raw, uint8_t* bt, int n_cols,
                                                int tid) {
  constexpr int TASKS = 8 * (NT / 4);
  for (int task = tid; task < TASKS; task += THREADS) {
    const int n4 = task % (NT / 4), kc = task / (NT / 4);
    uint4 out[4];
    if (4 * n4 < n_cols) {
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(raw + (16 * kc + i) * n_cols + 4 * n4);
      uint32_t col[4][4];  // [n][k word]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t c[4];
        wg::transpose4x4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3], c);
#pragma unroll
        for (int j = 0; j < 4; ++j) col[j][q] = c[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * n4 + j;
      *reinterpret_cast<uint4*>(bt + n * 128 + ((kc ^ (n % 8)) * 16)) = out[j];
    }
  }
}

// One W8A8 k-step of 32 bytes of a panel: wgmma m64nNTk32 s8, A and B K-major.
template <int NT>
__device__ __forceinline__ void mma_step_s8(int (&acc)[NT / 2], uint64_t da, uint64_t db,
                                            int accumulate) {
  if constexpr (NT == 64)
    hopper::wgmma_m64n64k32_s8(acc, da, db, accumulate);
  else
    hopper::wgmma_m64n128k32_s8(acc, da, db, accumulate);
}

// Weight-only: the A fragments (the y^T = W^T x^T form of qmm_bf16_wgmma_kernel, the weight the
// register operand) of a 64-k panel's four k-steps for the warp's 16 weight columns `chunk` of
// the raw panel as TMA lands it (k row k at byte k * n_cols, 128-byte swizzled: byte L at
// L ^ ((L >> 7) % 8) << 4).  ldmatrix .trans takes a b16 element as two adjacent weight
// columns, so slot g of the warp is column 16 chunk + 2g and slot g + 8 the column after it;
// hopper::widen_pair widens them exactly (wg::wo::load_fragments' arrangement).
__device__ __forceinline__ void wonly_fragments(uint32_t (&f)[4][4], const uint8_t* raw,
                                                int n_cols, int chunk, int lane) {
  const int q = lane / 8, r = lane % 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lin = (16 * (2 * h + q / 2) + 8 * (q % 2) + r) * n_cols + 16 * chunk;
    uint32_t m[4];
    wg::wo::ldsm_x4_trans(m, raw + (lin ^ (((lin >> 7) & 7) << 4)));
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      const uint32_t ab = m[2 * ss] ^ 0x80808080u, cd = m[2 * ss + 1] ^ 0x80808080u;
      f[2 * h + ss][0] = hopper::widen_pair(ab, 0x7540, 0x7542);
      f[2 * h + ss][1] = hopper::widen_pair(ab, 0x7541, 0x7543);
      f[2 * h + ss][2] = hopper::widen_pair(cd, 0x7540, 0x7542);
      f[2 * h + ss][3] = hopper::widen_pair(cd, 0x7541, 0x7543);
    }
  }
}


template <bool W8A8, int NT, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
qmm_splitk_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const QmmArgs p, int slice_k) {
  static_assert(EPI != EPI_QKV, "the fused-qkv planes are never narrower than one tile");
  constexpr bool GELU = EPI == EPI_GELU || EPI == EPI_GELU_GATE;
  constexpr bool GATE = EPI == EPI_GATE || EPI == EPI_GELU_GATE;
  constexpr int PANEL_K = W8A8 ? 128 : 64;  // k elements of a 128-byte panel row
  constexpr int W_PANEL = NT * 128;
  constexpr int RS = NT + 8;                // row stride of the partial tile, in 32-bit words
  constexpr int RR = NT + 4;                // row stride of the receive buffer
  constexpr int RPR = ROWS / CLUSTER, PER_ROW = NT / 4;
  constexpr int ITEMS = RPR * PER_ROW / THREADS;  // 4-column pieces a thread reduces
  static_assert(ITEMS * THREADS == RPR * PER_ROW, "whole pieces a thread");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int panels = slice_k / PANEL_K;
  uint8_t* sx = base;
  uint8_t* sbt = base + panels * X_PANEL;  // W8A8: a ring of two K-major B panels
  uint8_t* sraw = base + tile_bytes(W8A8, panels, NT);
  uint32_t* recv = reinterpret_cast<uint32_t*>(sraw + round_up(slice_k * p.N, 1024));
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(recv) +
                                               round_up(recv_bytes(NT), 1024));
  uint64_t* got = full + panels;                      // the receive buffer's barrier
  uint32_t* red = reinterpret_cast<uint32_t*>(base);  // the partial tile, after the products

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rank = static_cast<int>(hopper::cluster_ctarank());
  const int m0 = blockIdx.y * ROWS, k0 = rank * slice_k;
  if (tid == 0) {
    hopper::prefetch_tensor_map(&map_x);
    hopper::prefetch_tensor_map(&map_w);
    for (int i = 0; i < panels; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_init(got, 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(got, CLUSTER * RPR * NT * 4);
  }
  __syncthreads();
  // lane 0 of warp w starts the loads of panels w, w + 4, ...; the weight as 128-byte rows
  if (lane == 0)
    for (int i = warp; i < panels; i += THREADS / 32) {
      const int k = k0 + i * PANEL_K;
      hopper::mbar_arrive_expect_tx(&full[i], X_PANEL + PANEL_K * p.N);
      hopper::tma_load_2d(sx + i * X_PANEL, &map_x, &full[i], k, m0);
      hopper::tma_load_2d(sraw + i * PANEL_K * p.N, &map_w, &full[i], 0, k * p.N / 128);
    }
  hopper::cluster_arrive();  // this block's barriers are initialised

  if constexpr (W8A8) {
    // each raw weight panel transposed into a ring slot, then its s8 products
    int acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
    for (int i = 0; i < panels; ++i) {
      uint8_t* bt = sbt + (i % 2) * W_PANEL;
      if (i >= 2) hopper::wgmma_wait<1>();  // panel i - 2's products are done with this slot
      hopper::mbar_wait(&full[i], 0);
      transpose_panel<NT>(sraw + i * PANEL_K * p.N, bt, p.N, tid);
      hopper::fence_proxy_async();
      __syncthreads();  // the whole B tile is written
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_step_s8<NT>(acc, hopper::desc_sw128(sx + i * X_PANEL + kk * 32, 16, 1024),
                        hopper::desc_sw128(bt + kk * 32, 16, 1024), i > 0 || kk > 0);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    __syncthreads();  // every product has read its tiles: the partial tile goes over them
    // acc[4i + e] is the partial sum at row 16 warp + g + 8 (e / 2), column 8i + 2t + e % 2
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint2*>(red + (warp * 16 + g + 8 * h) * RS + 8 * i + 2 * t) =
            make_uint2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  } else {
    // y^T = W^T x^T: MT tiles of 64 weight columns, each wgmma m64n64k16 (rs) with the
    // fragments of one panel in registers while the other buffer's products run
    constexpr int MT = NT / 64;
    float acc[MT][32];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
    uint32_t fa[MT][4][4], fb[MT][4][4];
    auto fence_frags = [](uint32_t (&f)[MT][4][4]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) hopper::fence_operands(f[mt]);
    };
    auto panel = [&](uint32_t (&f)[MT][4][4], int i) {
      const uint8_t* raw = sraw + i * PANEL_K * p.N;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int chunk = 4 * mt + warp;
        if (16 * chunk < p.N) {
          wonly_fragments(f[mt], raw, p.N, chunk, lane);
        } else {
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int j = 0; j < 4; ++j) f[mt][s][j] = 0u;
        }
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hopper::wgmma_m64n64k16_bf16_rs(acc[mt], f[mt][kk],
                                          hopper::desc_sw128(sx + i * X_PANEL + kk * 32, 16, 1024),
                                          i > 0 || kk > 0);
      hopper::wgmma_commit();
    };
    for (int i = 0; i < panels; i += 2) {
      hopper::mbar_wait(&full[i], 0);
      if (i >= 2) {
        hopper::wgmma_wait<1>();  // panel i - 2's products are done with fa
        fence_frags(fa);
      }
      panel(fa, i);
      if (i + 1 < panels) {
        hopper::mbar_wait(&full[i + 1], 0);
        hopper::wgmma_wait<1>();  // panel i - 1's products are done with fb
        fence_frags(fb);
        panel(fb, i + 1);
      }
    }
    hopper::wgmma_wait<0>();
    fence_frags(fa);
    fence_frags(fb);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) hopper::fence_operands(acc[mt]);
    __syncthreads();  // every product has read the x panels: the partial tile goes over them
    // acc[mt][4i + e] is the partial sum at row (x) 8i + 2t + e % 2, column (weight)
    // 64 mt + 16 warp + 2g + e / 2
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<uint2*>(red + (8 * i + 2 * t + e) * RS + 64 * mt + 16 * warp + 2 * g) =
              make_uint2(__float_as_uint(acc[mt][4 * i + e]),
                         __float_as_uint(acc[mt][4 * i + 2 + e]));
  }

  // This block's pieces of the cluster's tile: rows [rank RPR, (rank + 1) RPR), 4 columns a
  // piece; their epilogue operands load while the partial tiles travel.
  int row[ITEMS], col[ITEMS];
  bool live[ITEMS];
  float sc[ITEMS][4], bi[ITEMS][4], gt[ITEMS][4];
  float xsq[ITEMS][CLUSTER];  // W8A8: the x_scale of block q's activation group
  uint2 rsd[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int idx = tid + it * THREADS;
    row[it] = m0 + rank * RPR + idx / PER_ROW;
    col[it] = 4 * (idx % PER_ROW);
    live[it] = row[it] < p.M && col[it] < p.N;
    if (!live[it]) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[it][e] = __ldg(p.scale + col[it] + e);
      bi[it][e] = p.bias ? __ldg(p.bias + col[it] + e) : 0.f;
    }
    if constexpr (W8A8) {
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q)
        xsq[it][q] = __ldg(p.xs + (long long)row[it] * p.n_groups + q * slice_k / p.group);
    }
    if constexpr (GATE) {
      const float* grow = p.gate + (row[it] >= p.boundary ? p.N : 0) + col[it];
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[it][e] = __ldg(grow + e);
      rsd[it] = *reinterpret_cast<const uint2*>(p.resid + (long long)row[it] * p.N + col[it]);
    }
  }
  __syncthreads();         // the partial tile is whole
  hopper::cluster_wait();  // every block's receive barrier is initialised
  // Send row r of the partial tile to block r / RPR, into its slot for this block: 16 bytes a
  // store, counted on the receiver's barrier.
#pragma unroll
  for (int j = 0; j < ROWS * PER_ROW / THREADS; ++j) {
    const int idx = tid + j * THREADS, r = idx / PER_ROW, c = 4 * (idx % PER_ROW);
    hopper::st_dsmem_v4(recv + (rank * RPR + r % RPR) * RR + c, got, r / RPR,
                        *reinterpret_cast<const uint4*>(red + r * RS + c));
  }
  hopper::cluster_arrive();  // this block's stores are issued
  hopper::mbar_wait(got, 0);  // every block's rows for this one have landed

  // Each value summed over the cluster's blocks in rank order (W8A8: the s32 partials of an
  // activation group, then at the group's last slice facc = fadd(facc, fmul(float(i32),
  // x_scale)), in group order from facc = 0), then the epilogue, one 8-byte store a piece.
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (!live[it]) continue;
    const uint32_t* src = recv + (row[it] - m0 - rank * RPR) * RR + col[it];
    uint4 v[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) v[q] = *reinterpret_cast<const uint4*>(src + q * RPR * RR);
    float z[4];
    if constexpr (W8A8) {
      int isum[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) z[e] = 0.f;
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) {
        isum[0] += static_cast<int>(v[q].x);
        isum[1] += static_cast<int>(v[q].y);
        isum[2] += static_cast<int>(v[q].z);
        isum[3] += static_cast<int>(v[q].w);
        if ((q + 1) * slice_k % p.group == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            z[e] = __fadd_rn(z[e], __fmul_rn(static_cast<float>(isum[e]), xsq[it][q]));
            isum[e] = 0;
          }
        }
      }
    } else {
      z[0] = __uint_as_float(v[0].x);
      z[1] = __uint_as_float(v[0].y);
      z[2] = __uint_as_float(v[0].z);
      z[3] = __uint_as_float(v[0].w);
#pragma unroll
      for (int q = 1; q < CLUSTER; ++q) {
        z[0] = __fadd_rn(z[0], __uint_as_float(v[q].x));
        z[1] = __fadd_rn(z[1], __uint_as_float(v[q].y));
        z[2] = __fadd_rn(z[2], __uint_as_float(v[q].z));
        z[3] = __fadd_rn(z[3], __uint_as_float(v[q].w));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) z[e] = epi_value<GELU>(z[e], sc[it][e], p.bias, bi[it][e]);
    if constexpr (GATE) {
      // out = resid + g_seg * z on the fp32 z
      const __nv_bfloat162 r01 = *reinterpret_cast<const __nv_bfloat162*>(&rsd[it].x);
      const __nv_bfloat162 r23 = *reinterpret_cast<const __nv_bfloat162*>(&rsd[it].y);
      z[0] = gate_res(__low2float(r01), gt[it][0], z[0]);
      z[1] = gate_res(__high2float(r01), gt[it][1], z[1]);
      z[2] = gate_res(__low2float(r23), gt[it][2], z[2]);
      z[3] = gate_res(__high2float(r23), gt[it][3], z[3]);
    }
    *reinterpret_cast<uint2*>(p.out + (long long)row[it] * p.N + col[it]) =
        make_uint2(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]));
  }
  hopper::cluster_wait();  // no block leaves while its stores to another may be in flight
}

template <bool W8A8, int NT, int EPI>
cudaError_t launch_one(const CUtensorMap& mx, const CUtensorMap& mw, const QmmArgs& p,
                       int cluster, int slice_k, int smem, cudaStream_t st) {
  auto* kernel = qmm_splitk_kernel<W8A8, NT, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.M + ROWS - 1) / ROWS, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mx, mw, p, slice_k);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool W8A8, int NT>
cudaError_t launch_nt(int epilogue, const CUtensorMap& mx, const CUtensorMap& mw,
                      const QmmArgs& p, int cluster, int slice_k, int smem, cudaStream_t st) {
  switch (epilogue) {
    case EPI_BIAS: return launch_one<W8A8, NT, EPI_BIAS>(mx, mw, p, cluster, slice_k, smem, st);
    case EPI_GELU: return launch_one<W8A8, NT, EPI_GELU>(mx, mw, p, cluster, slice_k, smem, st);
    case EPI_GATE: return launch_one<W8A8, NT, EPI_GATE>(mx, mw, p, cluster, slice_k, smem, st);
    case EPI_GELU_GATE:
      return launch_one<W8A8, NT, EPI_GELU_GATE>(mx, mw, p, cluster, slice_k, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch(bool w8a8, int epilogue, const QmmArgs& p, int cluster, int slice_k, int rows,
                   cudaStream_t st) {
  const int panel_k = w8a8 ? 128 : 64, kloop = w8a8 ? p.Kp : p.K;
  if (rows != ROWS || cluster != CLUSTER || p.M < 1 ||
      p.N < 16 || p.N > 128 || p.N % 16 || p.K % 128 || slice_k < panel_k || slice_k % panel_k ||
      slice_k / panel_k > MAX_PANELS || cluster * slice_k != kloop ||
      (w8a8 && p.group % slice_k))
    return cudaErrorInvalidValue;
  const int nt = p.N <= 64 ? 64 : 128;
  const int smem = smem_bytes(w8a8, slice_k, nt, p.N);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(kloop), static_cast<uint64_t>(p.M)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(kloop) * (w8a8 ? 1 : 2)};
  const uint32_t x_box[2] = {static_cast<uint32_t>(panel_k), ROWS};
  // the weight [K, N] as rows of 128 bytes (N a multiple of 16 and K of 128: whole rows), a
  // panel of panel_k weight rows one box; W8A8 unswizzled for transpose_panel, weight-only
  // 128-byte swizzled for ldmatrix
  const uint64_t w_dims[2] = {128, static_cast<uint64_t>(p.K) * p.N / 128};
  const uint64_t w_strides[1] = {128};
  const uint32_t w_box[2] = {128, static_cast<uint32_t>(panel_k * p.N / 128)};
  if (!hopper::make_tensor_map(&mx, w8a8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               2, p.a, x_dims, x_strides, x_box) ||
      !hopper::make_tensor_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.w, w_dims, w_strides,
                               w_box, w8a8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                           : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (w8a8)
    return nt == 64 ? launch_nt<true, 64>(epilogue, mx, mw, p, cluster, slice_k, smem, st)
                    : launch_nt<true, 128>(epilogue, mx, mw, p, cluster, slice_k, smem, st);
  return nt == 64 ? launch_nt<false, 64>(epilogue, mx, mw, p, cluster, slice_k, smem, st)
                  : launch_nt<false, 128>(epilogue, mx, mw, p, cluster, slice_k, smem, st);
}

}  // namespace sk

// ---------------------------------------------------------------------------------------
// The flat GEMM at K of one 64-wide panel (kernel 4, _qmm_kernel :75, pallas_call :127, at
// x_embedder: M 1024 K 64 N 3072), both MAC modes (`qmm_route`'s "k64": K 16..64 a multiple of
// 16, N whole 128 tiles, W8A8 with one activation group over the whole padded row).
// What bounds it: bytes.  It does 2 M K N operations (0.4 GOP at x_embedder) against the
// M N bf16 output (6.3 MB): 60 operations a byte, far below the ridge, so the card's job is to
// write the output at bandwidth, and the design's to leave nothing else on the way of the
// store: one launch (W8A8 quantizes in the kernel; qmm_kernel ran after a separate activation
// pass, and a one-wave call pays about 3 us of launch and ramp), one 128 x 128 output tile a
// block, 256 threads, 33 KB of shared memory, so every block of the call is resident at once
// (192 at M 1024, two an SM) and one block's store overlaps another's loads and products; the
// chain of a block is short: one round trip of loads, a pass through registers, the products,
// the store.  A block:
//   * every thread loads its share of the weight panel (8 words) and of the x tile (4 chunks of
//     16 bytes) at once, straight into registers (no TMA: the panel goes through registers for
//     its transpose anyway, and the chain saves the tensor maps' fetch and an mbarrier);
//   * W8A8: 8 lanes quantize a row, one 16-byte chunk of 8 bf16 each: the row's absmax over its
//     K values on bf16 pairs (exact), x_scale = absmax / 127 (1 for a zero row) and
//     quant8::codes8's codes, the operations of act_quant_warp_kernel with the group of
//     `flat_w8a8_group` (group = padded K: one scale a row, the codes past K zero, so the
//     products over them add nothing), into the K-major A tile; weight-only stores x as it is;
//   * the threads transpose their weight words into the K-major B tile (8-bit wgmma takes B
//     only K-major), weight-only widening each int8 exactly to bf16 (hopper::widen_pair); a 4 x 4
//     byte block a step (wg::transpose4x4);
//   * each warpgroup runs its 64 rows: W8A8 two wgmma m64n128k32 s8 (K 64), then
//     facc = fadd(0, fmul(float(i32), x_scale)) as qmm_kernel folds its one group; weight-only
//     four wgmma m64n128k16 bf16 with an fp32 accumulator;
//   * the epilogue is wg::epilogue_store (qmm_kernel's operations in its order: z = acc * scale
//     (+ bias), gelu_tanh, the gate + residual or fused-qkv forms), staged in the shared memory
//     of the A and B tiles once both warpgroups' products are done.
// W8A8 equals the mma.sync route (the activation pass, then qmm_kernel) bit for bit: the same
// codes and scales, exact s32 sums, the same fp32 operations.  Weight-only: fp32 sums in
// wgmma's order, within one bf16 rounding of qmm_plain.  Ragged M: the loads zero the rows past
// M, the store masks them; K below 64: the loads zero k past K.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): at x_embedder 0.008 ms W8A8 (0.016 on the
// mma.sync route), 0.0056 weight-only (0.0097), cuBLAS bf16 0.0040; at M 128 still 0.006 and
// 0.004, so a block's chain (loads, the quantization's shuffles and IEEE division, the products,
// the store), not the bytes, holds it above its 0.002 bound.
namespace k64 {

// A timing probe: built with -DK64_PROBE_PREP=0, 1 or 2 the kernel skips its weight's transpose
// (bit 0 clear) or its W8A8 quantization (bit 1 clear), wrong results (scripts/wgmma_check.py
// k64 builds these).  3 runs it.
#ifndef K64_PROBE_PREP
#define K64_PROBE_PREP 3
#endif

constexpr int BM = 128, BN = 128, THREADS = 256;
constexpr int KMAX = 64;                 // the one panel's k
constexpr int A_TILE = BM * 128;         // 128 rows of 128 bytes (W8A8: 64 codes, 64 unread)
constexpr int B_TILE = BN * 128;         // 128 n rows of 128 bytes, K-major
constexpr int SMEM = 1024 + A_TILE + B_TILE + BM * 4;
static_assert(A_TILE + B_TILE >= 2 * wg::OUT_TILE, "the staging tiles reuse A and B");

template <bool W8A8, int EPI>
__global__ void __launch_bounds__(THREADS, 2) qmm_k64_kernel(const QmmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = base;
  uint8_t* sb = base + A_TILE;
  float* sxs = reinterpret_cast<float*>(sb + B_TILE);  // W8A8: each row's x_scale
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // Every load of the block first, all in flight together: the thread's 8 weight words (k rows
  // 8 (t / 32) .. + 7, columns 4 (t % 32) .. + 3: a warp reads whole 128-byte rows) and its four
  // 16-byte chunks of x (chunk c = t % 8, k 8c .. 8c + 7, of rows t / 8 + 32 i: a row's 8 lanes
  // adjacent); the epilogue's scale and bias lines into L1
  const int n4 = tid % 32, kq = tid / 32, c = tid % 8;
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 8 * kq + i;
    const uint8_t* src = p.w + (long long)k * p.N + n0 + 4 * n4;
    w[i] = k < p.K ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
  }
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(p.a);
  uint4 raw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tid / 8 + 32 * i;
    raw[i] = (gm < p.M && 8 * c < p.K)
                 ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)gm * p.K + 8 * c))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < 8 && (tid < 4 || p.bias))
    asm volatile("prefetch.L1 [%0];" ::"l"((tid < 4 ? p.scale : p.bias) + n0 + 32 * (tid % 4)));

  if (!W8A8) {
    // x as it is: the K-major A tile (16-byte chunk c of row r at c ^ (r % 8))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 8 + 32 * i;
      *reinterpret_cast<uint4*>(sa + r * 128 + ((c ^ (r % 8)) * 16)) = raw[i];
    }
  } else if (K64_PROBE_PREP & 2) {
    // a row's absmax over its 8 lanes (on bf16 pairs, exact), x_scale = absmax / 127 (1 for a
    // zero row), then quant8::codes8's codes; each stage over the thread's four rows at once,
    // so their dependent chains (shuffles, the IEEE division and reciprocal) overlap
    float amax[4], scale[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
      __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) m2 = __hmax2(m2, __habs2(xv[e]));
      amax[i] = fmaxf(__low2float(m2), __high2float(m2));
    }
#pragma unroll
    for (int off = 1; off < 8; off *= 2)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], off));
#pragma unroll
    for (int i = 0; i < 4; ++i) scale[i] = quant8::scale_of(amax[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 8 + 32 * i;
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
      float val[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        val[2 * e] = __low2float(xv[e]);
        val[2 * e + 1] = __high2float(xv[e]);
      }
      *reinterpret_cast<uint2*>(sa + r * 128 + (((c / 2) ^ (r % 8)) * 16) + 8 * (c % 2)) =
          quant8::codes8(val, scale[i], __frcp_rn(scale[i]));
      if (c == 0) sxs[r] = scale[i];
    }
  }

  // p.K > 0 always holds (launch checks K >= 16); the branch, which the compiler cannot fold,
  // keeps ptxas from scheduling the transposes ahead of the x tile's stores: without it the
  // weight-only kernel measured 0.0070-0.0073 ms at x_embedder against 0.0055-0.0056 (H100
  // 80GB HBM3, 700 W; scripts/wgmma_check.py k64, chip_smoke.py)
  if ((K64_PROBE_PREP & 1) && p.K > 0) {
    // the weight words -> B row n (k contiguous, 16-byte chunk c at c ^ (n % 8)), weight-only
    // widened to bf16
    uint32_t lo[4], hi[4];  // column j's k bytes 0..3 and 4..7 of the thread's 8
    wg::transpose4x4(w[0], w[1], w[2], w[3], lo);
    wg::transpose4x4(w[4], w[5], w[6], w[7], hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * n4 + j;
      if (W8A8) {
        *reinterpret_cast<uint2*>(sb + n * 128 + (((kq / 2) ^ (n % 8)) * 16) + 8 * (kq % 2)) =
            make_uint2(lo[j], hi[j]);
      } else {
        const uint32_t a = lo[j] ^ 0x80808080u, b = hi[j] ^ 0x80808080u;
        *reinterpret_cast<uint4*>(sb + n * 128 + ((kq ^ (n % 8)) * 16)) = make_uint4(
            hopper::widen_pair(a, 0x7540, 0x7541), hopper::widen_pair(a, 0x7542, 0x7543),
            hopper::widen_pair(b, 0x7540, 0x7541), hopper::widen_pair(b, 0x7542, 0x7543));
      }
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();

  const int wgi = tid / 128, warp = (tid / 32) % 4, g = (tid % 32) / 4;
  const uint64_t da = hopper::desc_sw128(sa + wgi * 64 * 128, 16, 1024);
  const uint64_t db = hopper::desc_sw128(sb, 16, 1024);
  float facc[64];
  if (W8A8) {
    int iacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) iacc[i] = 0;
    hopper::wgmma_fence();
    hopper::wgmma_m64n128k32_s8(iacc, da, db, 0);
    hopper::wgmma_m64n128k32_s8(iacc, da + 2, db + 2, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(iacc);
    // acc = 0 + float(i32) * x_scale(row): qmm_kernel's fold of its one group; float(i32) as
    // 1.5 * 2^23 + i32 less 1.5 * 2^23, exact for |i32| < 2^22 (|i32| <= 64 * 127 * 128 here)
    // and two full-rate instructions against the quarter-rate conversion
    const float xs0 = sxs[wgi * 64 + warp * 16 + g], xs1 = sxs[wgi * 64 + warp * 16 + g + 8];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float a = __fsub_rn(__int_as_float(0x4B400000 + iacc[i]), 12582912.f);
      facc[i] = __fadd_rn(0.f, __fmul_rn(a, (i % 4) < 2 ? xs0 : xs1));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) facc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n128k16_bf16_ss(facc, da + 2 * kk, db + 2 * kk, kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(facc);
  }
  __syncthreads();  // both warpgroups' products are done: A and B become the staging tiles
  wg::epilogue_store<EPI>(facc, p, m0, n0, base + wgi * wg::OUT_TILE);
}

template <bool W8A8, int EPI>
cudaError_t launch_one(const QmmArgs& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(qmm_k64_kernel<W8A8, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  qmm_k64_kernel<W8A8, EPI><<<grid, THREADS, SMEM, st>>>(p);
  return cudaGetLastError();
}

template <bool W8A8>
cudaError_t launch_mode(int epilogue, const QmmArgs& p, cudaStream_t st) {
  switch (epilogue) {
    case EPI_BIAS: return launch_one<W8A8, EPI_BIAS>(p, st);
    case EPI_GELU: return launch_one<W8A8, EPI_GELU>(p, st);
    case EPI_QKV: return launch_one<W8A8, EPI_QKV>(p, st);
    case EPI_GATE: return launch_one<W8A8, EPI_GATE>(p, st);
    case EPI_GELU_GATE: return launch_one<W8A8, EPI_GELU_GATE>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch(bool w8a8, int epilogue, const QmmArgs& p, cudaStream_t st) {
  if (p.M < 1 || p.K < 16 || p.K > KMAX || p.K % 16 || p.N < BN || p.N % BN)
    return cudaErrorInvalidValue;
  return w8a8 ? launch_mode<true>(epilogue, p, st) : launch_mode<false>(epilogue, p, st);
}

}  // namespace k64

template <bool W8A8, bool LN>
cudaError_t launch(int epilogue, const QmmArgs& p, cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  switch (epilogue) {
    case EPI_BIAS: qmm_kernel<W8A8, EPI_BIAS, LN><<<grid, NTHREADS, 0, st>>>(p); break;
    case EPI_GELU: qmm_kernel<W8A8, EPI_GELU, LN><<<grid, NTHREADS, 0, st>>>(p); break;
    case EPI_QKV: qmm_kernel<W8A8, EPI_QKV, LN><<<grid, NTHREADS, 0, st>>>(p); break;
    case EPI_GATE: qmm_kernel<W8A8, EPI_GATE, LN><<<grid, NTHREADS, 0, st>>>(p); break;
    case EPI_GELU_GATE: qmm_kernel<W8A8, EPI_GELU_GATE, LN><<<grid, NTHREADS, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (fp32 if x_fp32, else bf16) -> stats fp32 [M, 2]: each row's (mean, rstd).  warp != 0
// takes ln_stats_warp_kernel (bf16 x, 16-byte aligned, K a multiple of 8 and at most 3072), else
// ln_stats_kernel.  Returns cudaGetLastError().
extern "C" int qmm_ln_stats(const void* x, int x_fp32, int M, int K, float* stats, int warp,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp)
    return static_cast<int>(
        x_fp32 ? cudaErrorInvalidValue
               : launch_ln_rows<false>(static_cast<const __nv_bfloat16*>(x), M, K, stats,
                                       nullptr, 0, nullptr, st));
  if (x_fp32)
    ln_stats_kernel<float><<<M, 256, 0, st>>>(static_cast<const float*>(x), K, stats);
  else
    ln_stats_kernel<__nv_bfloat16><<<M, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x), K,
                                                       stats);
  return static_cast<int>(cudaGetLastError());
}

// The weight-only LN + adaLN prologue as a pass: x bf16 [M, K] -> out bf16 [M, K] = bf16(ln_mod(x))
// with ab fp32 [8, K] (rows >= boundary take the cond rows); x, ab and out 16-byte aligned, K a
// multiple of 8.  stats_given = 0: ln_mod_pass_kernel computes each row's (mean, rstd) itself
// (K at most 3072) and writes them to stats fp32 [M, 2]; else ln_mod_apply_kernel reads them
// there.  Returns cudaGetLastError().
extern "C" int qmm_ln_mod_pass(const void* x, int M, int K, float* stats, int stats_given,
                               const float* ab, int boundary, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (K % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (!stats_given)
    return static_cast<int>(launch_ln_rows<true>(xb, M, K, stats, ab, boundary, ob, st));
  ln_mod_apply_kernel<<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(xb, M, K, stats, ab,
                                                                           boundary, ob);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [M, K] -> xq int8 [M, n_groups * group], xs fp32 [M, n_groups]; with ab (fp32
// [8, K]) and stats (fp32 [M, 2]) the LN + adaLN prologue's value is quantized instead.  warp != 0
// takes act_quant_warp_kernel (K and group multiples of 8, group <= 3072, x and ab 16-byte
// aligned), else act_quant_block_kernel.  Returns cudaGetLastError().
extern "C" int qmm_act_quant(const void* x, int M, int K, int group, int n_groups, void* xq,
                             float* xs, const float* stats, const float* ab, int boundary,
                             int warp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  if (ab != nullptr && stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (warp) {
    if (K % 8 || group % 8 || group > 3072) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        ab ? launch_act_quant_warp<true>(xb, M, K, group, n_groups, q, xs, stats, ab, boundary, st)
           : launch_act_quant_warp<false>(xb, M, K, group, n_groups, q, xs, nullptr, nullptr, 0,
                                          st));
  }
  const dim3 grid(n_groups, M);
  if (ab)
    act_quant_block_kernel<true><<<grid, 256, 0, st>>>(xb, K, group, n_groups, q, xs, stats, ab,
                                                       boundary);
  else
    act_quant_block_kernel<false><<<grid, 256, 0, st>>>(xb, K, group, n_groups, q, xs, nullptr,
                                                        nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

namespace {

QmmArgs make_args(const void* a, const float* xs, const void* w, const float* scale,
                  const float* bias, const float* norm_w, const float* ab, const float* stats,
                  const void* resid, const float* gate, void* out, int M, int K, int Kp, int N,
                  int group, int n_groups, int head_dim, int plane_h, int boundary) {
  QmmArgs p;
  p.a = static_cast<const uint8_t*>(a);
  p.xs = xs;
  p.w = static_cast<const uint8_t*>(w);
  p.scale = scale;
  p.bias = bias;
  p.norm_w = norm_w;
  p.ab = ab;
  p.stats = stats;
  p.resid = static_cast<const __nv_bfloat16*>(resid);
  p.gate = gate;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.Kp = Kp;
  p.N = N;
  p.group = group;
  p.n_groups = n_groups;
  p.head_dim = head_dim;
  p.plane_h = plane_h;
  p.boundary = boundary;
  p.prep_b = 1;
  return p;
}

bool gated_ok(int epilogue, const void* resid, const float* gate) {
  const bool gated = epilogue == EPI_GATE || epilogue == EPI_GELU_GATE;
  return gated == (resid != nullptr && gate != nullptr);
}

}  // namespace

// a: W8A8 int8 [M, Kp] (with xs) or bf16 [M, K]; w: int8 [K, N] at block blk; out bf16.
// epilogue 0: scale (+bias); 1: scale (+bias) + gelu_tanh; 2: fused qkv into [3, M, plane_h];
// 3 / 4: as 0 / 1, then out = resid + g_seg * z.  ab + stats (weight-only only): the LN + adaLN
// prologue on the A tile.  Rows >= boundary take the cond rows of ab and gate.
extern "C" int qmm_gemm(int w8a8, int epilogue, const void* a, const float* xs, const void* w,
                        const float* scale, const float* bias, const float* norm_w,
                        const float* ab, const float* stats, const void* resid,
                        const float* gate, void* out, int M, int K, int Kp, int N, int group,
                        int n_groups, int head_dim, int plane_h, int boundary, void* stream) {
  const QmmArgs p = make_args(a, xs, w, scale, bias, norm_w, ab, stats, resid, gate, out, M, K,
                              Kp, N, group, n_groups, head_dim, plane_h, boundary);
  if ((ab != nullptr) != (stats != nullptr) || (w8a8 && ab != nullptr) ||
      !gated_ok(epilogue, resid, gate))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w8a8)
    err = launch<true, false>(epilogue, p, st);
  else
    err = ab ? launch<false, true>(epilogue, p, st) : launch<false, false>(epilogue, p, st);
  return static_cast<int>(err);
}

// The W8A8 GEMM on wgmma: the arguments of qmm_gemm in W8A8 mode (a int8 [M, Kp], 16-byte
// aligned rows and base), the weight K-major: w int8 [N, K] (the [K, N] weight's transpose in
// memory, 16-byte aligned).  Takes Kp and group multiples of 128, K >= 128 a multiple of 16 and
// N >= 128 (a multiple of 16); anything else returns cudaErrorInvalidValue.
extern "C" int qmm_gemm_wgmma(int epilogue, const void* a, const float* xs, const void* w,
                              const float* scale, const float* bias, const float* norm_w,
                              const void* resid, const float* gate, void* out, int M, int K,
                              int Kp, int N, int group, int n_groups, int head_dim, int plane_h,
                              int boundary, void* stream) {
  if (!gated_ok(epilogue, resid, gate)) return static_cast<int>(cudaErrorInvalidValue);
  const QmmArgs p = make_args(a, xs, w, scale, bias, norm_w, nullptr, nullptr, resid, gate, out,
                              M, K, Kp, N, group, n_groups, head_dim, plane_h, boundary);
  return static_cast<int>(wg::launch(epilogue, p, static_cast<cudaStream_t>(stream)));
}

// The weight-only GEMM on bf16 wgmma: the arguments of qmm_gemm in weight-only mode without the
// prologue (x bf16 [M, K], 16-byte aligned base; w int8 [K, N]).  Takes K a multiple of 128 and
// N >= 128 (a multiple of 16); anything else returns cudaErrorInvalidValue.  widen = 0 leaves
// the weight fragments unwidened (wrong results): it measures what the widening costs.
extern "C" int qmm_gemm_bf16_wgmma(int epilogue, const void* x, const void* w, const float* scale,
                                   const float* bias, const float* norm_w, const void* resid,
                                   const float* gate, void* out, int M, int K, int N,
                                   int head_dim, int plane_h, int boundary, int widen,
                                   void* stream) {
  if (!gated_ok(epilogue, resid, gate)) return static_cast<int>(cudaErrorInvalidValue);
  QmmArgs p = make_args(x, nullptr, w, scale, bias, norm_w, nullptr, nullptr, resid, gate, out, M,
                        K, K, N, 0, 0, head_dim, plane_h, boundary);
  p.prep_b = widen;
  return static_cast<int>(wg::wo::launch(epilogue, p, static_cast<cudaStream_t>(stream)));
}

// The flat GEMM at N below one 128 tile, split K over a thread-block cluster: the arguments of
// qmm_gemm without the fused-qkv planes and the prologue (W8A8: a int8 [M, Kp] with xs; weight-
// only: x bf16 [M, K]; 16-byte aligned bases, w int8 [K, N]), plus `splitk_plan`'s cluster size
// (1..8, dividing 64), slice of K a block (W8A8: of Kp; whole 128-byte panels, inside one
// activation group) and rows a block (64).  Takes N 16..128 a multiple of 16 and cluster *
// slice_k = K (W8A8: Kp); anything else returns cudaErrorInvalidValue.
extern "C" int qmm_gemm_splitk(int w8a8, int epilogue, const void* a, const float* xs,
                               const void* w, const float* scale, const float* bias,
                               const void* resid, const float* gate, void* out, int M, int K,
                               int Kp, int N, int group, int n_groups, int boundary, int cluster,
                               int slice_k, int rows, void* stream) {
  if (!gated_ok(epilogue, resid, gate) || (w8a8 && xs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const QmmArgs p = make_args(a, xs, w, scale, bias, nullptr, nullptr, nullptr, resid, gate, out,
                              M, K, Kp, N, group, n_groups, 0, 0, boundary);
  return static_cast<int>(
      sk::launch(w8a8 != 0, epilogue, p, cluster, slice_k, rows, static_cast<cudaStream_t>(stream)));
}

// The flat GEMM at K of one 64-wide panel: x bf16 [M, K] in both modes (W8A8 quantizes it in the
// kernel, one x_scale a row: the activation group of `flat_w8a8_group`, group = padded K), 16-
// byte aligned base; w int8 [K, N]; the epilogues of qmm_gemm.  Takes K 16..64 a multiple of 16
// and N a multiple of 128; anything else returns cudaErrorInvalidValue.
extern "C" int qmm_gemm_k64(int w8a8, int epilogue, const void* x, const void* w,
                            const float* scale, const float* bias, const float* norm_w,
                            const void* resid, const float* gate, void* out, int M, int K, int N,
                            int head_dim, int plane_h, int boundary, void* stream) {
  if (!gated_ok(epilogue, resid, gate)) return static_cast<int>(cudaErrorInvalidValue);
  const QmmArgs p = make_args(x, nullptr, w, scale, bias, norm_w, nullptr, nullptr, resid, gate,
                              out, M, K, K, N, 0, 0, head_dim, plane_h, boundary);
  return static_cast<int>(k64::launch(w8a8 != 0, epilogue, p, static_cast<cudaStream_t>(stream)));
}
