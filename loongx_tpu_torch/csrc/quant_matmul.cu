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
//   * weight-only: int8 weights widened to bf16 (exact for -128..127) in shared memory,
//     mma.sync m16n8k16 bf16 with fp32 accumulation.
// Epilogues (fp32, then one cast to bf16): z = acc * scale (+ bias); optionally gelu_tanh; or
// the fused-qkv form, per-head RMS (eps 1e-6) times the norm weights on the q and k planes,
// written into a [3, M, H] output.
//
// What bounds it on this card: at the FLUX shapes (M 2048-2560, K 3072/12288, N 3072-18432)
// each call does 2*M*K*N operations against K*N weight bytes: ~2000 int8 op/byte, far above
// the ridge, so it is bound by tensor-core operations; the modulation matvecs (M = 2) are
// bound by the weight bytes.  Design, kept simple: 128x128 output tiles, 8 warps of 64x32,
// k tiles of 64 bytes double-buffered in shared memory (x by cp.async, the weight through
// registers because mma needs it k-major: each thread transposes 4x4 int8 blocks with
// byte_perm).  No wgmma/TMA pipeline yet; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;
constexpr int NTHREADS = 256;
constexpr int TILE_BYTES = 64;  // k bytes per tile row: 64 int8 or 32 bf16
constexpr int RS = 80;          // shared row stride in bytes (64 + 16 pad)

enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_QKV = 2 };

struct QmmArgs {
  const uint8_t* a;     // W8A8: int8 [M, Kp]; weight-only: bf16 [M, K]
  const float* xs;      // W8A8: fp32 [M, n_groups]
  const uint8_t* w;     // int8 [K, N] (block already offset)
  const float* scale;   // fp32 [N]
  const float* bias;    // fp32 [N] or null
  const float* norm_w;  // fp32 [3, H] (EPI_QKV)
  __nv_bfloat16* out;   // [M, N] or [3, M, H]
  int M, K, Kp, N, group, n_groups, head_dim, plane_h;
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
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

template <bool W8A8, int EPI>
__global__ void __launch_bounds__(NTHREADS) qmm_kernel(const QmmArgs p) {
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
  load_a<W8A8>(sa[0], p, m0, 0);
  load_b<W8A8>(breg, p, n0, 0);
  store_b<W8A8>(sb[0], breg);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
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
    if (more) store_b<W8A8>(sb[cur ^ 1], breg);
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
        float z0 = __fmul_rn(facc[mt][nt][2 * h], s0);
        float z1 = __fmul_rn(facc[mt][nt][2 * h + 1], s1);
        if (p.bias) {
          z0 = __fadd_rn(z0, b0);
          z1 = __fadd_rn(z1, b1);
        }
        if (EPI == EPI_GELU) {
          z0 = gelu_tanh(z0);
          z1 = gelu_tanh(z1);
        }
        facc[mt][nt][2 * h] = z0;
        facc[mt][nt][2 * h + 1] = z1;
      }
  }

  if (EPI != EPI_QKV) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (row >= p.M) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          if (col >= p.N) continue;
          *reinterpret_cast<uint32_t*>(p.out + (long long)row * p.N + col) =
              pack_bf16(facc[mt][nt][2 * h], facc[mt][nt][2 * h + 1]);
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
      const float rstd = 1.f / sqrtf(tot / static_cast<float>(p.head_dim) + 1e-6f);
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

// One block per (group, row): x_scale = absmax/127 (1 when absmax == 0) and
// q = clip(rint(x / x_scale), -127, 127); zero past K up to n_groups * group.
__global__ void __launch_bounds__(256)
act_quant_kernel(const __nv_bfloat16* __restrict__ x, int K, int group, int n_groups,
                 int8_t* __restrict__ xq, float* __restrict__ xs) {
  __shared__ float wmax[8];
  const int m = blockIdx.y, gi = blockIdx.x, k0 = gi * group;
  const __nv_bfloat16* row = x + (long long)m * K;
  float amax = 0.f;
  for (int j = threadIdx.x; j < group; j += blockDim.x) {
    const int k = k0 + j;
    if (k < K) amax = fmaxf(amax, fabsf(__bfloat162float(row[k])));
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
    const float v = k < K ? __bfloat162float(row[k]) : 0.f;
    const float q = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
    qrow[j] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) xs[(long long)m * n_groups + gi] = scale;
}

template <bool W8A8>
cudaError_t launch(int epilogue, const QmmArgs& p, cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  switch (epilogue) {
    case EPI_BIAS: qmm_kernel<W8A8, EPI_BIAS><<<grid, NTHREADS, 0, st>>>(p); break;
    case EPI_GELU: qmm_kernel<W8A8, EPI_GELU><<<grid, NTHREADS, 0, st>>>(p); break;
    case EPI_QKV: qmm_kernel<W8A8, EPI_QKV><<<grid, NTHREADS, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] -> xq int8 [M, n_groups * group], xs fp32 [M, n_groups].
extern "C" int qmm_act_quant(const void* x, int M, int K, int group, int n_groups, void* xq,
                             float* xs, void* stream) {
  const dim3 grid(n_groups, M);
  act_quant_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), K, group, n_groups, static_cast<int8_t*>(xq), xs);
  return static_cast<int>(cudaGetLastError());
}

// a: W8A8 int8 [M, Kp] (with xs) or bf16 [M, K]; w: int8 [K, N] at block blk; out bf16.
// epilogue 0: scale (+bias); 1: scale (+bias) + gelu_tanh; 2: fused qkv into [3, M, plane_h].
extern "C" int qmm_gemm(int w8a8, int epilogue, const void* a, const float* xs, const void* w,
                        const float* scale, const float* bias, const float* norm_w, void* out,
                        int M, int K, int Kp, int N, int group, int n_groups, int head_dim,
                        int plane_h, void* stream) {
  QmmArgs p;
  p.a = static_cast<const uint8_t*>(a);
  p.xs = xs;
  p.w = static_cast<const uint8_t*>(w);
  p.scale = scale;
  p.bias = bias;
  p.norm_w = norm_w;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.Kp = Kp;
  p.N = N;
  p.group = group;
  p.n_groups = n_groups;
  p.head_dim = head_dim;
  p.plane_h = plane_h;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = w8a8 ? launch<true>(epilogue, p, st) : launch<false>(epilogue, p, st);
  return static_cast<int>(err);
}
