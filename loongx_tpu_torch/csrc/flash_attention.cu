// Flash attention for the unified [txt | img | cond] sequence, Hopper (sm_90a): the forward
// and the two backward passes.
//
// Forward: replaces the TPU kernel loongx_tpu/ops/flash_attention.py::_fwd_kernel (launched
// by _flash_fwd, pallas_call at :512): exact softmax attention with an fp32 online softmax,
// block masks built from the scalar cond_start (union / no_union / independent), an
// additive log(c_factor) bias that replaces the masks, padded keys masked, and
// interleaved-pair RoPE applied to q and k as their tiles load.  With save_residuals it
// also writes the per-row softmax statistics the backward rebuilds P from, in base 2:
//   m2[b, h, i] = max_j s2_ij,  l[b, h, i] = sum_j 2^(s2_ij - m2_i),
//   s2_ij = (q_i . k_j) * (scale * log2 e)  (masked: MASK_VALUE),
// so P_ij = 2^(s2_ij - m2_i) / l_i.  The TPU kernel's natural-base m is m2 / log2 e; its l
// is the same sum.
//
// int8 QK^T mode (serving only; the TPU kernel's int8_qk path, flash_attention.py:228-291):
// the scores are (q_codes . k_codes) * (q_scale[row] * k_scale[span]), s8 x s8 -> s32, then the
// same fp32 softmax and bf16 P.V.  Codes follow the TPU kernel's _quant: sc = absmax / 127 (1
// when absmax is 0, IEEE division), code = clip(rint(x / sc), -127, 127), taken after RoPE and
// its rounding to bf16.  The k scale spans the TPU kernel's key tile block_k (the whole padded
// row at every FLUX length), wider than any block's view here, so a pre-pass of two small
// kernels (kquant_max_kernel, kquant_codes_kernel below) writes k's codes, head-major
// [B, H, S, D] int8, and one fp32 scale per span first.  At head_dim 128 (every FLUX shape) the
// forward runs on wgmma (flash_fwd_int8_wgmma_kernel, "Forward on wgmma"), and the pre-pass
// writes q's codes and per-row scales too; this mma.sync kernel (flash_fwd_kernel<D, true>, on
// mma.sync m16n8k32) keeps head_dim 64 and spans that split a 128-key tile, and quantizes each
// q row as its tile loads.  flash_int8_route in Python picks the kernel.
//
// What bounds it on this card: at the FLUX shapes (S = 2560 or 8704, D = 128, 24 heads) the
// two matmuls are 4*S*S*D flops per head, about 80 GFLOP at S = 2560 against ~80 MB of
// q/k/v/o, far above the bf16 ridge (~295 flop/byte): it is bound by tensor-core operations.
// Design: one block of 8 warps per (q tile of 128 rows, head, batch); each warp owns 16 query
// rows and runs mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the Q fragments, the
// scores, P and the output accumulator all in registers (P's C fragment is reused as the A
// fragment of the PV product, so the scores never touch shared memory).  K and V tiles of 64
// keys go through shared memory, shared by the 8 warps; RoPE is applied to each K tile as it
// is stored, so a K tile and its cos/sin rows are read and rotated once per 128 query rows.
// The B fragments come out of shared memory by ldmatrix (.trans for V).  The softmax runs in
// base 2 (scores prescaled by log2 e).  q/k/v/o are read and written through strides, so the
// [B, S, H, D] projection layout needs no transpose.  Loads are plain (no cp.async/TMA
// pipeline, no wgmma): two blocks per SM hide part of the latency.  This kernel keeps head_dim
// 64 in both score modes; at head_dim 128 (every FLUX shape) the forward runs
// flash_fwd_wgmma_kernel below ("Forward on wgmma"), chosen by flash_fwd_route and
// flash_int8_route in Python.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "quant8.cuh"

namespace {

constexpr int BQ = 128;       // query rows per block (8 warps x 16)
constexpr int BKV = 64;       // keys per iteration
constexpr int NTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PAD = 8;        // bf16 elements of row padding in shared memory
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

enum Mode { UNION = 0, NO_UNION = 1, INDEPENDENT = 2, CFACTOR = 3 };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
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

// Four 8x8 bf16 matrices from shared memory; lanes 8j..8j+7 give the row addresses of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Load rows [r0, r0 + ROWS) of one head into shared memory (row stride D + PAD), zero past S,
// rotating interleaved pairs when cos/sin are given:
//   out[2i] = x[2i] cos[2i] - x[2i+1] sin[2i],  out[2i+1] = x[2i+1] cos[2i+1] + x[2i] sin[2i+1]
// in fp32 with separate roundings (no fma contraction), then rounded to bf16.
// Eight bf16 values at columns c8.. of row s (raw), rotated by that row's cos/sin when given.
template <int D>
__device__ __forceinline__ uint4 rope8(uint4 raw, const float* cos, const float* sin, int s,
                                       int c8) {
  if (cos == nullptr) return raw;
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  const float4* c4 = reinterpret_cast<const float4*>(cos + (long long)s * D + c8);
  const float4* s4 = reinterpret_cast<const float4*>(sin + (long long)s * D + c8);
  const float4 ca = __ldg(c4), cb = __ldg(c4 + 1), sa = __ldg(s4), sb = __ldg(s4 + 1);
  const float cp[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
  const float sp[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  float out[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x0 = __bfloat162float(x[2 * j]), x1 = __bfloat162float(x[2 * j + 1]);
    out[2 * j] = __fadd_rn(__fmul_rn(x0, cp[2 * j]), __fmul_rn(-x1, sp[2 * j]));
    out[2 * j + 1] = __fadd_rn(__fmul_rn(x1, cp[2 * j + 1]), __fmul_rn(x0, sp[2 * j + 1]));
  }
  return make_uint4(pack_bf16(out[0], out[1]), pack_bf16(out[2], out[3]),
                    pack_bf16(out[4], out[5]), pack_bf16(out[6], out[7]));
}

template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* base,
                                          long long ss, int r0, int S, const float* cos,
                                          const float* sin) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NT) {
    const int r = c / CHUNKS, c8 = (c % CHUNKS) * 8;
    const int s = r0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (s < S) raw = rope8<D>(*reinterpret_cast<const uint4*>(base + (long long)s * ss + c8),
                              cos, sin, s, c8);
    *reinterpret_cast<uint4*>(smem + r * (D + PAD) + c8) = raw;
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int PAD8 = 16;  // bytes of row padding of an int8 K tile in shared memory

// int8 codes of rows [r0, r0 + ROWS) of one head ([S, D] row-major) into shared memory (row
// stride D + PAD8 bytes), zero past S.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_codes(int8_t* smem, const int8_t* base, int r0, int S) {
  constexpr int CHUNKS = D / 16;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NT) {
    const int r = c / CHUNKS, c16 = (c % CHUNKS) * 16;
    const int s = r0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (s < S) raw = *reinterpret_cast<const uint4*>(base + (long long)s * D + c16);
    *reinterpret_cast<uint4*>(smem + r * (D + PAD8) + c16) = raw;
  }
}

// INT8 selects the int8 QK^T mode: kq / kscale are the pre-pass's codes [B, H, S, D] and
// scales [B, H, nspan] (k is unused); otherwise kq / kscale are unused.
template <int D, bool INT8>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const int8_t* __restrict__ kq, const float* __restrict__ kscale,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 const float* __restrict__ cos, const float* __restrict__ sin,
                 float* __restrict__ m_out, float* __restrict__ l_out, int H, int S,
                 long long sb, long long ss, long long sh, int cond_start, int mode,
                 float cbias, float scale, int span, int nspan) {
  constexpr int LD = D + PAD;
  constexpr int LD8 = D + PAD8;
  __shared__ __align__(16) __nv_bfloat16 smem[2 * BKV * LD];  // K | V tiles, or the Q tile
  __nv_bfloat16* ks = smem;
  int8_t* k8 = reinterpret_cast<int8_t*>(smem);  // the int8 K tile (fits the K half)
  __nv_bfloat16* vs = smem + BKV * LD;
  static_assert(BKV * (D + PAD8) <= BKV * LD * 2, "the int8 K tile fits the K buffer");
  constexpr int KSTEPS = D / 16;   // k-steps of the QK^T product
  constexpr int KSTEPS8 = D / 32;  // k-steps of the int8 QK^T product
  constexpr int DTILES = D / 8;    // n-tiles of the output

  const int q0 = blockIdx.x * BQ;
  const long long head = (long long)blockIdx.z * sb + (long long)blockIdx.y * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: this lane's matrix and row
  const int wr = warp * 16;  // first row of this warp inside the tile
  const float scale_log2 = scale * LOG2E, cbias_log2 = cbias * LOG2E;  // base-2 softmax

  // Q tile (rotated) -> registers, staged through the K|V buffer.
  static_assert(BQ == 2 * BKV, "the Q tile is staged in the K and V buffers");
  load_tile<D, BQ, NTHREADS>(smem, q + head, ss, q0, S, cos, sin);
  __syncthreads();
  uint32_t qf[INT8 ? 1 : KSTEPS][4];    // bf16 A fragments
  uint32_t qf8[INT8 ? KSTEPS8 : 1][4];  // int8 A fragments
  float qsc[2] = {1.f, 1.f};            // int8: the scales of rows g and g + 8
  if constexpr (INT8) {
    // per-row absmax of this warp's 16 rows, then codes straight into the fragments:
    // a0 (row g, cols 4t..), a1 (row g + 8), a2 (row g, cols 16 + 4t..), a3 (row g + 8)
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
      float a = 0.f;
      for (int c = lane; c < D; c += 32)
        a = fmaxf(a, fabsf(__bfloat162float(ks[(wr + r) * LD + c])));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      if (r == g) qsc[0] = quant8::scale_of(a);
      if (r == g + 8) qsc[1] = quant8::scale_of(a);
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS8; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* x = ks + (wr + g + 8 * (j % 2)) * LD + kk * 32 + 16 * (j / 2) + 4 * t;
        const float sc = qsc[j % 2];
        qf8[kk][j] = pack4(quant8::code_div(__bfloat162float(x[0]), sc),
                           quant8::code_div(__bfloat162float(x[1]), sc),
                           quant8::code_div(__bfloat162float(x[2]), sc),
                           quant8::code_div(__bfloat162float(x[3]), sc));
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(ks + (wr + g) * LD + c);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(ks + (wr + g + 8) * LD + c);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(ks + (wr + g) * LD + c + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(ks + (wr + g + 8) * LD + c + 8);
    }
  }
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_id[2] = {q0 + wr + g, q0 + wr + g + 8};
  const bool row_cond[2] = {row_id[0] >= cond_start, row_id[1] >= cond_start};

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous K/V (or Q) tile
    if constexpr (INT8) {
      load_codes<D, BKV, NTHREADS>(k8, kq + bh * S * D, kv0, S);
    } else {
      load_tile<D, BKV, NTHREADS>(ks, k + head, ss, kv0, S, cos, sin);
    }
    load_tile<D, BKV, NTHREADS>(vs, v + head, ss, kv0, S, nullptr, nullptr);
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[BKV / 8][4];
    if constexpr (INT8) {
      // a 64-key tile lies inside one span (span is a multiple of 64)
      const float ksc = kscale[bh * nspan + kv0 / span];
      const float qk[2] = {qsc[0] * ksc, qsc[1] * ksc};
#pragma unroll
      for (int nn = 0; nn < BKV / 8; ++nn) {
        int acc8[4] = {0, 0, 0, 0};
        // B fragment: key nn*8 + g, bytes kk*32 + 4t.. (b0) and kk*32 + 16 + 4t.. (b1)
        const int8_t* krow = k8 + (nn * 8 + g) * LD8 + 4 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS8; ++kk)
          mma_s8(acc8, qf8[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 32),
                 *reinterpret_cast<const uint32_t*>(krow + kk * 32 + 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nn][e] = __fmul_rn(static_cast<float>(acc8[e]), qk[e / 2]);
      }
    } else {
#pragma unroll
      for (int nn = 0; nn < BKV / 8; ++nn) {
        sc[nn][0] = sc[nn][1] = sc[nn][2] = sc[nn][3] = 0.f;
        // matrices: keys nn*8.., d columns kk*16 + {0, 8, 16, 24} -> (b0, b1) of kk and kk + 1
        const __nv_bfloat16* kaddr = ks + (nn * 8 + mr) * LD + (mi % 2) * 8 + (mi / 2) * 16;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; kk += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kaddr + kk * 16);
          mma_bf16(sc[nn], qf[kk], b[0], b[1]);
          mma_bf16(sc[nn], qf[kk + 1], b[2], b[3]);
        }
      }
    }

    // scale, padding mask, block masks / c_factor bias; row max
    float m_cur[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int nn = 0; nn < BKV / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int col = kv0 + nn * 8 + 2 * t + (e % 2);
        float s = sc[nn][e] * scale_log2;
        if (col >= S) s = MASK_VALUE;
        const bool col_cond = col >= cond_start;
        if (mode == CFACTOR) {
          s = s + (row_cond[r] != col_cond ? cbias_log2 : 0.f);
        } else if (mode == NO_UNION) {
          if (row_cond[r] != col_cond) s = MASK_VALUE;
        } else if (mode == INDEPENDENT) {
          if (row_cond[r] && !col_cond) s = MASK_VALUE;
        }
        sc[nn][e] = s;
        m_cur[r] = fmaxf(m_cur[r], s);
      }
    }
    float alpha[2], m_next[2], l_add[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      m_next[r] = fmaxf(m_run[r], m_cur[r]);
      alpha[r] = exp2f(m_run[r] - m_next[r]);
      m_run[r] = m_next[r];
    }
    // p = 2^(s - m) = exp of the unscaled difference; P (bf16) becomes the A fragment of the PV product
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int nn = 0; nn < BKV / 8; ++nn) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[nn][e] - m_next[e / 2]);
        l_add[e / 2] += p[e];
      }
      pf[nn / 2][(nn % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nn / 2][(nn % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_add[r] += __shfl_xor_sync(0xffffffffu, l_add[r], 1);
      l_add[r] += __shfl_xor_sync(0xffffffffu, l_add[r], 2);
      l_run[r] = l_run[r] * alpha[r] + l_add[r];
    }
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    // pf is indexed [k-step][reg] with regs ordered {row g lo, row g+8 lo, row g hi, row g+8 hi}
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pf[kk][0], pf[kk][1], pf[kk][2], pf[kk][3]};
      // matrices (transposed): keys kk*16 + {0, 8}, d columns dn*8 and (dn+1)*8
      const __nv_bfloat16* vaddr = vs + (kk * 16 + (mi % 2) * 8 + mr) * LD + (mi / 2) * 8;
#pragma unroll
      for (int dn = 0; dn < DTILES; dn += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vaddr + dn * 8);
        mma_bf16(acc[dn], a, b[0], b[1]);
        mma_bf16(acc[dn + 1], a, b[2], b[3]);
      }
    }
  }

  // normalise (l == 0 guarded like the TPU kernel) and store; the residuals are the row's
  // running max and sum, reduced over the quad, written once per row
  const long long stat = bh * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_id[r] >= S) continue;
    if (m_out != nullptr && t == 0) {
      m_out[stat + row_id[r]] = m_run[r];
      l_out[stat + row_id[r]] = l_run[r];
    }
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* orow = o + head + (long long)row_id[r] * ss;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      const int c = dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + c) =
          pack_bf16(acc[dn][2 * r] / l, acc[dn][2 * r + 1] / l);
    }
  }
}

// The int8 mode's pre-pass (flash_kquant), two kernels of one block per 64 rows of one head.
// kquant_max_kernel: the absmax of the block's rotated, bf16-rounded keys into kmax[b, h, block]
// (no atomics, so no buffer to clear first); with q (the wgmma route, blockIdx.z >= B) it also
// writes q's codes [B, H, S, D] and per-row scales [B, H, S]: a row's absmax is a shuffle over the
// D / 8 neighbouring threads that load it.  kquant_codes_kernel: a span's scale from its blocks'
// absmaxes (the block that starts the span writes it), then k rotated again (cheaper than a bf16
// round trip through memory) and its codes [B, H, S, D].  Codes are quant8::codes8's.  What
// bounds it: bytes (q and k read, k twice, the codes written); each element is read by one
// thread as part of a 16-byte load.  (Blocks of four heads that read each cos/sin row once
// for the four measured slower.)
constexpr int KQ_ROWS = 64;
constexpr int KQ_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(KQ_THREADS)
kquant_max_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  float* __restrict__ kmax, int8_t* __restrict__ qcodes,
                  float* __restrict__ qscale, int B, int H, int S, long long sb, long long ss,
                  long long sh) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
  __shared__ float wmax[KQ_THREADS / 32];
  const int r0 = blockIdx.x * KQ_ROWS, h = blockIdx.y, b = blockIdx.z % B;
  const bool is_q = blockIdx.z >= B;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* src = (is_q ? q : k) + (long long)b * sb + (long long)h * sh;
  float kabs = 0.f;
#pragma unroll
  for (int i = 0; i < KQ_ROWS * CHUNKS / KQ_THREADS; ++i) {
    const int c = threadIdx.x + i * KQ_THREADS;
    const int s = r0 + c / CHUNKS, c8 = (c % CHUNKS) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (s < S)
      raw = rope8<D>(*reinterpret_cast<const uint4*>(src + (long long)s * ss + c8), cos, sin, s,
                     c8);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float xf[8], a = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xf[j] = __bfloat162float(x[j]);
      a = fmaxf(a, fabsf(xf[j]));
    }
    if (!is_q) {
      kabs = fmaxf(kabs, a);
      continue;
    }
#pragma unroll
    for (int off = CHUNKS / 2; off > 0; off >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    const float sc = quant8::scale_of(a);
    const uint2 codes = quant8::codes8(xf, sc, __frcp_rn(sc));
    if (s < S) {
      *reinterpret_cast<uint2*>(qcodes + (bh * S + s) * D + c8) = codes;
      if (c8 == 0) qscale[bh * S + s] = sc;
    }
  }
  if (is_q) return;  // uniform over the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    kabs = fmaxf(kabs, __shfl_xor_sync(0xffffffffu, kabs, off));
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = kabs;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int w = 0; w < KQ_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
    kmax[bh * gridDim.x + blockIdx.x] = m;
  }
}

template <int D>
__global__ void __launch_bounds__(KQ_THREADS)
kquant_codes_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ cos,
                    const float* __restrict__ sin, const float* __restrict__ kmax,
                    int8_t* __restrict__ codes, float* __restrict__ scales, int H, int S,
                    long long sb, long long ss, long long sh, int span, int nspan) {
  constexpr int CHUNKS = D / 8;
  __shared__ float span_sc;
  const int r0 = blockIdx.x * KQ_ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const int sp = r0 / span, per_span = span / KQ_ROWS;
  if (threadIdx.x < 32) {
    const float* m = kmax + bh * gridDim.x;
    const int first = sp * per_span, last = min(first + per_span, (int)gridDim.x);
    float a = 0.f;
    for (int i = first + threadIdx.x; i < last; i += 32) a = fmaxf(a, m[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (threadIdx.x == 0) {
      span_sc = quant8::scale_of(a);
      if (r0 % span == 0) scales[bh * nspan + sp] = span_sc;
    }
  }
  __syncthreads();
  const float sc = span_sc, rc = __frcp_rn(sc);
  const __nv_bfloat16* src = k + (long long)b * sb + (long long)h * sh;
#pragma unroll
  for (int i = 0; i < KQ_ROWS * CHUNKS / KQ_THREADS; ++i) {
    const int c = threadIdx.x + i * KQ_THREADS;
    const int s = r0 + c / CHUNKS, c8 = (c % CHUNKS) * 8;
    if (s >= S) continue;
    const uint4 raw =
        rope8<D>(*reinterpret_cast<const uint4*>(src + (long long)s * ss + c8), cos, sin, s, c8);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float xf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) xf[j] = __bfloat162float(x[j]);
    *reinterpret_cast<uint2*>(codes + (bh * S + s) * D + c8) = quant8::codes8(xf, sc, rc);
  }
}

template <int D>
cudaError_t launch_kquant(const __nv_bfloat16* k, const __nv_bfloat16* q, const float* cos,
                          const float* sin, float* kmax, int8_t* codes, float* scales,
                          int8_t* qcodes, float* qscale, int B, int H, int S, long long sb,
                          long long ss, long long sh, int span, int nspan, cudaStream_t st) {
  const int blocks = (S + KQ_ROWS - 1) / KQ_ROWS;
  kquant_max_kernel<D><<<dim3(blocks, H, q ? 2 * B : B), KQ_THREADS, 0, st>>>(
      k, q, cos, sin, kmax, qcodes, qscale, B, H, S, sb, ss, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kquant_codes_kernel<D><<<dim3(blocks, H, B), KQ_THREADS, 0, st>>>(
      k, cos, sin, kmax, codes, scales, H, S, sb, ss, sh, span, nspan);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// Forward on wgmma (bf16 scores, D = 128): RoPE pre-pass + warp-specialised main kernel
// ---------------------------------------------------------------------------------------
//
// rope_prepass_kernel rotates q and k once per element (rope8: the in-kernel rotation above,
// fp32 with separate roundings, then bf16) into one head-major buffer [2, B, H, S, D]; without
// RoPE the main kernel reads q and k as they lie.  flash_fwd_wgmma_kernel: one block per 128
// query rows of one (batch, head); one producer thread loads the Q tile once and K and V tiles of
// 128 keys into a ring of STAGES by TMA (4-D tensor maps {D, S, H, B} over any strides, boxes of
// 64 d x 128 rows with the 128-byte swizzle, zeros past S); two consumer warpgroups own 64 query
// rows each: S = Q.K^T by wgmma m64n128k16 (both operands d-contiguous, K-major), the base-2
// online softmax of the mma.sync kernel in registers, P rounded to bf16 in registers as the A
// operand of O += P.V (wgmma with V as B through the transpose bit: V tiles lie key-major, d
// contiguous).  Key tiles that the block mask hides from every row of the block are skipped
// (no_union, independent): a skipped tile would contribute 2^(MASK_VALUE - m) = 0 exactly.
// Tiles that every row sees whole (tile_plain) skip the per-element mask: the row max is taken
// on the raw scores and each probability is one fma and one ex2.approx, which halves the
// softmax's instructions (it runs between the two products of each warpgroup, unoverlapped:
// a software-pipelined loop and ping-pong scheduling of the two warpgroups measured slower).
//
// The int8 QK^T mode on wgmma (flash_fwd_int8_wgmma_kernel; D = 128, every FLUX shape): the
// pre-pass (flash_attention_kquant with q) writes q's codes and per-row scales beside k's codes
// and span scales, all head-major [B, H, S, 128] int8, so one TMA box of 128 rows x 128 bytes
// (128-byte swizzle) is a whole Q or K tile, half a bf16 one: the ring holds four stages.
// S = Q_c.K_c^T runs on s8 wgmma m64n128k32 (four k-steps, both operands K-major as 8-bit wgmma
// requires) into an int32 fragment with the fp32 one's layout; each score is then
// __fmul_rn(float(acc), q_scale[row] * k_scale[span]), the mma.sync kernel's order (the int32
// sums are exact, |acc| <= 127^2 * 128 < 2^24, and the codes are the same, so the scores equal
// its scores bit for bit), and the softmax and bf16 P.V are the bf16 kernel's.  The S product
// takes half the bf16 one's tensor time; the softmax between the two products does not shrink.
// A 128-key tile lies in one span (span % 128 == 0: flash_int8_route in Python).
namespace fa3 {

constexpr int D = 128, BQ = 128, BKV = 128;
constexpr int PANEL = 128 * 128;  // bytes: 128 rows x 64 bf16 (or 128 int8), one TMA box
// warpgroups: two consumers and the producer (one thread issues TMA); entry registers
// 65536 / 384 = 168, then 240 for the consumers and 24 for the producer (2 x 72 = 144)
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128, ENTRY_REGS = 168;
constexpr int ROPE_ROWS = 64;

// Shared memory of the forward: the Q tile, then a ring of STAGES (K tile, V tile); a bf16 Q
// or K tile is two panels, an int8 one a single panel.
template <bool INT8>
struct FwdSmem {
  static constexpr int QK_PANELS = INT8 ? 1 : 2;
  static constexpr int STAGES = INT8 ? 4 : 3;
  static constexpr int BYTES =
      (QK_PANELS + (QK_PANELS + 2) * STAGES) * PANEL + (1 + 2 * STAGES) * 8 + 1024;
};

struct Args {
  __nv_bfloat16* o;
  float *m_out, *l_out;
  int H, S;
  long long sb, ss, sh;  // o's element strides (v's too)
  int cond_start, mode;
  float cbias, scale;
  // int8 mode: per-row q scales [B, H, S], per-span k scales [B, H, nspan]
  const float *qscale, *kscale;
  int span, nspan;
};

// Does key tile [kv0, kv0 + nk) hold a key that some query row of [q0, q0 + nq) attends to?
__device__ __forceinline__ bool tile_visible(int mode, int cs, int S, int q0, int nq, int kv0,
                                             int nk) {
  const bool rows_main = q0 < cs, rows_cond = q0 + nq > cs && cs < S;
  const bool cols_main = kv0 < cs, cols_cond = kv0 + nk > cs && cs < S;
  if (mode == NO_UNION) return (rows_main && cols_main) || (rows_cond && cols_cond);
  if (mode == INDEPENDENT) return rows_main || cols_cond;
  return true;
}

// Does every query row of [q0, q0 + nq) see every key of [kv0, kv0 + nk), with no bias (all
// keys real)?  Then the softmax needs no per-element mask.
__device__ __forceinline__ bool tile_plain(int mode, int cs, int S, int q0, int nq, int kv0,
                                           int nk) {
  if (kv0 + nk > S) return false;
  if (mode == UNION) return true;
  const bool rows_main = q0 + nq <= cs, rows_cond = q0 >= cs;
  const bool cols_main = kv0 + nk <= cs, cols_cond = kv0 >= cs;
  if (mode == INDEPENDENT) return rows_main || cols_cond;
  return (rows_main && cols_main) || (rows_cond && cols_cond);  // NO_UNION, CFACTOR
}

// 2^x by the MUFU unit (ex2.approx.ftz: results below 2^-126 flush to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(256)
rope_prepass_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    __nv_bfloat16* __restrict__ out, int B, int H, int S, long long sb,
                    long long ss, long long sh) {
  constexpr int CHUNKS = D / 8;
  const int r0 = blockIdx.x * ROPE_ROWS, h = blockIdx.y;
  const int which = blockIdx.z / B, b = blockIdx.z % B;
  const __nv_bfloat16* src = (which ? k : q) + (long long)b * sb + (long long)h * sh;
  __nv_bfloat16* dst = out + (((long long)which * B + b) * H + h) * (long long)S * D;
  for (int c = threadIdx.x; c < ROPE_ROWS * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS, c8 = (c % CHUNKS) * 8, s = r0 + r;
    if (s >= S) continue;
    *reinterpret_cast<uint4*>(dst + (long long)s * D + c8) =
        rope8<D>(*reinterpret_cast<const uint4*>(src + (long long)s * ss + c8), cos, sin, s, c8);
  }
}

// The body of both forward kernels (flash_fwd_wgmma_kernel, flash_fwd_int8_wgmma_kernel: two
// names, so that a profile tells them apart).
template <bool INT8>
__device__ __forceinline__ void fwd_wgmma_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                               const CUtensorMap& map_v, const Args& p) {
  using L = FwdSmem<INT8>;
  constexpr int STAGES = L::STAGES, QK = L::QK_PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                          // QK panels
  uint8_t* sk = base + QK * PANEL;             // STAGES x QK panels
  uint8_t* sv = sk + QK * STAGES * PANEL;      // STAGES x 2 panels
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sv + 2 * STAGES * PANEL);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, cs = p.cond_start, mode = p.mode;
  const int ntiles = (S + BKV - 1) / BKV;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
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
      // a bf16 tile is two 64-wide d panels; an int8 tile is one box of 128 bytes a row
      hopper::mbar_arrive_expect_tx(qfull, QK * PANEL);
      for (int i = 0; i < QK; ++i)
        hopper::tma_load_4d(sq + i * PANEL, &map_q, qfull, 64 * i, q0, h, b);
      int it = 0;
      for (int j = 0; j < ntiles; ++j) {
        if (!tile_visible(mode, cs, S, q0, BQ, j * BKV, BKV)) continue;
        const int s = it % STAGES;
        hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], (QK + 2) * PANEL);
        uint8_t* kt = sk + s * QK * PANEL;
        uint8_t* vt = sv + s * 2 * PANEL;
        for (int i = 0; i < QK; ++i)
          hopper::tma_load_4d(kt + i * PANEL, &map_k, &full[s], 64 * i, j * BKV, h, b);
        hopper::tma_load_4d(vt, &map_v, &full[s], 0, j * BKV, h, b);
        hopper::tma_load_4d(vt + PANEL, &map_v, &full[s], 64, j * BKV, h, b);
        ++it;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = p.scale * LOG2E, cbias_log2 = p.cbias * LOG2E;
  const int row_id[2] = {q0 + wgi * 64 + warp * 16 + g, q0 + wgi * 64 + warp * 16 + g + 8};
  const bool row_cond[2] = {row_id[0] >= cs, row_id[1] >= cs};

  float o[64], sc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const uint8_t* sq_wg = sq + wgi * 64 * 128;
  const long long bh = (long long)b * p.H + h, stat = bh * S;
  // int8: the q scales of rows g and g + 8
  float qsc[2] = {1.f, 1.f};
  if constexpr (INT8) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_id[r] < S) qsc[r] = p.qscale[stat + row_id[r]];
  }

  // S = Q K^T of the tile in stage s (key tile kv0) into sc, complete on return.  bf16: 8
  // k-steps of 16 d, 4 in each 64-wide panel.  int8: 4 k-steps of 32 d on s8 wgmma, then each
  // score float(acc) * (q_scale * k_scale) as the mma.sync kernel rounds it.
  auto scores = [&](int s, int kv0) {
    if constexpr (INT8) {
      const uint8_t* kt = sk + s * PANEL;
      const uint64_t dq = hopper::desc_sw128(sq_wg, 16, 1024);
      const uint64_t dk = hopper::desc_sw128(kt, 16, 1024);
      int si[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        hopper::wgmma_m64n128k32_s8(si, dq + 2 * kk, dk + 2 * kk, kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(si);
      const float ksc = p.kscale[bh * p.nspan + kv0 / p.span];
      const float qk[2] = {qsc[0] * ksc, qsc[1] * ksc};
      // float(acc) without the quarter-rate I2F: acc's bits added to those of 1.5 * 2^23 give
      // 1.5 * 2^23 + acc exactly (|acc| < 2^22), one subtraction leaves acc
#pragma unroll
      for (int i = 0; i < 64; ++i)
        sc[i] = __fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + si[i]), 12582912.f),
                          qk[(i % 4) / 2]);
    } else {
      const uint8_t* kt = sk + s * 2 * PANEL;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int panel = kk / 4, off = (kk % 4) * 32;
        const uint64_t dq = hopper::desc_sw128(sq_wg + panel * PANEL + off, 16, 1024);
        const uint64_t dk = hopper::desc_sw128(kt + panel * PANEL + off, 16, 1024);
        hopper::wgmma_m64n128k16_bf16_ss(sc, dq, dk, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);
    }
  };
  // O += P V of the tile in stage s: 8 k-steps of 16 keys; V's 64-wide d panels are PANEL
  // bytes apart
  auto issue_pv = [&](const uint32_t (&pf)[BKV / 16][4], int s) {
    const uint8_t* vt = sv + s * 2 * PANEL;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hopper::wgmma_m64n128k16_bf16_rs_tb(
          o, pf[kk], hopper::desc_sw128(vt + kk * 16 * 128, PANEL, 1024), 1);
    hopper::wgmma_commit();
  };
  // The online softmax of the scores of key tile kv0 (sc[4i + e]: row e / 2, key
  // kv0 + 8i + 2t + e % 2): scale, padding mask, block masks / c_factor bias, row max, P as
  // bf16 A fragments of the k-steps of 16 keys ({row g lo, row g+8 lo, row g hi, row g+8 hi});
  // returns the factor the running output must take before P V is added.
  auto softmax = [&](int kv0, uint32_t (&pf)[BKV / 16][4], float (&alpha)[2]) {
    float m_cur[2] = {MASK_VALUE, MASK_VALUE};
    // a plain tile keeps its raw scores: the row max scales after the max (rounding is
    // monotonic, so it is the max of the scaled scores) and the exponent is one fma
    const bool plain = tile_plain(mode, cs, S, q0, BQ, kv0, BKV);
    const float mul = plain ? scale_log2 : 1.f;
    if (plain) {
#pragma unroll
      for (int i = 0; i < 64; ++i) m_cur[(i % 4) / 2] = fmaxf(m_cur[(i % 4) / 2], sc[i]);
      m_cur[0] *= scale_log2;
      m_cur[1] *= scale_log2;
    } else
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i % 4) / 2;
      const int col = kv0 + (i / 4) * 8 + 2 * t + (i % 2);
      float v = sc[i] * scale_log2;
      if (col >= S) v = MASK_VALUE;
      const bool col_cond = col >= cs;
      if (mode == CFACTOR) {
        v = v + (row_cond[r] != col_cond ? cbias_log2 : 0.f);
      } else if (mode == NO_UNION) {
        if (row_cond[r] != col_cond) v = MASK_VALUE;
      } else if (mode == INDEPENDENT) {
        if (row_cond[r] && !col_cond) v = MASK_VALUE;
      }
      sc[i] = v;
      m_cur[r] = fmaxf(m_cur[r], v);
    }
    float m_next[2], l_add[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      m_next[r] = fmaxf(m_run[r], m_cur[r]);
      alpha[r] = exp2f(m_run[r] - m_next[r]);
      m_run[r] = m_next[r];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      float pv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pv[e] = fast_exp2(fmaf(sc[8 * kk + e], mul, -m_next[(e % 4) / 2]));
        l_add[(e % 4) / 2] += pv[e];
      }
      pf[kk][0] = pack_bf16(pv[0], pv[1]);
      pf[kk][1] = pack_bf16(pv[2], pv[3]);
      pf[kk][2] = pack_bf16(pv[4], pv[5]);
      pf[kk][3] = pack_bf16(pv[6], pv[7]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_add[r] += __shfl_xor_sync(0xffffffffu, l_add[r], 1);
      l_add[r] += __shfl_xor_sync(0xffffffffu, l_add[r], 2);
      l_run[r] = l_run[r] * alpha[r] + l_add[r];
    }
  };

  hopper::mbar_wait(qfull, 0);
  // per visible key tile: S = Q K^T, the softmax, O = alpha O + P V (the two consumer
  // warpgroups interleave on the tensor cores on their own)
  uint32_t pf[BKV / 16][4];
  float alpha[2];
  int it = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * BKV;
    if (!tile_visible(mode, cs, S, q0, BQ, kv0, BKV)) continue;
    const int s = it % STAGES;
    hopper::mbar_wait(&full[s], (it / STAGES) & 1);
    scores(s, kv0);
    softmax(kv0, pf, alpha);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i % 4) / 2];
    issue_pv(pf, s);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    ++it;
  }

  // normalise (l == 0 guarded) and store; the residuals once per row
  const long long head = (long long)b * p.sb + (long long)h * p.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_id[r] >= S) continue;
    if (p.m_out != nullptr && t == 0) {
      p.m_out[stat + row_id[r]] = m_run[r];
      p.l_out[stat + row_id[r]] = l_run[r];
    }
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* orow = p.o + head + (long long)row_id[r] * p.ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + c) =
          pack_bf16(o[4 * dn + 2 * r] / l, o[4 * dn + 2 * r + 1] / l);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const Args p) {
  fwd_wgmma_body<false>(map_q, map_k, map_v, p);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const Args p) {
  fwd_wgmma_body<true>(map_q, map_k, map_v, p);
}

// A 4-D map {D, S, H, B} of bf16 with element strides (sb, ss, sh), boxes of 64 d x `rows` rows.
bool qkv_map(CUtensorMap* map, const void* base, int B, int H, int S, long long sb, long long ss,
             long long sh, uint32_t rows = BQ) {
  const uint64_t dims[4] = {D, static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(ss) * 2, static_cast<uint64_t>(sh) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, rows, 1, 1};
  return hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
                                 box);
}

// A 4-D map {D, S, H, B} of the head-major int8 codes [B, H, S, D], boxes of 128 bytes x BQ rows.
bool codes_map(CUtensorMap* map, const void* base, int B, int H, int S) {
  const uint64_t dims[4] = {D, static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {D, static_cast<uint64_t>(S) * D, static_cast<uint64_t>(H) * S * D};
  const uint32_t box[4] = {D, BQ, 1, 1};
  return hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box);
}

// Launch the forward of either score mode on its three maps (one block per 128 query rows of
// one (batch, head)), after checking the entry register count its setmaxnreg targets balance.
template <bool INT8>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const Args& a, int B, cudaStream_t st) {
  auto* kernel = INT8 ? flash_fwd_int8_wgmma_kernel : flash_fwd_wgmma_kernel;
  static const bool regs_ok = hopper::entry_regs_are(kernel, ENTRY_REGS);
  if (!regs_ok) return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int bytes = FwdSmem<INT8>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, THREADS, bytes, st>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

Args fwd_args(void* o, float* m_out, float* l_out, int H, int S, long long sb, long long ss,
              long long sh, int cond_start, int mode, float cbias, float scale) {
  Args a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.m_out = m_out;
  a.l_out = l_out;
  a.H = H;
  a.S = S;
  a.sb = sb;
  a.ss = ss;
  a.sh = sh;
  a.cond_start = cond_start;
  a.mode = mode;
  a.cbias = cbias;
  a.scale = scale;
  a.qscale = a.kscale = nullptr;
  a.span = a.nspan = 1;
  return a;
}

}  // namespace fa3

// ---------------------------------------------------------------------------------------
// Backward: dK/dV pass and dQ pass (Dao-style two-pass backward, no atomics)
// ---------------------------------------------------------------------------------------
//
// Replace loongx_tpu/ops/flash_attention.py::_bwd_dkv_kernel (pallas_call :798) and
// ::_bwd_dq_kernel (:834).  Both rebuild P from the forward's base-2 residuals,
//   P_ij = 2^(s2_ij - m2_i) / l_i   (l == 0 rows: m2 = 0, l = 1; padded query rows: P = 0),
// with the forward's masks (padded keys, no_union, independent), and take
// di_i = rowsum(o_i * do_i) (fp32, computed by the caller) for
//   dS_ij = P_ij * (dP_ij - di_i) * scale,  dP = dO V^T.
// q and k are RoPE-rotated as their tiles load (rounded to bf16, as in the forward); dK and
// dQ are rotated back (the transpose of the rotation) as they are stored.  P and dS enter
// the tensor cores rounded to bf16; every sum is fp32.
//
// What bounds them on this card: the dK/dV pass does 4 matmuls (S, dP, dV, dK) and the dQ
// pass 3 (S, dP, dQ) of 2*S*S*D flops per head, 7 against the 5 an ideal single pass needs
// (the two-pass design recomputes S and dP instead of accumulating dQ with atomics); at
// S = 2560, D = 128 that is ~12 GFLOP per head against ~3 MB of operands: tensor-core
// operations bound them.  Design, kept simple: blocks of 4 warps; in the dK/dV pass each
// block owns 64 keys (16 per warp) with dK and dV accumulated in registers and loops over
// all query tiles (32 rows per step), in the dQ pass each block owns 64 query rows with dQ
// in registers and loops over all key tiles (64 per step).  The loop over the sequence
// runs inside the block, the TPU kernels' sequential grid axis.  mma.sync m16n8k16 with
// ldmatrix fragments from shared memory; a C fragment of P or dS becomes the A fragment of
// the next product in registers.  No cp.async/TMA pipeline and no wgmma: these kernels keep
// head_dim 64; at head_dim 128 (every FLUX shape) the backward runs the wgmma kernels below
// ("Backward on wgmma"), chosen by flash_bwd_route in Python.

constexpr int BWD_THREADS = 128;  // 4 warps
constexpr int DKV_KEYS = 64;      // keys per dK/dV block (16 per warp)
constexpr int DKV_QSTEP = 32;     // query rows per dK/dV loop step
constexpr int DQ_ROWS = 64;       // query rows per dQ block (16 per warp)
constexpr int DQ_KSTEP = 64;      // keys per dQ loop step

__device__ __forceinline__ bool masked(int mode, bool row_cond, bool col_cond) {
  return (mode == NO_UNION && row_cond != col_cond) ||
         (mode == INDEPENDENT && row_cond && !col_cond);
}

// The A fragment (16 x 16, row-major) at rows r0.., cols c0.. of a shared tile.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&r)[4], const __nv_bfloat16* tile, int ld,
                                           int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, tile + (r0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + c0 + 8 * (lane / 16));
}

// Inverse RoPE of an interleaved pair (x0, x1) at (row, c): the transpose of the rotation,
// y = x * cos - (x @ R) * sin, as the TPU kernels store dq / dk.
__device__ __forceinline__ void rope_back(float& x0, float& x1, const float* cos,
                                          const float* sin, int D, int row, int c) {
  if (cos == nullptr) return;
  const float2 cc = *reinterpret_cast<const float2*>(cos + (long long)row * D + c);
  const float2 sn = *reinterpret_cast<const float2*>(sin + (long long)row * D + c);
  const float y0 = __fadd_rn(__fmul_rn(x0, cc.x), __fmul_rn(x1, sn.x));
  const float y1 = __fsub_rn(__fmul_rn(x1, cc.y), __fmul_rn(x0, sn.y));
  x0 = y0;
  x1 = y1;
}

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *m2, *l, *di, *cos, *sin;
  __nv_bfloat16 *dq, *dk, *dv;
  int H, S;
  long long sb, ss, sh;
  int cond_start, mode;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkv_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16, DTILES = D / 8, NQ = DKV_QSTEP / 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* vs = ks + DKV_KEYS * LD;
  __nv_bfloat16* qs = vs + DKV_KEYS * LD;
  __nv_bfloat16* dos = qs + DKV_QSTEP * LD;
  float* m_s = reinterpret_cast<float*>(dos + DKV_QSTEP * LD);
  float* il_s = m_s + DKV_QSTEP;
  float* di_s = il_s + DKV_QSTEP;

  const int k0 = blockIdx.x * DKV_KEYS;
  const long long head = (long long)blockIdx.z * p.sb + (long long)blockIdx.y * p.sh;
  const long long stat = ((long long)blockIdx.z * p.H + blockIdx.y) * p.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int wk = warp * 16;  // this warp's first key inside the tile
  const float scale_log2 = p.scale * LOG2E;
  const int key_id[2] = {k0 + wk + g, k0 + wk + g + 8};
  const bool key_cond[2] = {key_id[0] >= p.cond_start, key_id[1] >= p.cond_start};

  load_tile<D, DKV_KEYS, BWD_THREADS>(ks, p.k + head, p.ss, k0, p.S, p.cos, p.sin);
  load_tile<D, DKV_KEYS, BWD_THREADS>(vs, p.v + head, p.ss, k0, p.S, nullptr, nullptr);

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int q0 = 0; q0 < p.S; q0 += DKV_QSTEP) {
    __syncthreads();  // every warp is done with the previous Q / dO tile and its stats
    load_tile<D, DKV_QSTEP, BWD_THREADS>(qs, p.q + head, p.ss, q0, p.S, p.cos, p.sin);
    load_tile<D, DKV_QSTEP, BWD_THREADS>(dos, p.dout + head, p.ss, q0, p.S, nullptr, nullptr);
    for (int i = threadIdx.x; i < DKV_QSTEP; i += BWD_THREADS) {
      const int row = q0 + i;
      float m = 0.f, il = 0.f, d = 0.f;  // padded query rows: P = 0
      if (row < p.S) {
        const float l = p.l[stat + row];
        m = l == 0.f ? 0.f : p.m2[stat + row];
        il = 1.f / (l == 0.f ? 1.f : l);
        d = p.di[stat + row];
      }
      m_s[i] = m;
      il_s[i] = il;
      di_s[i] = d;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x DKV_QSTEP queries per warp
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nn][e] = dpt[nn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      uint32_t ka0[4], ka1[4], va0[4], va1[4];
      ldmatrix_a(ka0, ks, LD, wk, kk * 16);
      ldmatrix_a(ka1, ks, LD, wk, kk * 16 + 16);
      ldmatrix_a(va0, vs, LD, wk, kk * 16);
      ldmatrix_a(va1, vs, LD, wk, kk * 16 + 16);
#pragma unroll
      for (int nn = 0; nn < NQ; ++nn) {
        const int off = (nn * 8 + mr) * LD + (mi % 2) * 8 + (mi / 2) * 16 + kk * 16;
        uint32_t b[4];
        ldmatrix_x4(b, qs + off);
        mma_bf16(st[nn], ka0, b[0], b[1]);
        mma_bf16(st[nn], ka1, b[2], b[3]);
        ldmatrix_x4(b, dos + off);
        mma_bf16(dpt[nn], va0, b[0], b[1]);
        mma_bf16(dpt[nn], va1, b[2], b[3]);
      }
    }

    // P^T and dS^T (fp32), then bf16 A fragments (k = query)
    uint32_t pf[NQ / 2][4], dsf[NQ / 2][4];
#pragma unroll
    for (int nn = 0; nn < NQ; ++nn) {
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int qi = nn * 8 + 2 * t + (e % 2);
        const int qrow = q0 + qi;
        float s = st[nn][e] * scale_log2;
        if (key_id[r] >= p.S || masked(p.mode, qrow >= p.cond_start, key_cond[r]))
          s = MASK_VALUE;
        pv[e] = exp2f(s - m_s[qi]) * il_s[qi];
        ds[e] = pv[e] * (dpt[nn][e] - di_s[qi]) * p.scale;
      }
      pf[nn / 2][(nn % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pf[nn / 2][(nn % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      dsf[nn / 2][(nn % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nn / 2][(nn % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q (B operands: dO and Q transposed out of shared memory)
#pragma unroll
    for (int kq = 0; kq < NQ / 2; ++kq) {
      const int off = (kq * 16 + (mi % 2) * 8 + mr) * LD + (mi / 2) * 8;
#pragma unroll
      for (int dn = 0; dn < DTILES; dn += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dos + off + dn * 8);
        mma_bf16(dv[dn], pf[kq], b[0], b[1]);
        mma_bf16(dv[dn + 1], pf[kq], b[2], b[3]);
        ldmatrix_x4_trans(b, qs + off + dn * 8);
        mma_bf16(dk[dn], dsf[kq], b[0], b[1]);
        mma_bf16(dk[dn + 1], dsf[kq], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key_id[r] >= p.S) continue;
    __nv_bfloat16* dkrow = p.dk + head + (long long)key_id[r] * p.ss;
    __nv_bfloat16* dvrow = p.dv + head + (long long)key_id[r] * p.ss;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      const int c = dn * 8 + 2 * t;
      float x0 = dk[dn][2 * r], x1 = dk[dn][2 * r + 1];
      rope_back(x0, x1, p.cos, p.sin, D, key_id[r], c);
      *reinterpret_cast<uint32_t*>(dkrow + c) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(dvrow + c) = pack_bf16(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16, DTILES = D / 8, NK = DQ_KSTEP / 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* dos = qs + DQ_ROWS * LD;
  __nv_bfloat16* ks = dos + DQ_ROWS * LD;
  __nv_bfloat16* vs = ks + DQ_KSTEP * LD;

  const int q0 = blockIdx.x * DQ_ROWS;
  const long long head = (long long)blockIdx.z * p.sb + (long long)blockIdx.y * p.sh;
  const long long stat = ((long long)blockIdx.z * p.H + blockIdx.y) * p.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int wr = warp * 16;
  const float scale_log2 = p.scale * LOG2E;

  load_tile<D, DQ_ROWS, BWD_THREADS>(qs, p.q + head, p.ss, q0, p.S, p.cos, p.sin);
  load_tile<D, DQ_ROWS, BWD_THREADS>(dos, p.dout + head, p.ss, q0, p.S, nullptr, nullptr);

  int row_id[2];
  bool row_cond[2];
  float m_row[2], il_row[2], di_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_id[r] = q0 + wr + g + 8 * r;
    row_cond[r] = row_id[r] >= p.cond_start;
    m_row[r] = il_row[r] = di_row[r] = 0.f;  // padded query rows: P = 0
    if (row_id[r] < p.S) {
      const float l = p.l[stat + row_id[r]];
      m_row[r] = l == 0.f ? 0.f : p.m2[stat + row_id[r]];
      il_row[r] = 1.f / (l == 0.f ? 1.f : l);
      di_row[r] = p.di[stat + row_id[r]];
    }
  }

  float dq[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int kv0 = 0; kv0 < p.S; kv0 += DQ_KSTEP) {
    __syncthreads();  // every warp is done with the previous K / V tile (and Q, dO are stored)
    load_tile<D, DQ_KSTEP, BWD_THREADS>(ks, p.k + head, p.ss, kv0, p.S, p.cos, p.sin);
    load_tile<D, DQ_KSTEP, BWD_THREADS>(vs, p.v + head, p.ss, kv0, p.S, nullptr, nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x DQ_KSTEP keys per warp
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int nn = 0; nn < NK; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      uint32_t qa0[4], qa1[4], da0[4], da1[4];
      ldmatrix_a(qa0, qs, LD, wr, kk * 16);
      ldmatrix_a(qa1, qs, LD, wr, kk * 16 + 16);
      ldmatrix_a(da0, dos, LD, wr, kk * 16);
      ldmatrix_a(da1, dos, LD, wr, kk * 16 + 16);
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        const int off = (nn * 8 + mr) * LD + (mi % 2) * 8 + (mi / 2) * 16 + kk * 16;
        uint32_t b[4];
        ldmatrix_x4(b, ks + off);
        mma_bf16(sc[nn], qa0, b[0], b[1]);
        mma_bf16(sc[nn], qa1, b[2], b[3]);
        ldmatrix_x4(b, vs + off);
        mma_bf16(dp[nn], da0, b[0], b[1]);
        mma_bf16(dp[nn], da1, b[2], b[3]);
      }
    }

    // dS (fp32) -> bf16 A fragments (k = key)
    uint32_t dsf[NK / 2][4];
#pragma unroll
    for (int nn = 0; nn < NK; ++nn) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int col = kv0 + nn * 8 + 2 * t + (e % 2);
        float s = sc[nn][e] * scale_log2;
        if (col >= p.S || masked(p.mode, row_cond[r], col >= p.cond_start)) s = MASK_VALUE;
        const float pv = exp2f(s - m_row[r]) * il_row[r];
        ds[e] = pv * (dp[nn][e] - di_row[r]) * p.scale;
      }
      dsf[nn / 2][(nn % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nn / 2][(nn % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (B operand: K transposed out of shared memory)
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const __nv_bfloat16* kaddr = ks + (kk * 16 + (mi % 2) * 8 + mr) * LD + (mi / 2) * 8;
#pragma unroll
      for (int dn = 0; dn < DTILES; dn += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, kaddr + dn * 8);
        mma_bf16(dq[dn], dsf[kk], b[0], b[1]);
        mma_bf16(dq[dn + 1], dsf[kk], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_id[r] >= p.S) continue;
    __nv_bfloat16* dqrow = p.dq + head + (long long)row_id[r] * p.ss;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      const int c = dn * 8 + 2 * t;
      float x0 = dq[dn][2 * r], x1 = dq[dn][2 * r + 1];
      rope_back(x0, x1, p.cos, p.sin, D, row_id[r], c);
      *reinterpret_cast<uint32_t*>(dqrow + c) = pack_bf16(x0, x1);
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * DKV_KEYS + 2 * DKV_QSTEP) * (D + PAD) * 2 + 3 * DKV_QSTEP * 4;
}
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * DQ_ROWS + 2 * DQ_KSTEP) * (D + PAD) * 2;
}

template <int D>
cudaError_t launch_bwd(bool dkv, const BwdArgs& a, int B, cudaStream_t st) {
  const int bytes = dkv ? dkv_smem_bytes<D>() : dq_smem_bytes<D>();
  auto* kernel = dkv ? flash_bwd_dkv_kernel<D> : flash_bwd_dq_kernel<D>;
  // above 48 KB a block's shared memory must be opted into (cheap; set on every launch)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = dkv ? DKV_KEYS : DQ_ROWS;
  const dim3 grid((a.S + rows - 1) / rows, a.H, B);
  kernel<<<grid, BWD_THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

int bwd_entry(bool dkv, const void* q, const void* k, const void* v, const void* dout,
              const float* m2, const float* l, const float* di, const float* cos,
              const float* sin, void* dq, void* dk, void* dv, int B, int H, int S, int D,
              long long sb, long long ss, long long sh, int cond_start, int mode, float scale,
              void* stream) {
  if (mode != UNION && mode != NO_UNION && mode != INDEPENDENT)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.m2 = m2;
  a.l = l;
  a.di = di;
  a.cos = cos;
  a.sin = sin;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.H = H;
  a.S = S;
  a.sb = sb;
  a.ss = ss;
  a.sh = sh;
  a.cond_start = cond_start;
  a.mode = mode;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128) {
    err = launch_bwd<128>(dkv, a, B, st);
  } else if (D == 64) {
    err = launch_bwd<64>(dkv, a, B, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------------------
// Backward on wgmma (D = 128): the dK/dV and dQ passes, warp-specialised
// ---------------------------------------------------------------------------------------
//
// The two passes above on Hopper's asynchronous machinery, for the same contract.  Both read q
// and k already rotated (the forward's RoPE pre-pass output, head-major [2, B, H, S, D], which
// the autograd Function saves; without RoPE the inputs as they lie) and v, do through the
// forward's 4-D TMA maps (128-byte swizzle, zeros past S), and rotate dK / dQ back on store.
//
// flash_bwd_dq_wgmma_kernel: one block per 128 query rows of one (batch, head).  The producer
// thread loads the Q and dO tiles once and K and V tiles of 128 keys into a ring of DQ_STAGES;
// two consumer warpgroups own 64 rows each: S = Q.K^T and dP = dO.V^T (wgmma m64n128k16, both
// operands d-contiguous, K-major) issued as two groups, P rebuilt from the per-row (m2, l) in
// registers while dP runs, dS = P (dP - di) scale rounded to bf16 in registers as the A operand
// of dQ += dS.K (K as the MN-major B through the transpose bit, as V in the forward's P.V).
//
// flash_bwd_dkv_wgmma_kernel: one block per 128 keys.  K and V are loaded once; Q and dO tiles
// of 64 query rows stream through a ring of KV_STAGES, and two producer warps write each
// tile's per-query (-m2, 1/l, di) into its stage (the l == 0 rule and the zero 1/l of padded
// rows applied once, there).  Two consumer warpgroups own 64 keys each and compute the
// transposed products S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n64k16), so that P^T and dS^T
// are C fragments in registers, whose layout is the A fragment's: dV += P^T.dO and
// dK += dS^T.Q run from registers with dO and Q as the MN-major B, and neither goes through
// shared memory.  The per-query statistics vary along the fragment's columns and are read from
// the stage.  Key rows past S are computed on TMA's zeros and not stored; query rows past S
// have 1/l = 0, so their P is 0.
//
// Both skip tiles that the block mask hides from the whole block and take the per-element mask
// only on tiles that are not plain.  What bounds them is tensor-core work: at S 2560, 24 heads,
// union, each product is 40 GFLOP, 0.041 ms at the data sheet's bf16 rate; the two passes do
// seven (dK/dV four, dQ three: S and dP are recomputed so that dQ is written once per query
// block, with no atomics, and the gradients are deterministic).
namespace fa3 {

constexpr int DQ_STAGES = 2;
constexpr int DQ_SMEM_BYTES = (4 + 4 * DQ_STAGES) * PANEL + (1 + 2 * DQ_STAGES) * 8 + 1024;
constexpr int KV_BQ = 64;                // query rows per dK/dV ring stage
constexpr int QPANEL = KV_BQ * 128;      // bytes: 64 rows x 64 bf16, one TMA box
constexpr int KV_STAGES = 4;
constexpr int KV_STATS = 3 * KV_BQ * 4;  // bytes of one stage's (-m2, 1/l, di)
constexpr int KV_SMEM_BYTES =
    4 * PANEL + KV_STAGES * (4 * QPANEL + KV_STATS) + (1 + 2 * KV_STAGES) * 8 + 1024;

struct GradArgs {
  const float *m2, *l, *di, *cos, *sin;
  __nv_bfloat16 *dq, *dk, *dv;
  int H, S;
  long long sb, ss, sh;  // element strides of v, do and the gradients
  int cond_start, mode;
  float scale;
};

// (-m2, 1/l, di) of query row `row` (l == 0: m2 = 0, l = 1; past S: 1/l = 0, so P = 0).
__device__ __forceinline__ void row_stats(const GradArgs& p, long long stat, int row,
                                          float& mneg, float& il, float& di) {
  mneg = il = di = 0.f;
  if (row >= p.S) return;
  const float l = p.l[stat + row];
  mneg = l == 0.f ? 0.f : -p.m2[stat + row];
  il = 1.f / (l == 0.f ? 1.f : l);
  di = p.di[stat + row];
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, const GradArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;               // 2 panels
  uint8_t* sdo = base + 2 * PANEL;  // 2 panels
  uint8_t* sk = base + 4 * PANEL;   // DQ_STAGES x 2 panels
  uint8_t* sv = sk + 2 * DQ_STAGES * PANEL;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + (4 + 4 * DQ_STAGES) * PANEL);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, cs = p.cond_start, mode = p.mode;
  const int ntiles = (S + BKV - 1) / BKV;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      hopper::mbar_arrive_expect_tx(qfull, 4 * PANEL);
      hopper::tma_load_4d(sq, &map_q, qfull, 0, q0, h, b);
      hopper::tma_load_4d(sq + PANEL, &map_q, qfull, 64, q0, h, b);
      hopper::tma_load_4d(sdo, &map_do, qfull, 0, q0, h, b);
      hopper::tma_load_4d(sdo + PANEL, &map_do, qfull, 64, q0, h, b);
      int it = 0;
      for (int j = 0; j < ntiles; ++j) {
        if (!tile_visible(mode, cs, S, q0, BQ, j * BKV, BKV)) continue;
        const int s = it % DQ_STAGES;
        hopper::mbar_wait(&empty[s], ((it / DQ_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 4 * PANEL);
        uint8_t* kt = sk + s * 2 * PANEL;
        uint8_t* vt = sv + s * 2 * PANEL;
        hopper::tma_load_4d(kt, &map_k, &full[s], 0, j * BKV, h, b);
        hopper::tma_load_4d(kt + PANEL, &map_k, &full[s], 64, j * BKV, h, b);
        hopper::tma_load_4d(vt, &map_v, &full[s], 0, j * BKV, h, b);
        hopper::tma_load_4d(vt + PANEL, &map_v, &full[s], 64, j * BKV, h, b);
        ++it;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = p.scale * LOG2E;
  const long long stat = ((long long)b * p.H + h) * S;
  int row_id[2];
  bool row_cond[2];
  float mneg[2], il[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_id[r] = q0 + wgi * 64 + warp * 16 + g + 8 * r;
    row_cond[r] = row_id[r] >= cs;
    row_stats(p, stat, row_id[r], mneg[r], il[r], di[r]);
  }

  float dq[64], sc[64], dp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  const uint8_t* sq_wg = sq + wgi * 64 * 128;
  const uint8_t* sdo_wg = sdo + wgi * 64 * 128;

  hopper::mbar_wait(qfull, 0);
  int it = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * BKV;
    if (!tile_visible(mode, cs, S, q0, BQ, kv0, BKV)) continue;
    const int s = it % DQ_STAGES;
    hopper::mbar_wait(&full[s], (it / DQ_STAGES) & 1);
    const uint8_t* kt = sk + s * 2 * PANEL;
    const uint8_t* vt = sv + s * 2 * PANEL;
    // S = Q K^T, then dP = dO V^T: 8 k-steps of 16 d each, 4 in each 64-wide panel
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * PANEL + (kk % 4) * 32;
      hopper::wgmma_m64n128k16_bf16_ss(sc, hopper::desc_sw128(sq_wg + off, 16, 1024),
                                       hopper::desc_sw128(kt + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * PANEL + (kk % 4) * 32;
      hopper::wgmma_m64n128k16_bf16_ss(dp, hopper::desc_sw128(sdo_wg + off, 16, 1024),
                                       hopper::desc_sw128(vt + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    // P = 2^(s scale log2 e - m2) / l in place of S (sc[4i + e]: row e / 2, key
    // kv0 + 8i + 2t + e % 2; masked and padded keys 0), while dP runs
    hopper::wgmma_wait<1>();
    hopper::fence_operands(sc);
    const bool plain = tile_plain(mode, cs, S, q0, BQ, kv0, BKV);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i % 4) / 2;
      float pv = fast_exp2(fmaf(sc[i], scale_log2, mneg[r])) * il[r];
      if (!plain) {
        const int col = kv0 + (i / 4) * 8 + 2 * t + (i % 2);
        if (col >= S || masked(mode, row_cond[r], col >= cs)) pv = 0.f;
      }
      sc[i] = pv;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dp);
    // dS = P (dP - di) scale, rounded to bf16: the A fragments of the k-steps of 16 keys
    // ({row g lo, row g+8 lo, row g hi, row g+8 hi}, as the forward's P)
    uint32_t dsf[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      float ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        ds[e] = sc[i] * (dp[i] - di[(e % 4) / 2]) * p.scale;
      }
      dsf[kk][0] = pack_bf16(ds[0], ds[1]);
      dsf[kk][1] = pack_bf16(ds[2], ds[3]);
      dsf[kk][2] = pack_bf16(ds[4], ds[5]);
      dsf[kk][3] = pack_bf16(ds[6], ds[7]);
    }
    // dQ += dS K: 8 k-steps of 16 keys; K's 64-wide d panels are PANEL bytes apart
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hopper::wgmma_m64n128k16_bf16_rs_tb(
          dq, dsf[kk], hopper::desc_sw128(kt + kk * 16 * 128, PANEL, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dq);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    ++it;
  }

  const long long head = (long long)b * p.sb + (long long)h * p.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_id[r] >= S) continue;
    __nv_bfloat16* dqrow = p.dq + head + (long long)row_id[r] * p.ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      float x0 = dq[4 * dn + 2 * r], x1 = dq[4 * dn + 2 * r + 1];
      rope_back(x0, x1, p.cos, p.sin, D, row_id[r], c);
      *reinterpret_cast<uint32_t*>(dqrow + c) = pack_bf16(x0, x1);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do, const GradArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = base;                          // 2 panels
  uint8_t* sv = base + 2 * PANEL;              // 2 panels
  uint8_t* sq = base + 4 * PANEL;              // KV_STAGES x 2 query panels
  uint8_t* sdo = sq + 2 * KV_STAGES * QPANEL;  // KV_STAGES x 2 query panels
  float* sst = reinterpret_cast<float*>(sdo + 2 * KV_STAGES * QPANEL);  // KV_STAGES x 3 x 64
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sst + KV_STAGES * 3 * KV_BQ);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + KV_STAGES;

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, cs = p.cond_start, mode = p.mode;
  const int ntiles = (S + KV_BQ - 1) / KV_BQ;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kvfull, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&full[s], KV_BQ);  // the 64 producer threads that write the stats
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    hopper::setmaxnreg_dec<24>();
    const int pt = threadIdx.x - CONSUMERS;  // producer warps 0-1: one query row each
    if (pt < KV_BQ) {
      if (pt == 0) {
        hopper::mbar_arrive_expect_tx(kvfull, 4 * PANEL);
        hopper::tma_load_4d(sk, &map_k, kvfull, 0, k0, h, b);
        hopper::tma_load_4d(sk + PANEL, &map_k, kvfull, 64, k0, h, b);
        hopper::tma_load_4d(sv, &map_v, kvfull, 0, k0, h, b);
        hopper::tma_load_4d(sv + PANEL, &map_v, kvfull, 64, k0, h, b);
      }
      const long long stat = ((long long)b * p.H + h) * S;
      int it = 0;
      for (int j = 0; j < ntiles; ++j) {
        const int qs0 = j * KV_BQ;
        if (!tile_visible(mode, cs, S, qs0, KV_BQ, k0, BKV)) continue;
        const int s = it % KV_STAGES;
        hopper::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        float* st = sst + s * 3 * KV_BQ;
        row_stats(p, stat, qs0 + pt, st[pt], st[KV_BQ + pt], st[2 * KV_BQ + pt]);
        if (pt == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 4 * QPANEL);
          uint8_t* qt = sq + s * 2 * QPANEL;
          uint8_t* dot = sdo + s * 2 * QPANEL;
          hopper::tma_load_4d(qt, &map_q, &full[s], 0, qs0, h, b);
          hopper::tma_load_4d(qt + QPANEL, &map_q, &full[s], 64, qs0, h, b);
          hopper::tma_load_4d(dot, &map_do, &full[s], 0, qs0, h, b);
          hopper::tma_load_4d(dot + QPANEL, &map_do, &full[s], 64, qs0, h, b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
        ++it;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = p.scale * LOG2E;
  int key_id[2];
  bool key_cond[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_id[r] = k0 + wgi * 64 + warp * 16 + g + 8 * r;
    key_cond[r] = key_id[r] >= cs;
  }

  float dk[64], dv[64], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const uint8_t* sk_wg = sk + wgi * 64 * 128;
  const uint8_t* sv_wg = sv + wgi * 64 * 128;

  hopper::mbar_wait(kvfull, 0);
  int it = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int qs0 = j * KV_BQ;
    if (!tile_visible(mode, cs, S, qs0, KV_BQ, k0, BKV)) continue;
    const int s = it % KV_STAGES;
    hopper::mbar_wait(&full[s], (it / KV_STAGES) & 1);
    const uint8_t* qt = sq + s * 2 * QPANEL;
    const uint8_t* dot = sdo + s * 2 * QPANEL;
    const float* stt = sst + s * 3 * KV_BQ;
    // S^T = K Q^T, then dP^T = V dO^T: 8 k-steps of 16 d each
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int koff = (kk / 4) * PANEL + (kk % 4) * 32;
      const int qoff = (kk / 4) * QPANEL + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_bf16_ss(st, hopper::desc_sw128(sk_wg + koff, 16, 1024),
                                      hopper::desc_sw128(qt + qoff, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int koff = (kk / 4) * PANEL + (kk % 4) * 32;
      const int qoff = (kk / 4) * QPANEL + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_bf16_ss(dpt, hopper::desc_sw128(sv_wg + koff, 16, 1024),
                                      hopper::desc_sw128(dot + qoff, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    // P^T in place of S^T (st[4i + e]: key row e / 2, query qs0 + 8i + 2t + e % 2), while dP^T
    // runs; the stats of the thread's two queries of n-tile i are adjacent in the stage
    hopper::wgmma_wait<1>();
    hopper::fence_operands(st);
    const bool plain = tile_plain(mode, cs, S, qs0, KV_BQ, k0, BKV);
#pragma unroll
    for (int i = 0; i < KV_BQ / 8; ++i) {
      const int qc = 8 * i + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(stt + qc);
      const float2 iq = *reinterpret_cast<const float2*>(stt + KV_BQ + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = fast_exp2(fmaf(st[4 * i + e], scale_log2, e % 2 ? mq.y : mq.x)) *
                   (e % 2 ? iq.y : iq.x);
        if (!plain && masked(mode, qs0 + qc + e % 2 >= cs, key_cond[e / 2])) pv = 0.f;
        st[4 * i + e] = pv;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dpt);
    // dS^T = P^T (dP^T - di) scale; P^T and dS^T rounded to bf16 as the A fragments of the
    // k-steps of 16 queries
    uint32_t pf[KV_BQ / 16][4], dsf[KV_BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      const float2 d0 = *reinterpret_cast<const float2*>(stt + 2 * KV_BQ + 16 * kk + 2 * t);
      const float2 d1 = *reinterpret_cast<const float2*>(stt + 2 * KV_BQ + 16 * kk + 8 + 2 * t);
      float ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        const float di = e < 4 ? (e % 2 ? d0.y : d0.x) : (e % 2 ? d1.y : d1.x);
        ds[e] = st[i] * (dpt[i] - di) * p.scale;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        pf[kk][w] = pack_bf16(st[8 * kk + 2 * w], st[8 * kk + 2 * w + 1]);
        dsf[kk][w] = pack_bf16(ds[2 * w], ds[2 * w + 1]);
      }
    }
    // dV += P^T dO, dK += dS^T Q: 4 k-steps of 16 queries; the 64-wide d panels of a query
    // tile are QPANEL bytes apart
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk)
      hopper::wgmma_m64n128k16_bf16_rs_tb(
          dv, pf[kk], hopper::desc_sw128(dot + kk * 16 * 128, QPANEL, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk)
      hopper::wgmma_m64n128k16_bf16_rs_tb(
          dk, dsf[kk], hopper::desc_sw128(qt + kk * 16 * 128, QPANEL, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dv);
    hopper::fence_operands(dk);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    ++it;
  }

  const long long head = (long long)b * p.sb + (long long)h * p.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key_id[r] >= S) continue;
    __nv_bfloat16* dkrow = p.dk + head + (long long)key_id[r] * p.ss;
    __nv_bfloat16* dvrow = p.dv + head + (long long)key_id[r] * p.ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      float x0 = dk[4 * dn + 2 * r], x1 = dk[4 * dn + 2 * r + 1];
      rope_back(x0, x1, p.cos, p.sin, D, key_id[r], c);
      *reinterpret_cast<uint32_t*>(dkrow + c) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(dvrow + c) =
          pack_bf16(dv[4 * dn + 2 * r], dv[4 * dn + 2 * r + 1]);
    }
  }
}

// One pass (dkv: dK/dV, else dQ) on wgmma; q, k with strides (qsb, qss, qsh), v, do and the
// gradients with a.sb, a.ss, a.sh.
int grad_entry(bool dkv, const void* q, const void* k, const void* v, const void* dout,
               const GradArgs& a, int B, int H, int S, long long qsb, long long qss,
               long long qsh, cudaStream_t st) {
  if (a.mode != UNION && a.mode != NO_UNION && a.mode != INDEPENDENT)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t qrows = dkv ? KV_BQ : BQ;  // Q and dO stream in 64-row tiles in the dK/dV pass
  CUtensorMap mq, mk, mv, mdo;
  if (!qkv_map(&mq, q, B, H, S, qsb, qss, qsh, qrows) ||
      !qkv_map(&mk, k, B, H, S, qsb, qss, qsh) || !qkv_map(&mv, v, B, H, S, a.sb, a.ss, a.sh) ||
      !qkv_map(&mdo, dout, B, H, S, a.sb, a.ss, a.sh, qrows))
    return static_cast<int>(cudaErrorInvalidValue);
  static const bool dkv_regs_ok = hopper::entry_regs_are(flash_bwd_dkv_wgmma_kernel, ENTRY_REGS);
  static const bool dq_regs_ok = hopper::entry_regs_are(flash_bwd_dq_wgmma_kernel, ENTRY_REGS);
  if (!(dkv ? dkv_regs_ok : dq_regs_ok)) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto* kernel = dkv ? flash_bwd_dkv_wgmma_kernel : flash_bwd_dq_wgmma_kernel;
  const int bytes = dkv ? KV_SMEM_BYTES : DQ_SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + 127) / 128, H, B);  // 128 keys (dK/dV) or 128 query rows (dQ) a block
  kernel<<<grid, THREADS, bytes, st>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa3

}  // namespace

// q, k, v, o: bf16 with element strides (sb, ss, sh) for (batch, seq, head) and a unit
// head-dim stride; cos/sin: fp32 [S, D] or null; m_out/l_out: fp32 [B, H, S] residuals or
// null.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const float* cos, const float* sin, float* m_out,
                                   float* l_out, int B, int H, int S, int D, long long sb,
                                   long long ss, long long sh, int cond_start, int mode,
                                   float cbias, float scale, void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 128) {
    flash_fwd_kernel<128, false><<<grid, NTHREADS, 0, st>>>(
        qp, kp, nullptr, nullptr, vp, op, cos, sin, m_out, l_out, H, S, sb, ss, sh, cond_start,
        mode, cbias, scale, 1, 1);
  } else if (D == 64) {
    flash_fwd_kernel<64, false><<<grid, NTHREADS, 0, st>>>(
        qp, kp, nullptr, nullptr, vp, op, cos, sin, m_out, l_out, H, S, sb, ss, sh, cond_start,
        mode, cbias, scale, 1, 1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 mode's pre-pass: k bf16 (strides as above), cos/sin fp32 [S, D] or null, kmax an fp32
// [B, H, ceil(S / 64)] scratch -> codes int8 [B, H, S, D] (head-major), scales fp32 [B, H, nspan],
// one per span of `span` keys (a multiple of 64); with q (same strides; null for none) also q's
// codes int8 [B, H, S, D] and per-row scales fp32 [B, H, S].  Returns cudaGetLastError().
extern "C" int flash_attention_kquant(const void* k, const void* q, const float* cos,
                                      const float* sin, float* kmax, void* codes, float* scales,
                                      void* qcodes, float* qscale, int B, int H, int S, int D,
                                      long long sb, long long ss, long long sh, int span,
                                      int nspan, void* stream) {
  if (span <= 0 || span % KQ_ROWS || nspan != (S + span - 1) / span)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* cp = static_cast<int8_t*>(codes);
  auto* qcp = static_cast<int8_t*>(qcodes);
  cudaError_t err;
  if (D == 128) {
    err = launch_kquant<128>(kp, qp, cos, sin, kmax, cp, scales, qcp, qscale, B, H, S, sb, ss, sh,
                             span, nspan, st);
  } else if (D == 64) {
    err = launch_kquant<64>(kp, qp, cos, sin, kmax, cp, scales, qcp, qscale, B, H, S, sb, ss, sh,
                            span, nspan, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The int8 QK^T forward: q, v, o as in flash_attention_fwd; kq / kscale the pre-pass's
// codes and scales.  No residuals (serving only).  Returns cudaGetLastError().
extern "C" int flash_attention_fwd_int8(const void* q, const void* kq, const float* kscale,
                                        const void* v, void* o, const float* cos,
                                        const float* sin, int B, int H, int S, int D,
                                        long long sb, long long ss, long long sh,
                                        int cond_start, int mode, float cbias, float scale,
                                        int span, int nspan, void* stream) {
  if (span <= 0 || span % BKV || nspan != (S + span - 1) / span)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kqp = static_cast<const int8_t*>(kq);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 128) {
    flash_fwd_kernel<128, true><<<grid, NTHREADS, 0, st>>>(
        qp, nullptr, kqp, kscale, vp, op, cos, sin, nullptr, nullptr, H, S, sb, ss, sh,
        cond_start, mode, cbias, scale, span, nspan);
  } else if (D == 64) {
    flash_fwd_kernel<64, true><<<grid, NTHREADS, 0, st>>>(
        qp, nullptr, kqp, kscale, vp, op, cos, sin, nullptr, nullptr, H, S, sb, ss, sh,
        cond_start, mode, cbias, scale, span, nspan);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dK/dV pass: q, k, v, do bf16 (strides as above), m2 / l / di fp32 [B, H, S] (the
// forward's base-2 residuals and rowsum(o * do)) -> dk, dv bf16 in the same layout.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* m2, const float* l,
                                       const float* di, const float* cos, const float* sin,
                                       void* dk, void* dv, int B, int H, int S, int D,
                                       long long sb, long long ss, long long sh,
                                       int cond_start, int mode, float scale, void* stream) {
  return bwd_entry(true, q, k, v, dout, m2, l, di, cos, sin, nullptr, dk, dv, B, H, S, D, sb,
                   ss, sh, cond_start, mode, scale, stream);
}

// The dQ pass: the same inputs -> dq bf16.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* m2, const float* l,
                                      const float* di, const float* cos, const float* sin,
                                      void* dq, int B, int H, int S, int D, long long sb,
                                      long long ss, long long sh, int cond_start, int mode,
                                      float scale, void* stream) {
  return bwd_entry(false, q, k, v, dout, m2, l, di, cos, sin, dq, nullptr, nullptr, B, H, S,
                   D, sb, ss, sh, cond_start, mode, scale, stream);
}

// The RoPE pre-pass of the wgmma forward: q, k bf16 (element strides sb, ss, sh), cos/sin fp32
// [S, 128] -> out bf16 [2, B, H, S, 128] (rotated q, then rotated k, head-major).
extern "C" int flash_rope_prepass(const void* q, const void* k, const float* cos,
                                  const float* sin, void* out, int B, int H, int S, long long sb,
                                  long long ss, long long sh, void* stream) {
  const dim3 grid((S + fa3::ROPE_ROWS - 1) / fa3::ROPE_ROWS, H, 2 * B);
  fa3::rope_prepass_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), cos, sin,
      static_cast<__nv_bfloat16*>(out), B, H, S, sb, ss, sh);
  return static_cast<int>(cudaGetLastError());
}

// The bf16-score forward on wgmma, D = 128: q and k with element strides (qsb, qss, qsh) (the
// pre-pass's head-major buffer, or the inputs as they lie when there is no RoPE), v and o with
// (sb, ss, sh); m_out/l_out fp32 [B, H, S] base-2 residuals or null.  Every stride and base
// must be 16-byte aligned (TMA).  Returns cudaGetLastError().
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                         float* m_out, float* l_out, int B, int H, int S, int D,
                                         long long qsb, long long qss, long long qsh,
                                         long long sb, long long ss, long long sh,
                                         int cond_start, int mode, float cbias, float scale,
                                         void* stream) {
  if (D != fa3::D || mode < UNION || mode > CFACTOR) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!fa3::qkv_map(&mq, q, B, H, S, qsb, qss, qsh) ||
      !fa3::qkv_map(&mk, k, B, H, S, qsb, qss, qsh) || !fa3::qkv_map(&mv, v, B, H, S, sb, ss, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  return fa3::launch_fwd<false>(mq, mk, mv,
                                fa3::fwd_args(o, m_out, l_out, H, S, sb, ss, sh, cond_start, mode,
                                              cbias, scale),
                                B, static_cast<cudaStream_t>(stream));
}

// The int8 QK^T forward on wgmma, D = 128: the pre-pass's q codes and scales, k codes and
// scales (span a multiple of 128), v and o bf16 with element strides (sb, ss, sh).  No
// residuals (serving only).  Every stride and base must be 16-byte aligned (TMA).  Returns
// cudaGetLastError().
extern "C" int flash_attention_fwd_int8_wgmma(const void* qcodes, const float* qscale,
                                              const void* kcodes, const float* kscale,
                                              const void* v, void* o, int B, int H, int S, int D,
                                              long long sb, long long ss, long long sh,
                                              int cond_start, int mode, float cbias, float scale,
                                              int span, int nspan, void* stream) {
  if (D != fa3::D || mode < UNION || mode > CFACTOR || span <= 0 || span % fa3::BKV ||
      nspan != (S + span - 1) / span)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!fa3::codes_map(&mq, qcodes, B, H, S) || !fa3::codes_map(&mk, kcodes, B, H, S) ||
      !fa3::qkv_map(&mv, v, B, H, S, sb, ss, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  fa3::Args a = fa3::fwd_args(o, nullptr, nullptr, H, S, sb, ss, sh, cond_start, mode, cbias,
                              scale);
  a.qscale = qscale;
  a.kscale = kscale;
  a.span = span;
  a.nspan = nspan;
  return fa3::launch_fwd<true>(mq, mk, mv, a, B, static_cast<cudaStream_t>(stream));
}

namespace {

fa3::GradArgs grad_args(const float* m2, const float* l, const float* di, const float* cos,
                        const float* sin, void* dq, void* dk, void* dv, int H, int S,
                        long long sb, long long ss, long long sh, int cond_start, int mode,
                        float scale) {
  fa3::GradArgs a;
  a.m2 = m2;
  a.l = l;
  a.di = di;
  a.cos = cos;
  a.sin = sin;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.H = H;
  a.S = S;
  a.sb = sb;
  a.ss = ss;
  a.sh = sh;
  a.cond_start = cond_start;
  a.mode = mode;
  a.scale = scale;
  return a;
}

}  // namespace

// The dK/dV pass on wgmma, D = 128: q and k with element strides (qsb, qss, qsh) -- rotated
// (the RoPE pre-pass's head-major buffer) when cos/sin are given, else the inputs as they lie
// -- v, do, dk, dv with (sb, ss, sh); m2 / l / di fp32 [B, H, S]; cos/sin fp32 [S, 128] or null
// rotate dk back on store.  Every stride and base must be 16-byte aligned (TMA).  Returns
// cudaGetLastError().
extern "C" int flash_attention_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                             const void* dout, const float* m2, const float* l,
                                             const float* di, const float* cos, const float* sin,
                                             void* dk, void* dv, int B, int H, int S, int D,
                                             long long qsb, long long qss, long long qsh,
                                             long long sb, long long ss, long long sh,
                                             int cond_start, int mode, float scale,
                                             void* stream) {
  if (D != fa3::D) return static_cast<int>(cudaErrorInvalidValue);
  return fa3::grad_entry(true, q, k, v, dout,
                         grad_args(m2, l, di, cos, sin, nullptr, dk, dv, H, S, sb, ss, sh,
                                   cond_start, mode, scale),
                         B, H, S, qsb, qss, qsh, static_cast<cudaStream_t>(stream));
}

// The dQ pass on wgmma: the same inputs -> dq bf16 with (sb, ss, sh).
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* dout, const float* m2, const float* l,
                                            const float* di, const float* cos, const float* sin,
                                            void* dq, int B, int H, int S, int D, long long qsb,
                                            long long qss, long long qsh, long long sb,
                                            long long ss, long long sh, int cond_start,
                                            int mode, float scale, void* stream) {
  if (D != fa3::D) return static_cast<int>(cudaErrorInvalidValue);
  return fa3::grad_entry(false, q, k, v, dout,
                         grad_args(m2, l, di, cos, sin, dq, nullptr, nullptr, H, S, sb, ss, sh,
                                   cond_start, mode, scale),
                         B, H, S, qsb, qss, qsh, static_cast<cudaStream_t>(stream));
}
