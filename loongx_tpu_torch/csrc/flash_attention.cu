// Flash-attention forward for the unified [txt | img | cond] sequence, Hopper (sm_90a).
//
// Replaces the TPU kernel loongx_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd, pallas_call at :512): exact softmax attention with an fp32 online softmax,
// block masks built from the scalar cond_start (union / no_union / independent), an
// additive log(c_factor) bias that replaces the masks, padded keys masked, and
// interleaved-pair RoPE applied to q and k as their tiles load.
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
// pipeline, no wgmma): two blocks per SM hide part of the latency.  Faster forms (wgmma, TMA,
// warp specialisation) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* base,
                                          long long ss, int r0, int S, const float* cos,
                                          const float* sin) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, c8 = (c % CHUNKS) * 8;
    const int s = r0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (s < S) {
      raw = *reinterpret_cast<const uint4*>(base + (long long)s * ss + c8);
      if (cos != nullptr) {
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
        raw.x = pack_bf16(out[0], out[1]);
        raw.y = pack_bf16(out[2], out[3]);
        raw.z = pack_bf16(out[4], out[5]);
        raw.w = pack_bf16(out[6], out[7]);
      }
    }
    *reinterpret_cast<uint4*>(smem + r * (D + PAD) + c8) = raw;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 const float* __restrict__ cos, const float* __restrict__ sin, int S,
                 long long sb, long long ss, long long sh, int cond_start, int mode,
                 float cbias, float scale) {
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 smem[2 * BKV * LD];  // K | V tiles, or the Q tile
  __nv_bfloat16* ks = smem;
  __nv_bfloat16* vs = smem + BKV * LD;
  constexpr int KSTEPS = D / 16;   // k-steps of the QK^T product
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
  load_tile<D, BQ>(smem, q + head, ss, q0, S, cos, sin);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(ks + (wr + g) * LD + c);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(ks + (wr + g + 8) * LD + c);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(ks + (wr + g) * LD + c + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(ks + (wr + g + 8) * LD + c + 8);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_id[2] = {q0 + wr + g, q0 + wr + g + 8};
  const bool row_cond[2] = {row_id[0] >= cond_start, row_id[1] >= cond_start};

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous K/V (or Q) tile
    load_tile<D, BKV>(ks, k + head, ss, kv0, S, cos, sin);
    load_tile<D, BKV>(vs, v + head, ss, kv0, S, nullptr, nullptr);
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[BKV / 8][4];
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

  // normalise (l == 0 guarded like the TPU kernel) and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_id[r] >= S) continue;
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

}  // namespace

// q, k, v, o: bf16 with element strides (sb, ss, sh) for (batch, seq, head) and a unit
// head-dim stride; cos/sin: fp32 [S, D] or null.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const float* cos, const float* sin, int B, int H, int S,
                                   int D, long long sb, long long ss, long long sh,
                                   int cond_start, int mode, float cbias, float scale,
                                   void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, op, cos, sin, S, sb, ss, sh,
                                                     cond_start, mode, cbias, scale);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, op, cos, sin, S, sb, ss, sh,
                                                    cond_start, mode, cbias, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
