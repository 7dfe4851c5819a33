// The S4D diagonal recurrence of the CS3 encoders, Hopper (sm_90a).
//
// Replaces the TPU kernel loongx_tpu/ops/s4_pallas.py::_s4d_scan_kernel (launched by
// _s4d_scan_pallas, pallas_call at :93): for every batch element b, channel h and complex state
// n (real/imag planes, fp32),
//   x_t = Abar x_{t-1} + Bbar u_t,   y_t = 2 sum_n Re(C x_t) + D u_t,
// sequential in t, fp32 state and y.
//
// What bounds it on this card: the work is small (the encoders' widest layer, L 4096 H 64 N 32,
// is 8.4 M state updates) and u and y are at most 2 MB, so the recurrence's dependent chain
// bounds the sequential kernel (s4d_scan_kernel): L updates of about 12 cycles each, about
// 25 us at L 4096 however wide the layer.  The chunked scan (s4d_chunk_scan_kernel, the default)
// cuts that chain; then the widest layer's fp32 instructions and its scattered 4-byte accesses
// (one channel a block of a [B, L, H] tensor: a 32-byte sector serves 8 channels) hold it.
//
// s4d_chunk_scan_kernel.  The recurrence is linear, so time splits into C chunks of T steps
// (`s4d_chunk_plan` in ops/s4_scan.py picks T, C and the block):
//   A. each chunk runs its recurrence from a zero state: its end state e_c;
//   B. one thread per state walks the chunks, X_c = Abar^T X_{c-1} + e_c, Abar^T by squaring
//      in fp64 (then rounded once), so X_c is the true state at the end of chunk c;
//   C. each chunk reruns its recurrence from X_{c-1} and stores y as it goes.
// The dependent chain is about 2T + C steps instead of L (192 at L 4096: T = C = 64).  A block
// holds the chunks of HB channels of one batch element; its threads are (chunk, channel, lane):
// NQ lanes (a power of two) share a channel's states, Q a lane (n = lane + NQ i), so the sum
// over n is register adds and a whole-warp shuffle, off the loop-carried chain (N 2-8: one lane
// holds the channel; N 32: NQ 4, Q 8, and the four lanes reduce-scatter the sums of four steps
// at a time).  Where a channel takes several lanes its work fills more than an SM, so a cluster
// of two blocks splits its chunks: the first walks its half and, once a first cluster barrier
// (arrived at the kernel's start) shows the second has started, stores its last X into the
// second's shared memory before a second barrier; the second walks on from it.  The state is
// carried as z = x / Bbar (z_t = Abar z_{t-1} + u_t, y_t = 2 sum_n Re(G z_t) + D u_t with
// G = C Bbar): 4 fp32 instructions an update and 2 fma for the term, against 11 for the
// separately rounded form.  The prologue discretises (discretise_real's operations, each
// rounded on its own, with the accurate expf / cosf / sinf and IEEE division; one thread a
// state, so a block has at least as many threads as states, into shared memory), u is staged
// in shared memory by cp.async (chunk c's steps T + 1 apart, so the lanes of different chunks
// read different banks): one launch a layer, on the encoders' fp32 u and y.  The result differs from the sequential recurrence only in rounding
// (the chunk carries, fma, the order of the sum over n): within 1e-4 of s4d_scan_plain at every
// encoder layer (the PyTorch model of this arithmetic in tests/test_torch_k64_scan_hopper.py).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.013 ms at EEG wide against the
// sequential kernel's 0.46.
//
// s4d_scan_kernel (the first, sequential form, kept for cuda_build.mma_sync_only(): the wrapper
// then discretises in PyTorch and passes fp32 u, the six [H, N] planes and D): one thread per
// (b, h, n) state holding (x_r, x_i) in registers; a block of 128 threads takes floor(128 / N)
// channels of one batch element.  Time runs in chunks of CHUNK steps staged in shared memory;
// each thread runs its recurrence over the chunk and writes its term c_r x_r - c_i x_i of every
// step to shared memory, and after a barrier the block reduces those terms over n (a sequential
// sum) into y.  The update and the term use separately rounded IEEE operations in the TPU
// kernel's order, so the state is bit for bit the plain version's; only the order of the sum
// over n differs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int CHUNK = 32;  // time steps per staged chunk (2 x 16 KB of shared memory)

__global__ void __launch_bounds__(NTHREADS)
s4d_scan_kernel(const float* __restrict__ u, const float* __restrict__ ar,
                const float* __restrict__ ai, const float* __restrict__ br,
                const float* __restrict__ bi, const float* __restrict__ cr,
                const float* __restrict__ ci, const float* __restrict__ d,
                float* __restrict__ y, int L, int H, int N, int HB) {
  __shared__ float us[CHUNK][NTHREADS];      // u of the block's channels (HB <= NTHREADS)
  __shared__ float terms[CHUNK][NTHREADS];   // c_r x_r - c_i x_i per (step, state)
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * HB;
  const int hb = min(HB, H - h0);            // channels of this block
  const int tid = threadIdx.x;
  const int hl = tid / N, n = tid % N;
  const bool active = hl < hb;
  const int h = h0 + hl;

  float a_r = 0.f, a_i = 0.f, b_r = 0.f, b_i = 0.f, c_r = 0.f, c_i = 0.f;
  if (active) {
    const int s = h * N + n;
    a_r = ar[s];
    a_i = ai[s];
    b_r = br[s];
    b_i = bi[s];
    c_r = cr[s];
    c_i = ci[s];
  }
  float x_r = 0.f, x_i = 0.f;
  const float* ub = u + (long long)b * L * H;
  float* yb = y + (long long)b * L * H;

  for (int t0 = 0; t0 < L; t0 += CHUNK) {
    const int steps = min(CHUNK, L - t0);
    for (int i = tid; i < steps * hb; i += NTHREADS) {
      const int t = i / hb, c = i % hb;
      us[t][c] = ub[(long long)(t0 + t) * H + h0 + c];
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int t = 0; t < steps; ++t) {
        const float ut = us[t][hl];
        // x = a x + b u in the TPU kernel's order, each operation rounded on its own
        const float nr = __fadd_rn(__fsub_rn(__fmul_rn(a_r, x_r), __fmul_rn(a_i, x_i)),
                                   __fmul_rn(b_r, ut));
        const float ni = __fadd_rn(__fadd_rn(__fmul_rn(a_i, x_r), __fmul_rn(a_r, x_i)),
                                   __fmul_rn(b_i, ut));
        x_r = nr;
        x_i = ni;
        terms[t][tid] = __fsub_rn(__fmul_rn(c_r, nr), __fmul_rn(c_i, ni));
      }
    }
    __syncthreads();
    for (int i = tid; i < steps * hb; i += NTHREADS) {
      const int t = i / hb, c = i % hb;
      float acc = 0.f;
      for (int k = 0; k < N; ++k) acc = __fadd_rn(acc, terms[t][c * N + k]);
      yb[(long long)(t0 + t) * H + h0 + c] =
          __fadd_rn(__fmul_rn(2.f, acc), __fmul_rn(d[h0 + c], us[t][c]));
    }
    __syncthreads();  // us and terms are rewritten by the next chunk
  }
}


// ---- the chunked scan ----------------------------------------------------------------------

constexpr int CS_MAX_Q = 8;  // states a lane

// A timing probe: built with -DS4D_PROBE_STOP=1, 2 or 3 the chunked kernel returns after
// staging, pass A or pass B (wrong results; scripts/wgmma_check.py s4d builds these).  0 runs it.
#ifndef S4D_PROBE_STOP
#define S4D_PROBE_STOP 0
#endif

// Threads a block may have: 512, so that a lane keeps its states, their parameters and a batch
// of u in registers (128 of them).
constexpr int CS_MAX_THREADS = 512;

struct ChunkArgs {
  const float* u;  // [B, L, H]
  float* y;        // [B, L, H]
  const float* log_a_re;  // [H, N]
  const float* a_im;      // [H, N]
  const float* log_dt;    // [H]
  const float* c;         // [H, N, 2]
  const float* d;         // [H]
  int L, H, N, T, C, HB, NQ;
  int CL;  // blocks a cluster: 1, or 2 splitting each channel's chunks in halves
};


struct Discrete {
  float ar, ai, br, bi;  // Abar and Bbar
};

// discretise_real (ops/s4.py) for state (h, n): its operations in its order, each rounded on
// its own, with the accurate expf / cosf / sinf and IEEE division.
__device__ __forceinline__ Discrete discretise(const ChunkArgs& p, int h, int n) {
  const int s = h * p.N + n;
  const float a_re = -expf(p.log_a_re[s]), a_im = p.a_im[s];
  const float dt = expf(p.log_dt[h]);
  const float dta_re = __fmul_rn(a_re, dt), dta_im = __fmul_rn(a_im, dt);
  const float mag = expf(dta_re);
  const float abar_r = __fmul_rn(mag, cosf(dta_im)), abar_i = __fmul_rn(mag, sinf(dta_im));
  const float denom = __fadd_rn(__fmul_rn(a_re, a_re), __fmul_rn(a_im, a_im));
  const float num_r = __fsub_rn(abar_r, 1.f), num_i = abar_i;
  return {abar_r, abar_i,
          __fdiv_rn(__fadd_rn(__fmul_rn(num_r, a_re), __fmul_rn(num_i, a_im)), denom),
          __fdiv_rn(__fsub_rn(__fmul_rn(num_i, a_re), __fmul_rn(num_r, a_im)), denom)};
}

// Shared memory of a block holding CC chunks: each state's Abar and G [HB][NP][4], u of the
// block's channels, chunk c's steps at rows c (T + 1) .. (padded: the lanes of different chunks
// read different banks), the chunks' end states [CC][HB][NP] complex and the end state of the
// cluster's block before [HB][NP] complex.  `s4d_chunk_plan` in ops/s4_scan.py computes the same.
__host__ __device__ constexpr int cs_smem_bytes(int T, int CC, int HB, int NP) {
  return 4 * (CC * (T + 1) * HB + 2 * CC * HB * NP + 4 * HB * NP + 2 * HB * NP);
}

// Stores v at `p` (an address in this block's shared memory) in the shared memory of block
// `rank` of the cluster.
__device__ __forceinline__ void st_cluster_f32(float* p, uint32_t rank, float v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(hopper::smem_u32(p)),
               "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

constexpr int CS_BATCH = 16;  // the walk's e a thread loads ahead
constexpr int CS_STEPS = 8;   // steps of u pass C loads ahead

// 4 bytes global -> shared without a register (all of a lane's copies in flight at once).
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// One step of a lane's Q states: z = Abar z + u, then the lane's share of sum_n Re(G z).
template <int Q>
__device__ __forceinline__ float step_terms(const float (&ar)[Q], const float (&ai)[Q],
                                            const float (&gr)[Q], const float (&gi)[Q],
                                            float (&zr)[Q], float (&zi)[Q], float u) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const float nr = fmaf(ar[s], zr[s], fmaf(-ai[s], zi[s], u));
    zi[s] = fmaf(ai[s], zr[s], ar[s] * zi[s]);
    zr[s] = nr;
    acc[s % 4] = fmaf(gr[s], zr[s], acc[s % 4]);
    acc[s % 4] = fmaf(-gi[s], zi[s], acc[s % 4]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int Q>
__global__ void __launch_bounds__(CS_MAX_THREADS)
s4d_chunk_scan_kernel(const ChunkArgs p) {
  extern __shared__ float smem[];
  const int T = p.T, C = p.C, HB = p.HB, NQ = p.NQ, NP = Q * NQ, CL = p.CL, CC = C / CL;
  float* prm = smem;  // 16-byte aligned: read as float4
  float* us = prm + 4 * HB * NP;
  float* ex = us + CC * (T + 1) * HB;
  float* xin = ex + 2 * CC * HB * NP;
  // the cluster's blocks split a channel's chunks: rank r holds chunks r CC .. (r + 1) CC - 1
  const int rank = CL > 1 ? static_cast<int>(hopper::cluster_ctarank()) : 0, j0 = rank * CC;
  const int b = blockIdx.y, h0 = (blockIdx.x / CL) * HB, hb = min(HB, p.H - h0);
  const int tid = threadIdx.x;
  // thread = (chunk jl of the block, channel hl, lane q): the NQ lanes of a (chunk, channel) are
  // adjacent and aligned in their warp; lane q holds states n = q + NQ i
  const int q = tid % NQ, grp = tid / NQ, hl = grp % HB, jl = grp / HB, j = j0 + jl;
  // the cluster's blocks meet here and again after the walk's hand-over: the first block writes
  // into the second's shared memory only after the second has arrived (it has started)
  if (CL > 1) hopper::cluster_arrive();
  const bool active = jl < CC && hl < hb;
  const int steps = active ? min(T, p.L - j * T) : 0;
  float* uc = us + jl * (T + 1) * HB + hl;  // step k of the chunk at uc[k * HB]
  const long long base = (long long)b * p.L * p.H + h0 + hl + (long long)j * T * p.H;

  // u -> shared by cp.async, all of a lane's copies in flight: each chunk's lanes take its
  // steps q, q + NQ, ...
  const float* ug = p.u + base;
  for (int k = q; k < steps; k += NQ) cp_async4(uc + k * HB, ug + (long long)k * p.H);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // one thread a state (the block has at least HB NP threads): Abar and G = C Bbar (a state past
  // N stays zero and adds nothing), and for the walk Abar^T by squaring in fp64
  const bool walker = tid < hb * NP && C > 1;  // state tid of the block's [HB][NP]
  float pw_r = 0.f, pw_i = 0.f;
  if (tid < hb * NP) {
    const int hw = h0 + tid / NP, n = tid % NP;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < p.N) {
      const Discrete z = discretise(p, hw, n);
      const float cr = p.c[2 * (hw * p.N + n)], ci = p.c[2 * (hw * p.N + n) + 1];
      v = make_float4(z.ar, z.ai, __fsub_rn(__fmul_rn(cr, z.br), __fmul_rn(ci, z.bi)),
                      __fadd_rn(__fmul_rn(cr, z.bi), __fmul_rn(ci, z.br)));
      double pr = 1.0, pi = 0.0, br = z.ar, bi = z.ai;
      for (int e = T; e > 0; e >>= 1) {
        if (e & 1) {
          const double r = pr * br - pi * bi;
          pi = pr * bi + pi * br;
          pr = r;
        }
        const double r = br * br - bi * bi;
        bi = 2.0 * br * bi;
        br = r;
      }
      pw_r = static_cast<float>(pr);
      pw_i = static_cast<float>(pi);
    }
    reinterpret_cast<float4*>(prm)[tid] = v;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (S4D_PROBE_STOP == 1) return;

  float ar[Q], ai[Q], gr[Q], gi[Q], zr[Q], zi[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const float4 v = active ? reinterpret_cast<const float4*>(prm)[hl * NP + q + NQ * s]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    ar[s] = v.x;
    ai[s] = v.y;
    gr[s] = v.z;
    gi[s] = v.w;
  }
  const float dh = active ? p.d[h0 + hl] : 0.f;
  float* ej = ex + ((jl * HB + hl) * NP + q) * 2;  // state q + NQ i at ej[2 NQ i]

  // A: the chunk's recurrence from a zero state (the last chunk's end is never carried)
  if (active && j + 1 < C) {
#pragma unroll
    for (int s = 0; s < Q; ++s) zr[s] = zi[s] = 0.f;
#pragma unroll 4
    for (int k = 0; k < steps; ++k) {
      const float u = uc[k * HB];
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const float nr = fmaf(ar[s], zr[s], fmaf(-ai[s], zi[s], u));
        zi[s] = fmaf(ai[s], zr[s], ar[s] * zi[s]);
        zr[s] = nr;
      }
    }
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      ej[2 * NQ * s] = zr[s];
      ej[2 * NQ * s + 1] = zi[s];
    }
  }
  __syncthreads();
  if (S4D_PROBE_STOP == 2) return;

  // B: one thread a state walks the block's chunks, X_c = Abar^T X_{c-1} + e_c in place of e_c
  // (the e of CS_BATCH chunks loaded ahead of their updates, off the chain), up to the last
  // chunk whose end state a later chunk needs; the cluster's second block starts from the first
  // one's last X, which that block stores into its shared memory before the second barrier
  if (CL > 1 && rank > 0) {
    hopper::cluster_wait();
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
  float xr = 0.f, xi = 0.f;
  if (walker) {
    float* e0 = ex + tid * 2;
    const int stride = 2 * HB * NP;
    const int last = j0 + CC < C ? CC - 1 : CC - 2;  // local index
    xr = e0[0];
    xi = e0[1];
    if (rank > 0) {
      const float ir = xin[2 * tid], ii = xin[2 * tid + 1];
      xr = fmaf(pw_r, ir, fmaf(-pw_i, ii, xr));
      xi = fmaf(pw_i, ir, fmaf(pw_r, ii, xi));
      e0[0] = xr;
      e0[1] = xi;
    }
    for (int c0 = 1; c0 <= last; c0 += CS_BATCH) {
      float er[CS_BATCH], ei[CS_BATCH];
#pragma unroll
      for (int i = 0; i < CS_BATCH; ++i) {
        const bool in = c0 + i <= last;
        er[i] = in ? e0[(c0 + i) * stride] : 0.f;
        ei[i] = in ? e0[(c0 + i) * stride + 1] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < CS_BATCH; ++i) {
        if (c0 + i <= last) {
          const float nr = fmaf(pw_r, xr, fmaf(-pw_i, xi, er[i]));
          xi = fmaf(pw_i, xr, fmaf(pw_r, xi, ei[i]));
          xr = nr;
          e0[(c0 + i) * stride] = xr;
          e0[(c0 + i) * stride + 1] = xi;
        }
      }
    }
  }
  if (CL > 1 && rank + 1 < CL) {
    hopper::cluster_wait();  // the second block has started: its shared memory may be written
    if (walker) {
      st_cluster_f32(xin + 2 * tid, rank + 1, xr);
      st_cluster_f32(xin + 2 * tid + 1, rank + 1, xi);
    }
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
  __syncthreads();
  if (S4D_PROBE_STOP == 3) return;

  // C: the chunk again from the carried state, y stored as it comes.  Every lane of the block
  // takes the same steps (a shorter or idle chunk's extra steps read and write nothing), so the
  // sum over a chunk's lanes is a whole-warp shuffle.  NQ 4 (N 32): four steps at a time, each
  // lane's partial sums of the four reduce-scattered over the chunk's lanes (3 shuffles, not 8),
  // lane q storing step k0 + q; otherwise a step at a time, lane 0 storing it.
  const float* xprev = jl > 0 ? ej - 2 * HB * NP : xin + (hl * NP + q) * 2;
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    zr[s] = active && j > 0 ? xprev[2 * NQ * s] : 0.f;
    zi[s] = active && j > 0 ? xprev[2 * NQ * s + 1] : 0.f;
  }
  float* yg = p.y + base;
  if (NQ == 4) {
    for (int k0 = 0; k0 < T; k0 += 4) {
      float ub[4], part[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ub[i] = k0 + i < steps ? uc[(k0 + i) * HB] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i] = step_terms<Q>(ar, ai, gr, gi, zr, zi, ub[i]);
      const bool odd = q & 1, high = q & 2;
      float a0 = high ? part[2] : part[0], a1 = high ? part[3] : part[1];
      a0 += __shfl_xor_sync(0xffffffffu, high ? part[0] : part[2], 2);
      a1 += __shfl_xor_sync(0xffffffffu, high ? part[1] : part[3], 2);
      const float sum = (odd ? a1 : a0) + __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
      const float u = q == 0 ? ub[0] : q == 1 ? ub[1] : q == 2 ? ub[2] : ub[3];
      if (k0 + q < steps) yg[(long long)(k0 + q) * p.H] = fmaf(2.f, sum, dh * u);
    }
    return;
  }
  for (int k0 = 0; k0 < T; k0 += CS_STEPS) {
    float ub[CS_STEPS];  // the batch's u, loaded ahead of its steps
#pragma unroll
    for (int i = 0; i < CS_STEPS; ++i) ub[i] = k0 + i < steps ? uc[(k0 + i) * HB] : 0.f;
#pragma unroll
    for (int i = 0; i < CS_STEPS; ++i) {
      float sum = step_terms<Q>(ar, ai, gr, gi, zr, zi, ub[i]);
      for (int off = NQ / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (q == 0 && k0 + i < steps)
        yg[(long long)(k0 + i) * p.H] = fmaf(2.f, sum, dh * ub[i]);
    }
  }
}

template <int Q>
cudaError_t launch_chunked(const ChunkArgs& p, int B, int threads, int smem, cudaStream_t st) {
  if (threads > CS_MAX_THREADS) return cudaErrorInvalidValue;
  auto* kernel = s4d_chunk_scan_kernel<Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.H + p.HB - 1) / p.HB * p.CL, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_q(int q, const ChunkArgs& p, int B, int threads, int smem, cudaStream_t st) {
  switch (q) {
    case 1: return launch_chunked<1>(p, B, threads, smem, st);
    case 2: return launch_chunked<2>(p, B, threads, smem, st);
    case 3: return launch_chunked<3>(p, B, threads, smem, st);
    case 4: return launch_chunked<4>(p, B, threads, smem, st);
    case 5: return launch_chunked<5>(p, B, threads, smem, st);
    case 6: return launch_chunked<6>(p, B, threads, smem, st);
    case 7: return launch_chunked<7>(p, B, threads, smem, st);
    case 8: return launch_chunked<8>(p, B, threads, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// u, y: fp32 [B, L, H] contiguous; ar..ci: fp32 [H, N] contiguous; d: fp32 [H].
// Requires 1 <= N <= 128.  Returns cudaGetLastError().
extern "C" int s4d_scan(const float* u, const float* ar, const float* ai, const float* br,
                        const float* bi, const float* cr, const float* ci, const float* d,
                        float* y, int B, int L, int H, int N, void* stream) {
  if (N < 1 || N > NTHREADS || B < 1 || L < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hb = NTHREADS / N;
  const dim3 grid((H + hb - 1) / hb, B);
  s4d_scan_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      u, ar, ai, br, bi, cr, ci, d, y, L, H, N, hb);
  return static_cast<int>(cudaGetLastError());
}

// The chunked scan: u, y fp32 [B, L, H] contiguous; log_a_re, a_im [H, N], log_dt [H], c
// [H, N, 2], d [H], fp32 contiguous; `s4d_chunk_plan`'s T steps a chunk, C chunks, HB channels a
// block, NQ lanes a channel (a power of two up to 32), Q states a lane (1..8, Q NQ >= N) and CL
// blocks a cluster (2: a channel's chunks in halves, HB 1), `threads` = the larger of C / CL HB NQ
// (the lanes) and HB Q NQ (the block's states) rounded up to whole warps.  Anything else returns
// cudaErrorInvalidValue.  Returns cudaGetLastError().
extern "C" int s4d_chunk_scan(const float* u, float* y, const float* log_a_re, const float* a_im,
                              const float* log_dt, const float* c, const float* d, int B, int L,
                              int H, int N, int T, int C, int HB, int NQ, int Q, int CL,
                              int threads, void* stream) {
  const bool nq_ok = NQ >= 1 && NQ <= 32 && (NQ & (NQ - 1)) == 0;
  if (B < 1 || L < 1 || H < 1 || N < 1 || T < 1 || C < 1 || HB < 1 || !nq_ok || Q < 1 ||
      Q > CS_MAX_Q || Q * NQ < N || (C - 1) * T >= L || C * T < L || (CL != 1 && CL != 2) ||
      C % CL || (CL > 1 && HB != 1) ||
      threads != (max(C / CL * NQ, Q * NQ) * HB + 31) / 32 * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = cs_smem_bytes(T, C / CL, HB, Q * NQ);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const ChunkArgs p{u, y, log_a_re, a_im, log_dt, c, d, L, H, N, T, C, HB, NQ, CL};
  return static_cast<int>(launch_q(Q, p, B, threads, smem, static_cast<cudaStream_t>(stream)));
}
