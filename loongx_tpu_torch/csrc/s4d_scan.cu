// The S4D diagonal recurrence of the CS3 encoders, Hopper (sm_90a).
//
// Replaces the TPU kernel loongx_tpu/ops/s4_pallas.py::_s4d_scan_kernel (launched by
// _s4d_scan_pallas, pallas_call at :93): for every batch element b, channel h and complex state
// n (real/imag planes, fp32),
//   x_t = Abar x_{t-1} + Bbar u_t,   y_t = 2 sum_n Re(C x_t) + D u_t,
// sequential in t.  The wrapper (ops/s4_scan.py) discretises in plain PyTorch, as the TPU path
// does outside its kernel, and passes u as fp32 [B, L, H], the six [H, N] planes and D [H];
// y is fp32 [B, L, H].
//
// What bounds it on this card: the work is tiny (about 14 flops per (b, t, h, n) against 8
// bytes of u and y per (b, t, h)), so neither the bytes (at most 2 MB, under a microsecond at
// 3.35 TB/s) nor the operations bound it: the recurrence does.  Every step of a state waits
// for the previous one, so the least time is L times the dependent latency of one complex
// update, x_r' = (ar x_r - ai x_i) + br u: a multiply, a subtract and an add, about 12 cycles,
// some 6 ns at 1.98 GHz, so about 25 us at L 4096 whatever the width.  The latency term
// dominates at every shape of the encoders.
//
// Design, kept simple: one thread per (b, h, n) state holding (x_r, x_i) in registers; a
// block of 128 threads takes floor(128 / N) channels of one batch element, so at N 2 or 3 a
// block holds 64 or 42 channels and no warp is spent on a single (b, h).  Time runs in chunks
// of CHUNK steps: the block stages u[b, t0:t0 + CHUNK, h0:h0 + HB] in shared memory, each
// thread runs its recurrence over the chunk and writes its term c_r x_r - c_i x_i of every
// step to shared memory, and after a barrier the block reduces those terms over n (a
// sequential sum, n = 0..N-1) into y.  The reduction reads the state only through shared
// memory, off the loop-carried chain.  The update and the term use separately rounded IEEE
// operations in the TPU kernel's order (no fma contraction), so the state is bit for bit the
// plain version's (s4d_scan_plain); only the order of the sum over n differs.

#include <cuda_runtime.h>
#include <stdint.h>

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
