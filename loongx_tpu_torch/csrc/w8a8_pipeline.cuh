// The persistent W8A8 GEMM pipeline on wgmma for Hopper (sm_90a), one body for two kernels:
// qmm_wgmma_kernel (csrc/quant_matmul.cu: the dense linears, one group of every row) and
// moe_gemm_kernel (csrc/moe_gemm.cu: row groups read from device memory, one weight slice a
// group).  Each kernel keeps its own __global__ name, so a profiler's trace tells them apart,
// and passes its epilogue in.
//
// One producer thread keeps a ring of STAGES tiles in flight by TMA, A (the int8 codes [M, Kp],
// k-contiguous, 128 rows x 128 k bytes) and the raw weight tile as it is stored ([K, N],
// n-contiguous, 128 k rows x 128 n bytes); a transposing warpgroup writes each weight tile
// K-major into the 128-byte-swizzled B buffer (8-bit wgmma takes B only K-major), off the MMA's
// critical path; two consumer warpgroups of 64 rows run wgmma m64n128k32 s8 x s8 -> s32 over one
// activation group, then fold facc += float(iacc) * x_scale[row, group] (__fmul_rn, __fadd_rn:
// _accum_tile's order, as the mma.sync kernel) and restart the integer sums.  The epilogue takes
// the 64 x 128 fp32 tile (the wgmma C fragment) and a 64 x 128 bf16 staging tile in shared
// memory.  One persistent block per SM walks the output tiles with M fastest: the blocks in
// flight share weight tiles, so the weight streams from device memory about once while the
// activations stay in L2; the ring's stage counter runs on across tiles, so the next tile's
// loads overlap this tile's epilogue.
//
// Grouped launches: group g holds rows [start[g], end[g]), every group's first row a multiple
// of BM (so no tile straddles two groups), and reads the g-th [K, N] slice of a [G, K, N] weight
// (B rows g * K ..).  A tile whose first row lies in no group (padding, or the buffer's tail) is
// skipped by every warpgroup alike, at the cost of a look-up in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace w8a8_pipe {

constexpr int BM = 128, BN = 128, BK = 128;  // BK: k bytes per stage
constexpr int STAGES = 4;
constexpr int TILE = BM * BK;  // bytes of one A, raw-B or transposed-B tile
// warpgroups: two consumers, the transposer, the producer (one thread issues TMA); entry
// registers 65536 / 512 = 128, then 208 for the consumers, 72 for the transposer and 24 for the
// producer: 2 x 80 x 128 = 56 x 128 + 104 x 128 moved
constexpr int CONSUMERS = 256, TRANSPOSERS = 128, THREADS = CONSUMERS + TRANSPOSERS + 128;
constexpr int ENTRY_REGS = 128;
constexpr int OUT_TILE = 64 * BN * 2;  // one consumer warpgroup's bf16 output tile
constexpr int SMEM_BYTES = 3 * STAGES * TILE + 2 * OUT_TILE + 3 * STAGES * 8 + 1024;

// 4 rows of 4 int8 (one word each) -> the 4 columns (one word each).
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t (&col)[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One transposing thread's share of a stage: 16 k rows x 8 n bytes of the raw tile (row k at
// k * 128, chunk c at c ^ (k % 8)) -> 8 n rows x 16 k bytes of the B tile (row n, k chunk kc
// at kc ^ (n % 8)).  Thread t takes n bytes 8 * (t % 16).. and k rows 16 * kc.. with
// kc = (t / 16 + t) % 8: both the 8-byte loads of a half-warp and the 16-byte stores of a
// quarter-warp fall on distinct banks.
__device__ __forceinline__ void transpose_stage(const uint8_t* raw, uint8_t* bt, int t) {
  const int nc8 = t % 16, kc = (t / 16 + t) % 8;
  uint2 r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = 16 * kc + i;
    r[i] = *reinterpret_cast<const uint2*>(raw + k * 128 + (((nc8 / 2) ^ (k % 8)) * 16) +
                                           (nc8 % 2) * 8);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // n bytes 0..3, then 4..7, of the thread's 8
    uint32_t out[4][4];                   // [n][k word q]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t c[4];
      if (half == 0)
        transpose4x4(r[4 * q].x, r[4 * q + 1].x, r[4 * q + 2].x, r[4 * q + 3].x, c);
      else
        transpose4x4(r[4 * q].y, r[4 * q + 1].y, r[4 * q + 2].y, r[4 * q + 3].y, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j][q] = c[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * nc8 + 4 * half + j;
      *reinterpret_cast<uint4*>(bt + n * 128 + ((kc ^ (n % 8)) * 16)) =
          make_uint4(out[j][0], out[j][1], out[j][2], out[j][3]);
    }
  }
}

// The group of the tile whose first row is m0, or -1 where the tile holds no row of a group.
__device__ __forceinline__ int tile_group(int m0, const int* start, const int* end, int G) {
  for (int g = 0; g < G; ++g)
    if (m0 < start[g + 1]) return m0 < end[g] ? g : -1;
  return -1;
}

// The pipeline over one launch.  `p` gives xs (fp32 [M, n_groups] activation scales), M, N, Kp
// (k bytes of an A row, whole stages), K (B rows of one group's weight slice), group (k of an
// activation group, whole stages), n_groups and prep_b (0 skips the B-tile transpose: a timing
// probe of its share).  GROUPED reads the row groups from start / end (shared memory, G of them);
// otherwise every row is group 0.  `smem` is the kernel's dynamic shared memory (SMEM_BYTES).
// Each output tile ends in epilogue(facc, g, m0, n0, stage).
template <bool GROUPED, class Args, class Epilogue>
__device__ __forceinline__ void run(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                    const Args& p, const int* start, const int* end, int G,
                                    uint8_t* smem, const Epilogue& epilogue) {
  uint8_t* base = smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023);
  uint8_t* sa = base;
  uint8_t* sraw = base + STAGES * TILE;
  uint8_t* sbt = base + 2 * STAGES * TILE;
  uint8_t* sout = base + 3 * STAGES * TILE;  // two 64 x 128 bf16 output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sout + 2 * OUT_TILE);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int mtiles = (p.M + BM - 1) / BM;
  const int tiles = mtiles * ((p.N + BN - 1) / BN);
  const int nk = p.Kp / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], TRANSPOSERS);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS + TRANSPOSERS) {
    // producer warpgroup: one thread issues the TMA loads
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS + TRANSPOSERS) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mtiles) * BM, n0 = (tile / mtiles) * BN;
        int g = 0;
        if (GROUPED) {
          g = tile_group(m0, start, end, G);
          if (g < 0) continue;
        }
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * TILE);
          hopper::tma_load_2d(sa + s * TILE, map_a, &full[s], j * BK, m0);
          hopper::tma_load_2d(sraw + s * TILE, map_b, &full[s], n0,
                              GROUPED ? g * p.K + j * BK : j * BK);
        }
      }
    }
  } else if (threadIdx.x >= CONSUMERS) {
    // transposing warpgroup: raw weight tile -> K-major swizzled B tile
    hopper::setmaxnreg_dec<72>();
    const int t = threadIdx.x - CONSUMERS;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      if (GROUPED && tile_group((tile % mtiles) * BM, start, end, G) < 0) continue;
      for (int j = 0; j < nk; ++j, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        if (p.prep_b) transpose_stage(sraw + s * TILE, sbt + s * TILE, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&ready[s]);
      }
    }
  } else {
    hopper::setmaxnreg_inc<208>();
    const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gr = lane / 4;
    const int per_group = p.group / BK;
    uint8_t* stage = sout + wgi * OUT_TILE;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mtiles) * BM, n0 = (tile / mtiles) * BN;
      int g = 0;
      if (GROUPED) {
        g = tile_group(m0, start, end, G);
        if (g < 0) continue;
      }
      const int row0 = m0 + wgi * 64 + warp * 16 + gr, row1 = row0 + 8;
      int iacc[64];
      float facc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        iacc[i] = 0;
        facc[i] = 0.f;
      }
      // one activation group at a time: its k tiles accumulate in iacc with one wgmma group in
      // flight behind the one being issued, then the group's products fold into facc
      for (int g0 = 0; g0 < nk; g0 += per_group) {
        int pending = -1;  // the stage whose wgmma may still read its tiles
        for (int j = g0; j < g0 + per_group; ++j, ++it) {
          const int s = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          hopper::mbar_wait(&full[s], ph);
          hopper::mbar_wait(&ready[s], ph);
          const uint64_t da = hopper::desc_sw128(sa + s * TILE + wgi * 64 * BK, 16, 1024);
          const uint64_t db = hopper::desc_sw128(sbt + s * TILE, 16, 1024);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            hopper::wgmma_m64n128k32_s8(iacc, da + 2 * kk, db + 2 * kk, j > g0 || kk > 0);
          hopper::wgmma_commit();
          // the previous stage's products are done: release its tiles
          hopper::wgmma_wait<1>();
          if (pending >= 0 && lane == 0) hopper::mbar_arrive(&empty[pending]);
          pending = s;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operands(iacc);
        if (lane == 0) hopper::mbar_arrive(&empty[pending]);
        // acc += float(i32) * x_scale(row, group)
        const int gi = g0 / per_group;
        const float xs0 = row0 < p.M ? p.xs[(long long)row0 * p.n_groups + gi] : 0.f;
        const float xs1 = row1 < p.M ? p.xs[(long long)row1 * p.n_groups + gi] : 0.f;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          facc[i] = __fadd_rn(facc[i], __fmul_rn(static_cast<float>(iacc[i]),
                                                 (i % 4) < 2 ? xs0 : xs1));
      }
      epilogue(facc, g, m0, n0, stage);
    }
  }
}

inline int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

// Launches `kernel`, a __global__ (map_a, map_b, args) around `run`, over `tiles` output tiles:
// one persistent block an SM at most.  regs_ok: the kernel's entry registers are ENTRY_REGS
// (hopper::entry_regs_are, asked once per kernel by the caller), which setmaxnreg's split needs.
template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, bool regs_ok, const CUtensorMap& ma, const CUtensorMap& mb,
                   const Args& p, int tiles, cudaStream_t st) {
  if (!regs_ok || num_sms() == 0) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = tiles < num_sms() ? tiles : num_sms();
  kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(ma, mb, p);
  return cudaGetLastError();
}

}  // namespace w8a8_pipe
