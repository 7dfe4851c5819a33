// The persistent W8A8 GEMM pipeline on wgmma for Hopper (sm_90a), one body for two kernels:
// qmm_wgmma_kernel (csrc/quant_matmul.cu: the dense linears, one group of every row) and
// moe_gemm_kernel (csrc/moe_gemm.cu: row groups read from device memory, one weight slice a
// group).  Each kernel keeps its own __global__ name, so a profiler's trace tells them apart,
// and passes its epilogue in.
//
// The weight arrives K-major: [N, K] in memory (k contiguous), the layout 8-bit wgmma takes for
// B, so both operands land by TMA exactly as wgmma reads them.  One producer thread keeps a ring
// of STAGES stages in flight, each an A tile (the int8 codes [M, Kp], 128 rows x 128 k bytes)
// and a B tile (128 n rows x 128 k bytes of the weight), both under TMA's 128-byte swizzle; two
// consumer warpgroups of 64 rows run wgmma m64n128k32 s8 x s8 -> s32 over one activation group,
// then fold facc += float(iacc) * x_scale[row, group] (__fmul_rn, __fadd_rn: _accum_tile's
// order, as the mma.sync kernel) and restart the integer sums.  The epilogue takes the 64 x 128
// fp32 tile (the wgmma C fragment) and a 64 x 128 bf16 staging tile in shared memory.  One
// persistent block per SM walks the output tiles with M fastest: the blocks in flight share
// weight tiles, so the weight streams from device memory about once while the activations stay
// in L2; the ring's stage counter runs on across tiles, so the next tile's first STAGES stages
// load while this tile's epilogue runs.
//
// What a stage moves through shared memory: 32 KB written by TMA and 48 KB read by wgmma (each
// consumer its 8 KB of A and the whole 16 KB B tile), 80 KB against 491 cycles of int8 tensor
// work at the data sheet's rate; at 128 bytes a cycle that is about 625 cycles.  The build with
// -DW8A8_PROBE (scripts/wgmma_check.py probe) counts the cycles of each phase.  On an H100 at
// M 2560 K 3072 N 12288 + gelu a consumer warpgroup waits 220 cycles a stage for its tiles and
// spends 237 on its wgmma, near the tensor work; a fold takes 1661 and the gelu epilogue 13822
// a 24-stage tile, unoverlapped.  An epilogue warpgroup of its own, handed the fp32 tile through
// shared memory, measured no faster: alone it took 29385 cycles over a tile's gelu epilogue.
//
// Grouped launches: group g holds rows [start[g], end[g]), every group's first row a multiple
// of BM (so no tile straddles two groups), and reads the g-th [N, K] slice of a [G, N, K] weight
// (B rows g * N ..).  A tile whose first row lies in no group (padding, or the buffer's tail) is
// skipped by both roles alike, at the cost of a look-up in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#ifndef W8A8_STAGES
#define W8A8_STAGES 6
#endif

namespace w8a8_pipe {

constexpr int BM = 128, BN = 128, BK = 128;  // BK: k bytes per stage
constexpr int STAGES = W8A8_STAGES;
constexpr int TILE = BM * BK;  // bytes of one A or B tile
// warpgroups: two consumers, the producer (one thread issues TMA); entry registers 65536 / 384
// = 168, then 240 for the consumers and 24 for the producer: 2 x 72 x 128 = 144 x 128 moved
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int ENTRY_REGS = 168;
constexpr int OUT_TILE = 64 * BN * 2;  // one consumer warpgroup's bf16 output tile
constexpr int SMEM_BYTES = 2 * STAGES * TILE + 2 * OUT_TILE + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "the ring exceeds a block's shared memory");

// 4 rows of 4 int8 (one word each) -> the 4 columns (one word each).  The split-K and K 64
// kernels of quant_matmul.cu transpose their [K, N] weight panels with it.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t (&col)[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

#ifdef W8A8_PROBE
// The stage probe (a build of its own): clock64 cycles summed over every block, by the first
// thread of each consumer warpgroup (the full-barrier waits, the wgmma issue up to the previous
// stage's retirement, the last wgmma's wait with the fold, the epilogue, the whole loop) and by
// the producer thread (its empty-barrier waits); then the stages, folds and tiles a consumer
// warpgroup ran.  w8a8_probe_read copies them out.
enum Probe {
  P_FULL_WAIT, P_MMA, P_FOLD, P_EPILOGUE, P_CONSUMER_LOOP, P_EMPTY_WAIT, P_STAGES, P_FOLDS,
  P_TILES, P_COUNT
};
__device__ unsigned long long probe_sums[P_COUNT];
#define W8A8_CLOCK(v) const long long v = clock64()
#define W8A8_ADD(slot, cycles) \
  if (rec) probe[slot] += static_cast<unsigned long long>(cycles)
#else
#define W8A8_CLOCK(v)
#define W8A8_ADD(slot, cycles)
#endif

// The group of the tile whose first row is m0, or -1 where the tile holds no row of a group.
__device__ __forceinline__ int tile_group(int m0, const int* start, const int* end, int G) {
  for (int g = 0; g < G; ++g)
    if (m0 < start[g + 1]) return m0 < end[g] ? g : -1;
  return -1;
}

// The pipeline over one launch.  `p` gives xs (fp32 [M, n_groups] activation scales), M, N, Kp
// (k bytes of an A row, whole stages), group (k of an activation group, whole stages) and
// n_groups.  map_b covers the weight K-major, [N, K] (GROUPED: [G N, K], group g's rows from
// g N).  GROUPED reads the row groups from start / end (shared memory, G of them); otherwise
// every row is group 0.  `smem` is the kernel's dynamic shared memory (SMEM_BYTES).  Each output
// tile ends in epilogue(facc, g, m0, n0, stage).
template <bool GROUPED, class Args, class Epilogue>
__device__ __forceinline__ void run(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                    const Args& p, const int* start, const int* end, int G,
                                    uint8_t* smem, const Epilogue& epilogue) {
  uint8_t* base = smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023);
  uint8_t* sa = base;
  uint8_t* sb = base + STAGES * TILE;
  uint8_t* sout = base + 2 * STAGES * TILE;  // two 64 x 128 bf16 output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sout + 2 * OUT_TILE);
  uint64_t* empty = full + STAGES;

  const int mtiles = (p.M + BM - 1) / BM;
  const int tiles = mtiles * ((p.N + BN - 1) / BN);
  const int nk = p.Kp / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
#ifdef W8A8_PROBE
  unsigned long long probe[P_COUNT] = {};
  const bool rec = threadIdx.x % 128 == 0;
#endif

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues the TMA loads
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
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
          W8A8_CLOCK(t0);
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          W8A8_CLOCK(t1);
          W8A8_ADD(P_EMPTY_WAIT, t1 - t0);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * TILE);
          hopper::tma_load_2d(sa + s * TILE, map_a, &full[s], j * BK, m0);
          hopper::tma_load_2d(sb + s * TILE, map_b, &full[s], j * BK,
                              GROUPED ? g * p.N + n0 : n0);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gr = lane / 4;
    const int per_group = p.group / BK;
    uint8_t* stage = sout + wgi * OUT_TILE;
    W8A8_CLOCK(t_loop);
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
          W8A8_CLOCK(t0);
          hopper::mbar_wait(&full[s], (it / STAGES) & 1);
          W8A8_CLOCK(t1);
          const uint64_t da = hopper::desc_sw128(sa + s * TILE + wgi * 64 * BK, 16, 1024);
          const uint64_t db = hopper::desc_sw128(sb + s * TILE, 16, 1024);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            hopper::wgmma_m64n128k32_s8(iacc, da + 2 * kk, db + 2 * kk, j > g0 || kk > 0);
          hopper::wgmma_commit();
          // the previous stage's products are done: release its tiles
          hopper::wgmma_wait<1>();
          if (pending >= 0 && lane == 0) hopper::mbar_arrive(&empty[pending]);
          pending = s;
          W8A8_CLOCK(t2);
          W8A8_ADD(P_FULL_WAIT, t1 - t0);
          W8A8_ADD(P_MMA, t2 - t1);
          W8A8_ADD(P_STAGES, 1);
        }
        W8A8_CLOCK(t3);
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
        W8A8_CLOCK(t4);
        W8A8_ADD(P_FOLD, t4 - t3);
        W8A8_ADD(P_FOLDS, 1);
      }
      W8A8_CLOCK(t5);
      epilogue(facc, g, m0, n0, stage);
      W8A8_CLOCK(t6);
      W8A8_ADD(P_EPILOGUE, t6 - t5);
      W8A8_ADD(P_TILES, 1);
    }
    W8A8_CLOCK(t_end);
    W8A8_ADD(P_CONSUMER_LOOP, t_end - t_loop);
  }
#ifdef W8A8_PROBE
  if (rec)
    for (int i = 0; i < P_COUNT; ++i)
      if (probe[i]) atomicAdd(&probe_sums[i], probe[i]);
#endif
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

// The tensor map of a K-major int8 weight of `rows` rows of `k` bytes (k a multiple of 16, the
// base 16-byte aligned): 128 x 128-byte boxes under the 128-byte swizzle, as wgmma's B reads
// them; k past the row's end reads as zero codes.
inline bool weight_map(CUtensorMap* map, const void* w, uint64_t k, uint64_t rows) {
  const uint64_t dims[2] = {k, rows};
  const uint64_t strides[1] = {k};
  const uint32_t box[2] = {BK, BN};
  return k % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
         hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box);
}

}  // namespace w8a8_pipe

#ifdef W8A8_PROBE
// The probe's sums (w8a8_pipe::Probe order, P_COUNT of them) into `out`, then zeroed when
// `reset`; a cudaError_t.
extern "C" int w8a8_probe_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, w8a8_pipe::probe_sums, sizeof(w8a8_pipe::probe_sums));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[w8a8_pipe::P_COUNT] = {};
    err = cudaMemcpyToSymbol(w8a8_pipe::probe_sums, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
