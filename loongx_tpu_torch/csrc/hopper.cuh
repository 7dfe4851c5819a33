// Hopper (sm_90a) primitives shared by the wgmma kernels of this directory: mbarriers, TMA
// tiled loads, wgmma shared-memory descriptors and instructions, and setmaxnreg.
//
// Conventions:
//   * every shared-memory tile that wgmma reads is laid out as TMA's 128-byte swizzle writes
//     it: rows of 128 bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8), the tile
//     based at a multiple of 1024 bytes;
//   * a K-major operand (k contiguous) of R rows is described by desc_sw128(tile, 16, 1024)
//     and advanced along k inside its 128-byte row by adding (bytes >> 4) to the descriptor;
//     an MN-major operand (the transposed B of P.V: n contiguous, rows = k) by
//     desc_sw128(tile, stride between 64-element n panels, 1024);
//   * the host describes a global tensor with make_tensor_map (cuTensorMapEncodeTiled, taken
//     through cudaGetDriverEntryPoint so that nothing links libcuda) and passes it to the
//     kernel as a `const __grid_constant__ CUtensorMap`;
//   * a block of a thread-block cluster writes another block's shared memory with st_dsmem_v4,
//     counted on the receiver's mbarrier, after a cluster barrier (cluster_arrive, cluster_wait)
//     that follows the barrier's initialisation; a second one keeps every block alive until
//     its stores are done.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA) and to the other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive once and expect `bytes` of TMA transactions before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase with parity `phase` has completed.  A wait that outlasts any
// pipeline's stall by far (2^34 clocks, about 10 s) traps, so a broken pipeline fails its
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
  }
}

// Generic-proxy writes to shared memory (st.shared) become visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier (ids 1..15; 0 is __syncthreads): waits until `n` threads, a whole number of
// warps, have arrived at barrier `id`.
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- thread-block clusters ---------------------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The cluster barrier in two halves: every thread of every block arrives (release: its
// shared-memory writes before it are visible to reads after the wait), then waits for all
// (acquire); work between the two overlaps the barrier.  Not .aligned: a warp may reach it
// diverged.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// Stores 16 bytes at `p` (an address in this block's shared memory) in the shared memory of
// block `rank` of the cluster (distributed shared memory; `rank` may be this block's own) and
// counts them as transaction bytes of that block's mbarrier at `bar` (an address here too): a
// one-way store, no round trip.  The receiver expects the bytes (mbar_arrive_expect_tx) and
// waits on its barrier; its barrier must be initialised before the store (a cluster barrier
// between the two).
__device__ __forceinline__ void st_dsmem_v4(void* p, uint64_t* bar, uint32_t rank, uint4 v) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_u32(bar)),
               "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(ra),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rb)
      : "memory");
}

// ---- TMA ---------------------------------------------------------------------------------

// Fetches a tensor map into the cache ahead of its first TMA load.
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- setmaxnreg (one warpgroup at a time; the roles must never reconverge) ---------------
// ptxas gives a kernel that uses setmaxnreg 65536 / (threads rounded up to whole warpgroups)
// registers a thread at entry (rounded down to 8); a warpgroup's .inc waits until others have
// released as many by .dec, so each kernel's targets balance that entry count exactly, and its
// host code checks the count before launching (a kernel built otherwise would wait forever).

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -------------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint32_t addr = smem_u32(tile);
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers across an
// asynchronous wgmma (issue it on the accumulators after each wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// A register-sourced A fragment stays live up to the wgmma_wait that retires its product (the
// compiler sees only the instruction that starts the wgmma, so it could reuse the registers while
// the wgmma still reads them).
template <int N, int M>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HOPPER_D64(p)                                                                      \
  "+" p(d[0]), "+" p(d[1]), "+" p(d[2]), "+" p(d[3]), "+" p(d[4]), "+" p(d[5]),            \
      "+" p(d[6]), "+" p(d[7]), "+" p(d[8]), "+" p(d[9]), "+" p(d[10]), "+" p(d[11]),      \
      "+" p(d[12]), "+" p(d[13]), "+" p(d[14]), "+" p(d[15]), "+" p(d[16]), "+" p(d[17]),  \
      "+" p(d[18]), "+" p(d[19]), "+" p(d[20]), "+" p(d[21]), "+" p(d[22]), "+" p(d[23]),  \
      "+" p(d[24]), "+" p(d[25]), "+" p(d[26]), "+" p(d[27]), "+" p(d[28]), "+" p(d[29]),  \
      "+" p(d[30]), "+" p(d[31]), "+" p(d[32]), "+" p(d[33]), "+" p(d[34]), "+" p(d[35]),  \
      "+" p(d[36]), "+" p(d[37]), "+" p(d[38]), "+" p(d[39]), "+" p(d[40]), "+" p(d[41]),  \
      "+" p(d[42]), "+" p(d[43]), "+" p(d[44]), "+" p(d[45]), "+" p(d[46]), "+" p(d[47]),  \
      "+" p(d[48]), "+" p(d[49]), "+" p(d[50]), "+" p(d[51]), "+" p(d[52]), "+" p(d[53]),  \
      "+" p(d[54]), "+" p(d[55]), "+" p(d[56]), "+" p(d[57]), "+" p(d[58]), "+" p(d[59]),  \
      "+" p(d[60]), "+" p(d[61]), "+" p(d[62]), "+" p(d[63])

#define HOPPER_D64_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64] (s32) (+)= A (64 x 32 int8, K-major, smem) . B (128 x 32 int8, K-major, smem)^T;
// accumulate = 0 overwrites d.  d[4i + e]: row (warp % 4) * 16 + lane / 4 + 8 * (e / 2),
// column 8i + 2 * (lane % 4) + e % 2 (mma.sync's C fragment repeated over n).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_D64_LIST
      ", %64, %65, p;\n}\n"
      : HOPPER_D64("r")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (f32) (+)= A (64 x 16 bf16, K-major, smem) . B (128 x 16 bf16, K-major, smem)^T.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_ss(float (&d)[64], uint64_t da,
                                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D64("f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (f32) (+)= A (64 x 16 bf16, K-major, smem) . B (16 x 128 bf16, MN-major in smem: the
// transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_ss_tb(float (&d)[64], uint64_t da,
                                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_LIST
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : HOPPER_D64("f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (f32) (+)= A (64 x 16 bf16 in registers: mma.sync's m16n8k16 A fragment per warp)
// . B (128 x 16 bf16, K-major, smem)^T.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOPPER_D64("f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64] (f32) (+)= A (64 x 16 bf16 in registers: mma.sync's m16n8k16 A fragment per warp)
// . B (16 x 128 bf16, MN-major in smem: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D64("f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#define HOPPER_D32(p)                                                                      \
  "+" p(d[0]), "+" p(d[1]), "+" p(d[2]), "+" p(d[3]), "+" p(d[4]), "+" p(d[5]),            \
      "+" p(d[6]), "+" p(d[7]), "+" p(d[8]), "+" p(d[9]), "+" p(d[10]), "+" p(d[11]),      \
      "+" p(d[12]), "+" p(d[13]), "+" p(d[14]), "+" p(d[15]), "+" p(d[16]), "+" p(d[17]),  \
      "+" p(d[18]), "+" p(d[19]), "+" p(d[20]), "+" p(d[21]), "+" p(d[22]), "+" p(d[23]),  \
      "+" p(d[24]), "+" p(d[25]), "+" p(d[26]), "+" p(d[27]), "+" p(d[28]), "+" p(d[29]),  \
      "+" p(d[30]), "+" p(d[31])

#define HOPPER_D32_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[32] (f32) (+)= A (64 x 16 bf16, K-major, smem) . B (64 x 16 bf16, K-major, smem)^T;
// the fragment is the m64n128 one's first half (columns 0..63).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss(float (&d)[32], uint64_t da,
                                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32("f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] (s32) (+)= A (64 x 32 int8, K-major, smem) . B (64 x 32 int8, K-major, smem)^T; the
// fragment is the m64n128 one's first half (columns 0..63).
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " HOPPER_D32_LIST
      ", %32, %33, p;\n}\n"
      : HOPPER_D32("r")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] (f32) (+)= A (64 x 16 bf16 in registers: mma.sync's m16n8k16 A fragment per warp)
// . B (64 x 16 bf16, K-major, smem)^T; the fragment is the m64n128 one's first half.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_D32("f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef HOPPER_D32
#undef HOPPER_D32_LIST
#undef HOPPER_D64
#undef HOPPER_D64_LIST

// ---- int8 -> bf16 -------------------------------------------------------------------------

// Bytes i and j of `wb` (an int8 word already xor 0x80808080, so each byte is v + 128) ->
// bf16x2 (byte i low), exactly: the byte as the low mantissa byte of 2^23 is 2^23 + v + 128, so
// one subtraction leaves the int8 value as an fp32 integer; its low 16 bits are zero, so its
// high half is the exact bf16.  No conversion instruction.  sel_i = 0x7540 | i.
__device__ __forceinline__ uint32_t widen_pair(uint32_t wb, uint32_t sel_i, uint32_t sel_j) {
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(wb, 0x4B000000u, sel_i)), 8388736.f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(wb, 0x4B000000u, sel_j)), 8388736.f);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// ---- host -------------------------------------------------------------------------------

// Does `kernel` start with `regs` registers a thread (the count its setmaxnreg targets
// balance)?  Asked once per kernel.
template <typename K>
inline bool entry_regs_are(K* kernel, int regs) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess && attr.numRegs == regs;
}

// ---- host: tensor maps -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A tiled map of `rank` dims (innermost first: dims[0] elements are contiguous), strides in
// bytes of dims 1.., boxes of `box` elements, 128-byte swizzle unless `swizzle` says otherwise
// (SWIZZLE_NONE lands a box row-major, its rows box[0] elements apart), zeros outside the tensor.
inline bool make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                            const void* base, const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gd[5], gs[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i + 1 < rank) gs[i] = strides[i];
  }
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), gd, gs, bx, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper
