// int8 codes of the TPU kernels' quantization (quant_matmul.py::_accum_tile :47-50, and
// flash_attention.py::_fwd_kernel's _quant :228): scale = absmax / 127 (1 when absmax is 0),
// code = clip(rint(x / scale), -127, 127) with IEEE division and ties to even, shared by the
// kernels of this directory that quantize many values of one scale.
//
// codes8 gives exactly those codes without a division an element.  With r = __frcp_rn(scale),
// t = x * r is within 2^-16 of the quotient x / scale (|x / scale| <= 127 * (1 + 2^-23) when
// |x| <= absmax; two roundings of 2^-24 relative), and the IEEE quotient within half an ulp
// (2^-18), so both round to the same integer unless the quotient lies within 2^-14 of a
// half-integer, which t then shows (|t - rint(t)| > 0.5 - 2^-14; a NaN from an overflowed r
// too).  Only a chunk holding such a value (about one value in 8000) takes __fdiv_rn.  rint(t)
// is an add of 1.5 * 2^23 (exact below 2^22), not the quarter-rate F2I.  A
// division an element costs its latency, a call and a convergence barrier, which serialise a
// thread's values.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace quant8 {

__device__ __forceinline__ float scale_of(float absmax) {
  return absmax == 0.f ? 1.f : __fdiv_rn(absmax, 127.f);
}

// clip(rint(x / scale), -127, 127) by IEEE division.
__device__ __forceinline__ int code_div(float x, float scale) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, scale))));
}

// The codes of x[0..7] (scale `scale`, r = __frcp_rn(scale)), byte e of the pair = code e.
// y = 1.5 * 2^23 + rint(t) has the code as its low byte (two's complement), so four codes pack
// with two byte permutes; no clip is needed on this path (|t| <= 127 * (1 + 2^-22) gives
// |rint(t)| <= 127).
__device__ __forceinline__ uint2 codes8(const float (&x)[8], float scale, float r) {
  uint32_t y[8];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fmul_rn(x[e], r), ye = __fadd_rn(t, 12582912.f);
    near |= !(fabsf(__fsub_rn(t, __fsub_rn(ye, 12582912.f))) <= 0.5f - 0x1p-14f);
    y[e] = __float_as_uint(ye);
  }
  uint2 out = make_uint2(
      __byte_perm(__byte_perm(y[0], y[1], 0x0040), __byte_perm(y[2], y[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(y[4], y[5], 0x0040), __byte_perm(y[6], y[7], 0x0040), 0x5410));
  if (near) {
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      word[e / 4] |= static_cast<uint32_t>(code_div(x[e], scale) & 0xff) << (8 * (e % 4));
    out = make_uint2(word[0], word[1]);
  }
  return out;
}

}  // namespace quant8
