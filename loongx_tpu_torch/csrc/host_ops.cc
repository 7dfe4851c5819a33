// Host-side image ops of the data pipeline (this package's copy of the
// JAX package's native/host_ops.cc): uint8 -> float32 conversion with an
// affine scale, bilinear resize, and grayscale replication.  A plain C ABI
// loaded with ctypes (loongx_tpu_torch/native.py); every function is
// thread-safe and runs without the interpreter lock, so the loader's thread
// pool runs them in parallel.
//
// Build: g++ -O3 -shared -fPIC (native.py, at first use, into _build/).

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// uint8 [h, w, 3] -> float32 [h, w, 3], y = x * scale + offset.
// scale=1/255, offset=0 gives [0,1]; scale=1/127.5, offset=-1 gives [-1,1].
void u8_to_f32(const uint8_t* src, int64_t n, float scale, float offset,
               float* dst) {
  // lookup table: 256 entries beats per-pixel fma for large images
  float lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = static_cast<float>(i) * scale + offset;
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// Bilinear resize uint8 [sh, sw, c] -> float32 [dh, dw, c] with affine
// scaling applied.  Half-pixel centers; not PIL's resampler (its pixels
// differ), the same pixels as the JAX package's library.
void resize_bilinear_u8_f32(const uint8_t* src, int sh, int sw, int c,
                            float* dst, int dh, int dw, float scale,
                            float offset) {
  const float ry = static_cast<float>(sh) / dh;
  const float rx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ry - 0.5f;
    int y0 = static_cast<int>(fy >= 0 ? fy : 0);
    y0 = std::min(y0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - static_cast<float>(y0);
    wy = std::min(std::max(wy, 0.0f), 1.0f);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * rx - 0.5f;
      int x0 = static_cast<int>(fx >= 0 ? fx : 0);
      x0 = std::min(x0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - static_cast<float>(x0);
      wx = std::min(std::max(wx, 0.0f), 1.0f);
      const uint8_t* p00 = src + (static_cast<int64_t>(y0) * sw + x0) * c;
      const uint8_t* p01 = src + (static_cast<int64_t>(y0) * sw + x1) * c;
      const uint8_t* p10 = src + (static_cast<int64_t>(y1) * sw + x0) * c;
      const uint8_t* p11 = src + (static_cast<int64_t>(y1) * sw + x1) * c;
      float* out = dst + (static_cast<int64_t>(y) * dw + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
        float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
        out[ch] = (top + (bot - top) * wy) * scale + offset;
      }
    }
  }
}

// Grayscale conversion (ITU-R 601) u8 [h, w, 3] -> u8 [h, w, 3] replicated —
// the "coloring" condition transform (reference data.py:257-262).
void rgb_to_gray3_u8(const uint8_t* src, int64_t pixels, uint8_t* dst) {
  for (int64_t i = 0; i < pixels; ++i) {
    const uint8_t* p = src + i * 3;
    uint8_t g = static_cast<uint8_t>(
        (299 * p[0] + 587 * p[1] + 114 * p[2] + 500) / 1000);
    dst[i * 3] = g;
    dst[i * 3 + 1] = g;
    dst[i * 3 + 2] = g;
  }
}

}  // extern "C"
