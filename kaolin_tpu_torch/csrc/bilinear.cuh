// E1's taps: the bilinear sample of one pixel from a channels-last texture
// table, as kaolin_tpu/render/mesh/utils.py::_flat_corner_idx (:19-38) and
// _bilinear_sample (:42-59) compute it.  Included by epilogue.cu, whose
// bilinear_forward_kernel (E1) and bilinear_pixels_kernel (E2) take their
// taps from here, and by shade.cuh, whose DIB-R shading kernels take the
// albedo from here: so the shading's albedo is E1's bit for bit.

#pragma once

#include <math.h>
#include <stdint.h>

namespace bilinear {

struct Corners {
  int i00, i01, i10, i11;
  float wx, wy;
};

// _flat_corner_idx for one pixel: the flat rows of the four taps in the
// (B * H * W, C) table, each corner clipped on its own, and the lerp
// weights.  boff is the pixel's view's first row.
__device__ __forceinline__ Corners corners(float x, float y, int H, int W,
                                           int boff) {
  const float x0 = floorf(x), y0 = floorf(y);
  const int xi = (int)x0, yi = (int)y0;
  const int x0i = min(max(xi, 0), W - 1), x1i = min(max(xi + 1, 0), W - 1);
  const int y0i = min(max(yi, 0), H - 1), y1i = min(max(yi + 1, 0), H - 1);
  Corners k;
  k.i00 = boff + y0i * W + x0i;
  k.i01 = boff + y0i * W + x1i;
  k.i10 = boff + y1i * W + x0i;
  k.i11 = boff + y1i * W + x1i;
  k.wx = x - x0;
  k.wy = y - y0;
  return k;
}

// The four taps of channel c: v[0..3] = taps 00, 01, 10, 11.
__device__ __forceinline__ void taps(const float* __restrict__ tex,
                                     const Corners& k, int C, int c,
                                     float v[4]) {
  v[0] = tex[(int64_t)k.i00 * C + c];
  v[1] = tex[(int64_t)k.i01 * C + c];
  v[2] = tex[(int64_t)k.i10 * C + c];
  v[3] = tex[(int64_t)k.i11 * C + c];
}

// The lerp of four taps in the JAX package's order; ax = 1 - wx,
// ay = 1 - wy.
__device__ __forceinline__ float lerp(const float v[4], const Corners& k,
                                      float ax, float ay) {
  return v[0] * ax * ay + v[1] * k.wx * ay + v[2] * ax * k.wy +
         v[3] * k.wx * k.wy;
}

// E2's dx, dy terms of one channel (utils.py:77-80): the sample's
// cotangent g through the lerp weights, added onto *sx, *sy.
__device__ __forceinline__ void grad_xy(const float v[4], const Corners& k,
                                        float ax, float ay, float g,
                                        float* sx, float* sy) {
  *sx += g * ((v[1] - v[0]) * ay + (v[3] - v[2]) * k.wy);
  *sy += g * ((v[2] - v[0]) * ax + (v[3] - v[1]) * k.wx);
}

}  // namespace bilinear
