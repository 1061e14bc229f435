// The DIB-R per-pixel chain and its backward for Hopper (sm_90a): from the
// selected face of each pixel to the image L1 and silhouette IoU loss
// terms, in place of the PyTorch passes of
// kaolin_tpu_torch/models/inverse_render.py's render_loss (the row gather
// and barycentric weights of rasterization.py::_interpolate_selected_
// batched, texture_mapping's uv transform and E1's taps, spherical_
// harmonic_lighting, the clips, the background mask, the L1 mean and
// metrics/render.py::mask_iou) and of their autograd backward.
//
// Included by epilogue.cu (built with -fmad=false, as E1-E3) and launched
// through epilogue_module.cpp from kaolin_tpu_torch/render/mesh/_shade.py,
// which holds the plain PyTorch version: that composition, unchanged.  It
// replaces no Pallas kernel: the JAX package leaves this chain
// (kaolin_tpu/models/inverse_render.py:112-170) to XLA, which fuses it.
//
// Bound by bytes.  Forward, per pixel: the face id, the soft mask, the
// target image and mask in (24 bytes); the face's corners, normal and uvs
// (60 bytes a face) and the four texel taps come from L2 (the tables are a
// few MB).  Nothing per pixel is written: each CTA writes its sums of
// |image - target| and of its view's IoU numerator and denominator, and
// shade_loss_kernel adds them in a fixed order.  Backward: the chain
// recomputed from the same inputs, and 9 + 3 floats a pixel out (the
// face rows' 9 gradients for E3, d albedo for E2), with the texel coords,
// the row id and d soft mask: 64 bytes a pixel.  d SH by CTA sums added in
// a fixed order.  No float atomics: every run gives the same bits.
//
// Each op is PyTorch's, in its order, so that the albedo equals E1's bit for
// bit (the taps are bilinear.cuh's) and the rest differs from the plain
// version only where PyTorch's sums (the SH bands, the channel sums of the
// backward, the reductions) take another order.  The clips' gradients
// follow torch.maximum / torch.minimum: half to each side at a tie, as
// jnp.clip splits it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "shade.h"

namespace shade {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int C = 3;                    // texture channels
// the constants of spherical_harmonic_lighting and mask_iou, as PyTorch
// rounds a Python float to float32
constexpr float SH_C0 = (float)0.28209479177;
constexpr float SH_C1 = (float)0.4886025119;
constexpr float SH_C4 = (float)1.09254843059;
constexpr float SH_C6 = (float)0.94617469575;
constexpr float SH_C6B = (float)0.31539156525;
constexpr float SH_C7 = (float)0.77254840404;
constexpr float SH_C8 = (float)0.38627420202;
constexpr float IOU_EPS = (float)1e-10;

struct Consts {
  float mult, eps;    // the coordinate scale, the barycentric epsilon
  float sx, sy;       // pixel_coords' steps: multiplier / W, multiplier / H
};

// torch.maximum / torch.minimum: a NaN propagates
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : fminf(a, b);
}

// The gradient to x of maximum(x, 0): half at the tie
__device__ __forceinline__ float max0_grad(float x, float g) {
  float gx = x == 0.f ? g / 2.f : g;
  return x < 0.f ? 0.f : gx;
}

// The gradient to x of minimum(maximum(x, 0), 1)
__device__ __forceinline__ float clip01_grad(float x, float g) {
  const float m = tmax(x, 0.f);
  float gm = m == 1.f ? g / 2.f : g;
  if (m > 1.f) gm = 0.f;
  return max0_grad(x, gm);
}

// texture_mapping's unnormalised coordinate of one uv component u after
// its clip and the y flip's sign s: ((s (2 u - 1) + 1) n) / 2 - 0.5
__device__ __forceinline__ float texel(float u, bool flip, int n) {
  float c = u * 2.f - 1.f;
  if (flip) c = -c;
  return (c + 1.f) * (float)n / 2.f - 0.5f;
}

// The chain of one pixel, recomputed the same way by both kernels.
struct Pixel {
  bool covered;
  int64_t row;              // the face's row in the (B * F) tables
  float e[6];               // a_ex, a_ey, b_ex, b_ey, c_ex, c_ey
  float wr[3], norm, w[3];  // raw and normalised barycentric weights
  float f[3][5];            // corner features: u, v, nx, ny, nz
  float feat[5];            // interpolated features
  float x, y;               // texel coords
  bilinear::Corners k;
  float ax, ay;
  float alb[C], band[9], light, lc, pre[C], img[C];
};

__device__ __forceinline__ void recompute(const ShadeInputs& in,
                                          const Consts& k, int b, int pix,
                                          Pixel& p) {
  const int h = pix / in.W, wi = pix - h * in.W;
  const int fid = in.face_idx[(int64_t)b * in.H * in.W + pix];
  p.covered = fid >= 0;
  p.row = (int64_t)b * in.F + (fid >= 0 ? fid : 0);
  if (!p.covered) {
    // uv 0: the plain version samples at the clipped corner, weight 0
    p.x = texel(0.f, false, in.TW);
    p.y = texel(0.f, true, in.TH);
    for (int c = 0; c < C; ++c) p.img[c] = 0.f;
    return;
  }
  // pixel_coords
  const float x0 = k.sx * (float)(2 * wi + 1 - in.W);
  const float y0 = k.sy * (float)(in.H - 2 * h - 1);
  const float* fv = in.fvi + p.row * 6;
  for (int i = 0; i < 6; i += 2) {
    p.e[i] = fv[i] * k.mult - x0;
    p.e[i + 1] = fv[i + 1] * k.mult - y0;
  }
  const float a_ex = p.e[0], a_ey = p.e[1], b_ex = p.e[2], b_ey = p.e[3],
              c_ex = p.e[4], c_ey = p.e[5];
  // _bary_weights_gathered with _copysign_eps
  p.wr[0] = b_ex * c_ey - b_ey * c_ex;
  p.wr[1] = c_ex * a_ey - c_ey * a_ex;
  p.wr[2] = a_ex * b_ey - a_ey * b_ex;
  const float n0 = p.wr[0] + p.wr[1] + p.wr[2];
  p.norm = n0 + (signbit(n0) ? -k.eps : k.eps);
  for (int i = 0; i < 3; ++i) p.w[i] = p.wr[i] / p.norm;
  // the corners' features: uv, then the face normal
  const float* uv = in.face_uvs + (p.row - (int64_t)b * in.F) * 6;
  const float* nm = in.normals + p.row * 3;
  for (int i = 0; i < 3; ++i) {
    p.f[i][0] = uv[2 * i];
    p.f[i][1] = uv[2 * i + 1];
    for (int c = 0; c < 3; ++c) p.f[i][2 + c] = nm[c];
  }
  for (int c = 0; c < 5; ++c)
    p.feat[c] = p.w[0] * p.f[0][c] + p.w[1] * p.f[1][c] + p.w[2] * p.f[2][c];
  // texture_mapping: clip, flip, unnormalise; E1's taps
  p.x = texel(tmin(tmax(p.feat[0], 0.f), 1.f), false, in.TW);
  p.y = texel(tmin(tmax(p.feat[1], 0.f), 1.f), true, in.TH);
  p.k = bilinear::corners(p.x, p.y, in.TH, in.TW, 0);
  p.ax = 1.f - p.k.wx;
  p.ay = 1.f - p.k.wy;
  for (int c = 0; c < C; ++c) {
    float v[4];
    bilinear::taps(in.tex, p.k, C, c, v);
    p.alb[c] = bilinear::lerp(v, p.k, p.ax, p.ay);
  }
  // spherical_harmonic_lighting, its bands in order
  const float nx = p.feat[2], ny = p.feat[3], nz = p.feat[4];
  p.band[0] = SH_C0 * 1.f;
  p.band[1] = SH_C1 * nx;
  p.band[2] = SH_C1 * nz;
  p.band[3] = SH_C1 * ny;
  p.band[4] = SH_C4 * (nx * ny);
  p.band[5] = SH_C4 * (ny * nz);
  p.band[6] = SH_C6 * (nz * nz) - SH_C6B;
  p.band[7] = SH_C7 * (nx * nz);
  p.band[8] = SH_C8 * (nx * nx - ny * ny);
  p.light = 0.f;
  for (int j = 0; j < 9; ++j) p.light += p.band[j] * in.sh[j];
  p.lc = tmax(p.light, 0.f);
  for (int c = 0; c < C; ++c) {
    p.pre[c] = p.alb[c] * p.lc;
    p.img[c] = tmin(tmax(p.pre[c], 0.f), 1.f);
  }
}

// Sums of v[0..N) over the CTA in a fixed order (a butterfly in each warp,
// then the warps in order); the sums are valid in thread 0.  red: N * WARPS
// floats of shared memory.
template <int N>
__device__ __forceinline__ void block_sums(float v[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(FULL, v[i], o);
  __syncthreads();                      // red may still be read
  if (lane == 0)
    for (int i = 0; i < N; ++i) red[i * WARPS + warp] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
      for (int j = 0; j < WARPS; ++j) s += red[i * WARPS + j];
      v[i] = s;
    }
}

// Forward: one pixel a thread, one view a grid row; each CTA's sums of
// |image - target| and of the IoU numerator and denominator into part.
__global__ void __launch_bounds__(THREADS)
shade_forward_kernel(ShadeInputs in, Consts k, float* __restrict__ part) {
  __shared__ float red[3 * WARPS];
  const int b = blockIdx.y, pix = blockIdx.x * THREADS + threadIdx.x;
  float s[3] = {0.f, 0.f, 0.f};
  if (pix < in.H * in.W) {
    Pixel p;
    recompute(in, k, b, pix, p);
    const int64_t q = (int64_t)b * in.H * in.W + pix;
    for (int c = 0; c < C; ++c)
      s[0] += fabsf(p.img[c] - in.target_images[q * C + c]);
    const float sm = in.soft_mask[q], tm = in.target_masks[q];
    s[1] = sm * tm;
    s[2] = sm + tm - sm * tm;
  }
  block_sums<3>(s, red);
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i)
      part[((int64_t)b * gridDim.x + blockIdx.x) * 3 + i] = s[i];
}

// The loss terms from the CTAs' sums: one CTA, each sum in a fixed order.
__global__ void __launch_bounds__(THREADS)
shade_loss_kernel(const float* __restrict__ part, int nb, int B, float n_l1,
                  float* __restrict__ image_loss,
                  float* __restrict__ mask_loss, float* __restrict__ iou) {
  __shared__ float red[2 * WARPS];
  float s[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < B * nb; i += THREADS) s[0] += part[i * 3];
  block_sums<1>(s, red);
  const float l1 = s[0];
  float iou_sum = 0.f;
  for (int b = 0; b < B; ++b) {
    s[0] = s[1] = 0.f;
    for (int i = threadIdx.x; i < nb; i += THREADS) {
      s[0] += part[((int64_t)b * nb + i) * 3 + 1];
      s[1] += part[((int64_t)b * nb + i) * 3 + 2];
    }
    block_sums<2>(s, red);
    if (threadIdx.x == 0) {
      iou[2 * b] = s[0];
      iou[2 * b + 1] = s[1];
      iou_sum += s[0] / (s[1] + IOU_EPS);
    }
  }
  if (threadIdx.x == 0) {
    *image_loss = l1 / n_l1;
    *mask_loss = 1.f - iou_sum / (float)B;
  }
}

// Backward: the chain recomputed, one pixel a thread; per pixel the inputs
// of E2 (d albedo, texel coords) and E3 (9 face-row gradients, the row),
// d soft mask; each CTA's d SH into part.
__global__ void __launch_bounds__(THREADS)
shade_backward_kernel(ShadeInputs in, Consts k, const float* __restrict__ iou,
                      const float* __restrict__ g_image,
                      const float* __restrict__ g_mask, float n_l1,
                      float* __restrict__ d_albedo, float* __restrict__ tx,
                      float* __restrict__ ty, float* __restrict__ rows,
                      int* __restrict__ ids, float* __restrict__ d_soft,
                      float* __restrict__ part) {
  __shared__ float red[9 * WARPS];
  const int b = blockIdx.y, pix = blockIdx.x * THREADS + threadIdx.x;
  float dsh[9];
  for (int j = 0; j < 9; ++j) dsh[j] = 0.f;
  if (pix < in.H * in.W) {
    const int64_t q = (int64_t)b * in.H * in.W + pix;
    Pixel p;
    recompute(in, k, b, pix, p);
    // mask_iou: 1 - mean_b(up / (down + eps)), up = sum(sm tm), down =
    // sum((sm + tm) - sm tm)
    const float up = iou[2 * b], den = iou[2 * b + 1] + IOU_EPS;
    const float d_iou = -*g_mask / (float)in.B;
    const float d_up = d_iou / den;
    const float d_down = -d_iou * up / (den * den);
    const float tm = in.target_masks[q];
    d_soft[q] = (d_up + -d_down) * tm + d_down;
    float dalb[C] = {0.f, 0.f, 0.f}, drow[9];
    for (int j = 0; j < 9; ++j) drow[j] = 0.f;
    if (p.covered) {
      // the L1 mean, the clips, albedo * max(light, 0)
      const float gn = *g_image / n_l1;
      float dlc = 0.f;
      for (int c = 0; c < C; ++c) {
        const float r = p.img[c] - in.target_images[q * C + c];
        const float dimg = gn * (float)((0.f < r) - (r < 0.f));
        const float dpre = clip01_grad(p.pre[c], dimg);
        dalb[c] = dpre * p.lc;
        dlc += dpre * p.alb[c];
      }
      const float dlight = max0_grad(p.light, dlc);
      float db[9];
      for (int j = 0; j < 9; ++j) {
        dsh[j] = dlight * p.band[j];
        db[j] = dlight * in.sh[j];
      }
      // the bands' products to the interpolated normal
      const float nx = p.feat[2], ny = p.feat[3], nz = p.feat[4];
      const float t4 = db[4] * SH_C4, t5 = db[5] * SH_C4, t6 = db[6] * SH_C6,
                  t7 = db[7] * SH_C7, t8 = db[8] * SH_C8;
      float dfeat[5];
      dfeat[2] = db[1] * SH_C1 + t4 * ny + t7 * nz + t8 * nx + t8 * nx;
      dfeat[3] = db[3] * SH_C1 + t4 * nx + t5 * nz + -t8 * ny + -t8 * ny;
      dfeat[4] = db[2] * SH_C1 + t5 * ny + t6 * nz + t6 * nz + t7 * nx;
      // E2's dx, dy from the same taps, then the uv transform and clip
      float sx = 0.f, sy = 0.f;
      for (int c = 0; c < C; ++c) {
        float v[4];
        bilinear::taps(in.tex, p.k, C, c, v);
        bilinear::grad_xy(v, p.k, p.ax, p.ay, dalb[c], &sx, &sy);
      }
      const float dcx = sx / 2.f * (float)in.TW;
      const float dcy = sy / 2.f * (float)in.TH;
      dfeat[0] = clip01_grad(p.feat[0], dcx * 2.f);
      dfeat[1] = clip01_grad(p.feat[1], -dcy * 2.f);
      // the interpolation: the weights' and the normal's gradients
      float dw[3];
      for (int i = 0; i < 3; ++i) {
        dw[i] = 0.f;
        for (int c = 0; c < 5; ++c) dw[i] += dfeat[c] * p.f[i][c];
      }
      for (int c = 0; c < 3; ++c)
        drow[6 + c] = dfeat[2 + c] * p.w[0] + dfeat[2 + c] * p.w[1] +
                      dfeat[2 + c] * p.w[2];
      // w_i = wr_i / norm, norm = wr_0 + wr_1 + wr_2 + copysign(eps)
      const float nn = p.norm * p.norm;
      float dnorm = 0.f;
      for (int i = 0; i < 3; ++i) dnorm += -dw[i] * p.wr[i] / nn;
      float dwr[3];
      for (int i = 0; i < 3; ++i) dwr[i] = dw[i] / p.norm + dnorm;
      const float* e = p.e;
      // wr0 = b_ex c_ey - b_ey c_ex; wr1 = c_ex a_ey - c_ey a_ex;
      // wr2 = a_ex b_ey - a_ey b_ex
      drow[0] = -dwr[1] * e[5] + dwr[2] * e[3];
      drow[1] = dwr[1] * e[4] + -dwr[2] * e[2];
      drow[2] = dwr[0] * e[5] + -dwr[2] * e[1];
      drow[3] = -dwr[0] * e[4] + dwr[2] * e[0];
      drow[4] = -dwr[0] * e[3] + dwr[1] * e[1];
      drow[5] = dwr[0] * e[2] + -dwr[1] * e[0];
    }
    for (int c = 0; c < C; ++c) d_albedo[q * C + c] = dalb[c];
    tx[q] = p.x;
    ty[q] = p.y;
    for (int j = 0; j < 9; ++j) rows[q * 9 + j] = drow[j];
    ids[q] = (int)p.row;
  }
  block_sums<9>(dsh, red);
  if (threadIdx.x == 0)
    for (int j = 0; j < 9; ++j)
      part[((int64_t)b * gridDim.x + blockIdx.x) * 9 + j] = dsh[j];
}

// d SH from the CTAs' sums: one CTA, each in a fixed order.
__global__ void __launch_bounds__(THREADS)
shade_sh_kernel(const float* __restrict__ part, int n,
                float* __restrict__ d_sh) {
  __shared__ float red[9 * WARPS];
  float s[9];
  for (int j = 0; j < 9; ++j) s[j] = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS)
    for (int j = 0; j < 9; ++j) s[j] += part[(int64_t)i * 9 + j];
  block_sums<9>(s, red);
  if (threadIdx.x == 0)
    for (int j = 0; j < 9; ++j) d_sh[j] = s[j];
}

inline Consts consts(const ShadeInputs& in) {
  return Consts{(float)in.multiplier, (float)in.eps,
                (float)(in.multiplier / in.W), (float)(in.multiplier / in.H)};
}

inline dim3 grid(const ShadeInputs& in) {
  return dim3((in.H * in.W + THREADS - 1) / THREADS, in.B);
}

}  // namespace shade

extern "C" long long shade_blocks(int B, int H, int W) {
  return (long long)B * ((H * W + shade::THREADS - 1) / shade::THREADS);
}

extern "C" int epilogue_shade_forward(ShadeInputs in, float* part,
                                      float* image_loss, float* mask_loss,
                                      float* iou, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 g = shade::grid(in);
  shade::shade_forward_kernel<<<g, shade::THREADS, 0, st>>>(
      in, shade::consts(in), part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  shade::shade_loss_kernel<<<1, shade::THREADS, 0, st>>>(
      part, (int)g.x, in.B, (float)((double)in.B * in.H * in.W * shade::C),
      image_loss, mask_loss, iou);
  return (int)cudaGetLastError();
}

extern "C" int epilogue_shade_backward(ShadeInputs in, const float* iou,
                                       const float* g_image,
                                       const float* g_mask, float* d_albedo,
                                       float* tx, float* ty, float* rows,
                                       int* ids, float* d_soft, float* part,
                                       float* d_sh, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 g = shade::grid(in);
  shade::shade_backward_kernel<<<g, shade::THREADS, 0, st>>>(
      in, shade::consts(in), iou, g_image, g_mask,
      (float)((double)in.B * in.H * in.W * shade::C), d_albedo, tx, ty, rows,
      ids, d_soft, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  shade::shade_sh_kernel<<<1, shade::THREADS, 0, st>>>(
      part, (int)(g.x * g.y), d_sh);
  return (int)cudaGetLastError();
}
