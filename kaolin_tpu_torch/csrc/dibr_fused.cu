// Fused tile-binned DIB-R kernels for Hopper (sm_90a), plain C interface.
//
// Built by kaolin_tpu_torch/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// and called through ctypes from kaolin_tpu_torch/render/mesh/_fused.py,
// which builds the inputs (build_face_tiles), allocates the outputs and
// holds the plain PyTorch version of each kernel.  Kernels launch on the
// caller's stream, never synchronise and never allocate; each entry point
// returns cudaGetLastError().
//
// Shared layout (see _fused.py): faces are spatially sorted and padded to
// chunks of FC = 64 faces; vt (B, nC, FC, NCOL) holds 40 float columns per
// face (affine edge functions, z numerator, validity, vertices, enlarged
// bbox, line coefficients per edge).  The image is cut into tiles of PS = 8
// rows by TW <= 128 columns; T = nI * nJ tiles, padded past H x W.
//
// -fmad=false keeps every a*b+c as a rounded product and a rounded sum, as
// the plain PyTorch versions compute them, so kernel and plain version
// differ only in the order of the soft-mask product and of the gradient
// sums.  expf (not __expf): no fast math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PS = 8;
constexpr int FC = 64;
constexpr int NCOL = 40;
constexpr int W0 = 0, W1 = 3, W2 = 6, NRM = 9, ZU = 12, VALID = 15;
constexpr int VX = 16, BB = 22, ED = 26;
constexpr float EPS = 1e-7f;           // product-division epsilon

constexpr int THREADS = 256;
constexpr int MAX_PIX = 4;             // K1 pixels per thread: P = 8*TW <= 1024
constexpr int NWARPS = THREADS / 32;
constexpr int FPW = FC / NWARPS;       // K2 faces per warp

struct Affine {                        // pixel centre: x0 = ax*wi + bx, ...
  float ax, bx, ay, by;
};

struct TileBounds {
  float xlo, xhi, ylo, yhi;
};

__device__ __forceinline__ TileBounds tile_bounds(const Affine& a, int i,
                                                  int j, int TW) {
  TileBounds t;
  t.xlo = a.ax * (float)(j * TW) + a.bx;
  t.xhi = a.ax * (float)(j * TW + TW - 1) + a.bx;
  t.yhi = a.ay * (float)(i * PS) + a.by;   // ay < 0: first row has max y
  t.ylo = a.ay * (float)(i * PS + PS - 1) + a.by;
  return t;
}

// exact chunk-bbox vs tile-bounds skip test (block-uniform)
__device__ __forceinline__ bool chunk_hits_tile(const float* cbb,
                                                const TileBounds& t) {
  return cbb[0] <= t.xhi && cbb[2] >= t.xlo && cbb[1] <= t.yhi &&
         cbb[3] >= t.ylo;
}

__device__ __forceinline__ bool in_bbox(const float* f, float x0, float y0) {
  return x0 >= f[BB] && x0 < f[BB + 2] && y0 >= f[BB + 1] && y0 < f[BB + 3];
}

__device__ __forceinline__ float affine(const float* f, int c, float x0,
                                        float y0) {
  return f[c] + f[c + 1] * x0 + f[c + 2] * y0;
}

// The 6 squared-distance candidates of pixel (x0, y0) to one face: edges
// e = 0..2 (the sentinel 4*mult^2 where the perpendicular foot falls off the
// segment), then the 3 vertices.  Shared by both kernels, so the forward and
// the backward see the same d.
struct Candidates {
  float d;                             // min of cand
  float cand[6];
  float up[3], perp[3], direct[3];
};

__device__ __forceinline__ void distance_candidates(const float* f, float x0,
                                                    float y0, float sentinel,
                                                    Candidates& c) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int n = (e + 1) % 3;
    const float A = f[ED + 4 * e], B = f[ED + 4 * e + 1];
    const float C = f[ED + 4 * e + 2], idn = f[ED + 4 * e + 3];
    const float up = A * x0 + B * y0 + C;
    const float t = up * idn;
    const float x3 = x0 - A * t;
    const float y3 = y0 - B * t;
    const float x1 = f[VX + 2 * e], y1 = f[VX + 2 * e + 1];
    const float x2 = f[VX + 2 * n], y2 = f[VX + 2 * n + 1];
    const float direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2);
    const float perp = up * up * idn;
    c.up[e] = up;
    c.perp[e] = perp;
    c.direct[e] = direct;
    c.cand[e] = direct > 0.f ? sentinel : perp;
  }
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float dx = x0 - f[VX + 2 * v];
    const float dy = y0 - f[VX + 2 * v + 1];
    c.cand[3 + v] = dx * dx + dy * dy;
  }
  float d = c.cand[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) d = fminf(d, c.cand[k]);
  c.d = d;
}

// ---------------------------------------------------------------------------
// K1: z-buffer winner + soft-mask product per pixel.
//
// Replaces kaolin_tpu/render/mesh/_fused.py::_fwd_kernel (launched by
// _fused_forward).  One block per (tile, view); each thread owns up to
// MAX_PIX pixels of the tile and keeps their running z, sorted face id and
// product in registers.  The block walks the tile's chunk range, skips a
// chunk by the exact bbox test, stages the chunk's 64 x 40 table (10 KB) in
// shared memory and walks its faces in ascending sorted order: a strict `>`
// keeps the lowest sorted id on a z tie, as the TPU kernel's per-chunk
// min-id does.
//
// Bound: compute per (pixel x face in range) — about 40 flops for coverage
// and z, plus about 60 and one expf for the soft mask where the pixel lies
// in the face's enlarged bbox.  The face table is read from shared memory
// as a broadcast (every thread of the block reads the same face), so the
// loop runs from registers and shared memory; device memory sees the table
// once per tile visit and one store per pixel.  The distance candidates
// are computed only inside the enlarged bbox, where p can be non-zero.
__global__ void __launch_bounds__(THREADS) fused_forward_kernel(
    const int* __restrict__ tile_ranges,   // (B, T, 2)
    const float* __restrict__ chunk_bbox,  // (B, nC, 4)
    const float* __restrict__ vt,          // (B, nC, FC, NCOL)
    int* __restrict__ fid,                 // (B, H, W) sorted id, -1 empty
    float* __restrict__ prod,              // (B, H, W)
    int nC, int H, int W, int nJ, int TW, Affine aff, float eps,
    float inv_sigma, float sentinel, int with_softmask) {
  __shared__ float table[FC * NCOL];
  const int t = blockIdx.x, b = blockIdx.y, T = gridDim.x;
  const int P = PS * TW;
  const int i = t / nJ, j = t % nJ;
  const TileBounds tb = tile_bounds(aff, i, j, TW);

  float px[MAX_PIX], py[MAX_PIX], bz[MAX_PIX], pr[MAX_PIX];
  int bf[MAX_PIX];
#pragma unroll
  for (int k = 0; k < MAX_PIX; ++k) {
    const int lane = threadIdx.x + k * THREADS;
    px[k] = aff.ax * (float)(j * TW + lane % TW) + aff.bx;
    py[k] = aff.ay * (float)(i * PS + lane / TW) + aff.by;
    bz[k] = -INFINITY;
    bf[k] = -1;
    pr[k] = 1.f;
  }

  const int lo = tile_ranges[(b * T + t) * 2];
  const int hi = tile_ranges[(b * T + t) * 2 + 1];
  for (int ci = lo; ci < hi; ++ci) {
    if (!chunk_hits_tile(chunk_bbox + ((size_t)b * nC + ci) * 4, tb))
      continue;
    __syncthreads();                   // the previous chunk is consumed
    const float* src = vt + ((size_t)b * nC + ci) * FC * NCOL;
    for (int q = threadIdx.x; q < FC * NCOL; q += THREADS) table[q] = src[q];
    __syncthreads();
    for (int f = 0; f < FC; ++f) {
      const float* c = table + f * NCOL;
      const int sid = ci * FC + f;
#pragma unroll
      for (int k = 0; k < MAX_PIX; ++k) {
        if (threadIdx.x + k * THREADS >= P) break;
        const float x0 = px[k], y0 = py[k];
        const float w0 = affine(c, W0, x0, y0);
        const float w1 = affine(c, W1, x0, y0);
        const float w2 = affine(c, W2, x0, y0);
        const float nrm = affine(c, NRM, x0, y0);
        const float s = nrm + (nrm >= 0.f ? eps : -eps);
        if (w0 * s >= 0.f && w1 * s >= 0.f && w2 * s >= 0.f &&
            c[VALID] > 0.f) {
          const float z = affine(c, ZU, x0, y0) / s;
          if (z > bz[k]) {
            bz[k] = z;
            bf[k] = sid;
          }
        }
        if (with_softmask && in_bbox(c, x0, y0)) {
          Candidates cd;
          distance_candidates(c, x0, y0, sentinel, cd);
          pr[k] = pr[k] * (1.f - expf(-inv_sigma * cd.d));
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < MAX_PIX; ++k) {
    const int lane = threadIdx.x + k * THREADS;
    if (lane >= P) break;
    const int wi = j * TW + lane % TW, hrow = i * PS + lane / TW;
    if (wi < W && hrow < H) {          // padded pixels are not written
      const size_t o = ((size_t)b * H + hrow) * W + wi;
      fid[o] = bf[k];
      prod[o] = pr[k];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: soft-mask gradient w.r.t. the scaled image-space vertices.
//
// Replaces kaolin_tpu/render/mesh/_fused.py::_bwd_kernel (launched by
// _fused_backward).  One block per (chunk of 64 faces, view); warp w owns
// faces w*8 .. w*8+7 and keeps their 8 x 6 gradient sums in registers.  The
// block walks the chunk's tile range, skips a tile by the exact bbox test,
// stages the tile's g*prod (zero outside H x W) in shared memory, and each
// lane takes pixels lane, lane+32, ... against the warp's 8 faces.  A
// (face, pixel) pair recomputes the 6 distance candidates and sends
// dL/dd = -inv_sigma * p * g*prod / (1 - p + 1e-7) to the argmin candidate
// only: edges e = 0..2 before vertices, the first `== d` wins, and an edge
// adds only where its foot lies on the segment (direct <= 0).  At the end
// each warp reduces its sums with shuffles and stores its 8 rows: every
// chunk owns its output rows, with no atomics.
//
// Bound: compute per (face x pixel in range), about twice K1's soft-mask
// work.  Pixels with g*prod == 0 (covered pixels, where the product's
// gradient is zero) and pairs outside the face's enlarged bbox (p == 0)
// contribute exactly zero and are skipped before the candidates are
// computed.
__global__ void __launch_bounds__(THREADS) fused_backward_kernel(
    const int* __restrict__ chunk_tranges,  // (B, nC, 2)
    const float* __restrict__ chunk_bbox,   // (B, nC, 4)
    const float* __restrict__ vt,           // (B, nC, FC, NCOL)
    const float* __restrict__ gprod,        // (B, H, W)
    float* __restrict__ out,                // (B, nC*FC, 6)
    int T, int H, int W, int nJ, int TW, Affine aff, float inv_sigma,
    float sentinel) {
  __shared__ float table[FC * NCOL];
  __shared__ float gs[PS * 128];
  const int c = blockIdx.x, b = blockIdx.y, nC = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int P = PS * TW;

  const float* src = vt + ((size_t)b * nC + c) * FC * NCOL;
  for (int q = threadIdx.x; q < FC * NCOL; q += THREADS) table[q] = src[q];
  const float* cbb = chunk_bbox + ((size_t)b * nC + c) * 4;

  float acc[FPW][6];
#pragma unroll
  for (int k = 0; k < FPW; ++k)
#pragma unroll
    for (int m = 0; m < 6; ++m) acc[k][m] = 0.f;

  const int lo = chunk_tranges[(b * nC + c) * 2];
  const int hi = chunk_tranges[(b * nC + c) * 2 + 1];
  for (int t = lo; t < hi; ++t) {
    const int i = t / nJ, j = t % nJ;
    if (!chunk_hits_tile(cbb, tile_bounds(aff, i, j, TW))) continue;
    __syncthreads();                   // the previous tile is consumed
    for (int q = threadIdx.x; q < P; q += THREADS) {
      const int wi = j * TW + q % TW, hrow = i * PS + q / TW;
      gs[q] = (wi < W && hrow < H) ? gprod[((size_t)b * H + hrow) * W + wi]
                                   : 0.f;
    }
    __syncthreads();
    for (int q = lane; q < P; q += 32) {
      const float g = gs[q];
      if (g == 0.f) continue;
      const float x0 = aff.ax * (float)(j * TW + q % TW) + aff.bx;
      const float y0 = aff.ay * (float)(i * PS + q / TW) + aff.by;
#pragma unroll
      for (int k = 0; k < FPW; ++k) {
        const float* f = table + (warp * FPW + k) * NCOL;
        if (!in_bbox(f, x0, y0)) continue;
        Candidates cd;
        distance_candidates(f, x0, y0, sentinel, cd);
        const float p = expf(-inv_sigma * cd.d);
        const float dd = (-inv_sigma) * p * g / (1.f - p + EPS);
        bool remaining = true;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          if (remaining && cd.cand[e] == cd.d) {
            remaining = false;
            if (cd.direct[e] <= 0.f) {
              const int n = (e + 1) % 3;
              const float A = f[ED + 4 * e], B = f[ED + 4 * e + 1];
              const float idn = f[ED + 4 * e + 3];
              const float up = cd.up[e], perp = cd.perp[e];
              const float dA = 2.f * (up * x0 - perp * A) * idn;
              const float dB = 2.f * (up * y0 - perp * B) * idn;
              const float dC = 2.f * up * idn;
              const float x1 = f[VX + 2 * e], y1 = f[VX + 2 * e + 1];
              const float x2 = f[VX + 2 * n], y2 = f[VX + 2 * n + 1];
              acc[k][2 * e] += dd * (dB - dC * y2);
              acc[k][2 * e + 1] += dd * (dC * x2 - dA);
              acc[k][2 * n] += dd * (dC * y1 - dB);
              acc[k][2 * n + 1] += dd * (dA - dC * x1);
            }
          }
        }
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          if (remaining && cd.cand[3 + v] == cd.d) {
            remaining = false;
            acc[k][2 * v] += dd * 2.f * (f[VX + 2 * v] - x0);
            acc[k][2 * v + 1] += dd * 2.f * (f[VX + 2 * v + 1] - y0);
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < FPW; ++k) {
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      float v = acc[k][m];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0)
        out[(((size_t)b * nC + c) * FC + warp * FPW + k) * 6 + m] = v;
    }
  }
}

}  // namespace

extern "C" int dibr_fused_forward(const void* tile_ranges,
                                  const void* chunk_bbox, const void* vt,
                                  void* fid, void* prod, int B, int nC,
                                  int T, int H, int W, int nJ, int TW,
                                  float ax, float bx, float ay, float by,
                                  float eps, float inv_sigma, float sentinel,
                                  int with_softmask, void* stream) {
  if (TW < 1 || PS * TW > MAX_PIX * THREADS) return (int)cudaErrorInvalidValue;
  if (B > 0 && T > 0) {
    fused_forward_kernel<<<dim3(T, B), THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)tile_ranges, (const float*)chunk_bbox, (const float*)vt,
        (int*)fid, (float*)prod, nC, H, W, nJ, TW, Affine{ax, bx, ay, by},
        eps, inv_sigma, sentinel, with_softmask);
  }
  return (int)cudaGetLastError();
}

extern "C" int dibr_fused_backward(const void* chunk_tranges,
                                   const void* chunk_bbox, const void* vt,
                                   const void* gprod, void* out, int B,
                                   int nC, int T, int H, int W, int nJ,
                                   int TW, float ax, float bx, float ay,
                                   float by, float inv_sigma, float sentinel,
                                   void* stream) {
  if (TW < 1 || TW > 128) return (int)cudaErrorInvalidValue;
  if (B > 0 && nC > 0) {
    fused_backward_kernel<<<dim3(nC, B), THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)chunk_tranges, (const float*)chunk_bbox, (const float*)vt,
        (const float*)gprod, (float*)out, T, H, W, nJ, TW,
        Affine{ax, bx, ay, by}, inv_sigma, sentinel);
  }
  return (int)cudaGetLastError();
}
