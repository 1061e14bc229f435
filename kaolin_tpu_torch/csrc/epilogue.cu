// The DIB-R epilogue's gathers and their hand-written backwards for Hopper
// (sm_90a), plain C interface.
//
// Built by kaolin_tpu_torch/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// with epilogue_module.cpp (its Python entry points: the input tests, the
// outputs and scratch, the stable sort of the ids) and called from
// kaolin_tpu_torch/render/mesh/_sample.py (E1, E2) and
// kaolin_tpu_torch/ops/_scatter.py (E3), which hold the plain PyTorch
// version of each.  Kernels launch on the caller's stream, never
// synchronise and never allocate; each entry point returns
// cudaGetLastError().
//
// E1 bilinear_forward_kernel replaces the forward of
//   kaolin_tpu/render/mesh/utils.py::_bilinear_sample (:42-59): per pixel
//   the four corner taps of _flat_corner_idx (:19-38), each corner clipped
//   on its own, and the lerp in the JAX package's order.  Bound by bytes:
//   x, y and the output stream once, the texture rows come from L2.
// E2 the backward, utils.py::_bilinear_sample_bwd (:66-81) with the texture
//   gradient of _tex_grad_mxu (:84-141): bilinear_pixels_kernel writes dx,
//   dy (:77-80) and the four taps' texel ids; the module sorts the 4 x Q
//   (tap, pixel) entries by texel, stably; the segment sums below add each
//   texel's w_tap * g terms.  Bound by bytes.
// E3 the row scatter-add zeros(N, D).at[idx].add(g) of
//   kaolin_tpu/ops/gather.py::_gather_rows_bwd (:63-66): the module sorts
//   the ids stably; the segment sums add each row's gradient rows.  Bound
//   by bytes: g read once.
// The DIB-R shading (shade.cuh, included below): the per-pixel chain from
//   the face rows to the L1 + IoU loss terms and its backward, which hands
//   d albedo to E2 and the face rows' gradients to E3; launched from
//   kaolin_tpu_torch/render/mesh/_shade.py.  E1's taps are bilinear.cuh's,
//   so the shading's albedo is E1's bit for bit.
//
// The segment sums have no atomics and give the same bits every run: each
// sum is taken in an order fixed by the inputs alone.  The sorted entries
// are cut into tiles of TILE; one warp takes a tile, 32 entries at a time,
// by a segmented shuffle scan, and carries the open run's sum from one
// chunk to the next.  A run that begins and ends in its tile is written
// to its output row; a run that crosses a tile edge leaves one piece per
// tile, and segment_combine_kernel adds the pieces of each such run with a
// whole CTA in a fixed tree.  So the time follows the number of entries,
// not the longest run of one id (the DIB-R step puts every background
// pixel, ~57 % of a view, on one face row).
//
// -fmad=false keeps every a*b+c as a rounded product and a rounded sum, as
// the plain PyTorch versions compute them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "shade.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 8;               // 32-entry chunks per tile
constexpr int TILE = 32 * CHUNKS;       // sorted entries per warp
constexpr int COMBINE_CTAS = 132 * 8;   // grid-stride over the tiles
constexpr int SLOTS = 3;                // per tile: two pieces, one carry

// E1: one pixel per thread
__global__ void __launch_bounds__(THREADS)
bilinear_forward_kernel(const float* __restrict__ tex,
                        const float* __restrict__ x,
                        const float* __restrict__ y, float* __restrict__ out,
                        int Q, int P, int H, int W, int C) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= Q) return;
  const bilinear::Corners k =
      bilinear::corners(x[q], y[q], H, W, q / P * (H * W));
  const float ax = 1.f - k.wx, ay = 1.f - k.wy;
  for (int c = 0; c < C; ++c) {
    float v[4];
    bilinear::taps(tex, k, C, c, v);
    out[(int64_t)q * C + c] = bilinear::lerp(v, k, ax, ay);
  }
}

// E2, per pixel: dx, dy as utils.py:77-80 (the channel sum in order) and
// the texel of each tap, keys[tap * Q + q] for taps 00, 01, 10, 11
__global__ void __launch_bounds__(THREADS)
bilinear_pixels_kernel(const float* __restrict__ tex,
                       const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ dy, int* __restrict__ keys, int Q,
                       int P, int H, int W, int C) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= Q) return;
  const bilinear::Corners k =
      bilinear::corners(x[q], y[q], H, W, q / P * (H * W));
  keys[q] = k.i00;
  keys[Q + q] = k.i01;
  keys[2 * Q + q] = k.i10;
  keys[3 * Q + q] = k.i11;
  const float ax = 1.f - k.wx, ay = 1.f - k.wy;
  float sx = 0.f, sy = 0.f;
  for (int c = 0; c < C; ++c) {
    float v[4];
    bilinear::taps(tex, k, C, c, v);
    bilinear::grad_xy(v, k, ax, ay, g[(int64_t)q * C + c], &sx, &sy);
  }
  dx[q] = sx;
  dy[q] = sy;
}

// Where an entry's value comes from: row `row` of g times `w`.  Rows
// (taps_q == 0): entry id is the row.  Taps (taps_q == Q): entry id is
// tap * Q + q, the value g[q] times the tap's lerp weight (E2's dT).
struct Entry {
  int64_t row;
  float w;
};

__device__ __forceinline__ Entry entry(int64_t id, int taps_q,
                                       const float* __restrict__ x,
                                       const float* __restrict__ y) {
  if (taps_q == 0) return Entry{id, 1.f};
  const int tap = (int)(id / taps_q);
  const int64_t q = id - (int64_t)tap * taps_q;
  const float wx = x[q] - floorf(x[q]), wy = y[q] - floorf(y[q]);
  return Entry{q, ((tap & 1) ? wx : 1.f - wx) * ((tap & 2) ? wy : 1.f - wy)};
}

// Pass 1: one warp per tile of TILE sorted entries.  sk: the sorted keys
// (output rows), perm: the entry ids in sorted order.  Writes out[key] for
// the runs that begin and end in the tile; part[tile][0] the piece of the
// run that began before the tile, part[tile][1] that of a run that begins
// in it and goes on past it; part[tile][2] is the warp's carry.
__global__ void __launch_bounds__(THREADS)
segment_pieces_kernel(const int* __restrict__ sk,
                      const int64_t* __restrict__ perm, int M, int D, int N,
                      int taps_q, const float* __restrict__ g,
                      const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ out,
                      float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int t0 = tile * TILE;
  if (t0 >= M) return;                  // the whole warp
  const int t_end = min(t0 + TILE, M);
  const bool first_tile = tile == 0;
  const int before = first_tile ? 0 : sk[t0 - 1];
  float* carry = part + ((int64_t)tile * SLOTS + 2) * D;
  bool has_carry = false;
  int carry_key = 0;
  for (int j = 0; j < CHUNKS; ++j) {
    const int e = t0 + 32 * j + lane;
    if (t0 + 32 * j >= t_end) break;    // uniform
    const bool valid = e < t_end;
    const int key = valid ? sk[e] : 0;
    const bool run_end = valid && (e + 1 >= M || sk[e + 1] != key);
    const bool began_before = !first_tile && key == before;
    const bool in_carry = has_carry && key == carry_key;
    // same[s]: the entry 2^s lanes down lies in this entry's run
    bool same[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int k = __shfl_up_sync(FULL, key, 1 << s);
      same[s] = lane >= (1 << s) && k == key;
    }
    const Entry en = valid ? entry(perm[e], taps_q, x, y) : Entry{0, 0.f};
    float* dst = nullptr;
    if (valid && (run_end || e == t_end - 1)) {
      if (run_end && !began_before)
        dst = key >= 0 && key < N ? out + (int64_t)key * D : nullptr;
      else
        dst = part + ((int64_t)tile * SLOTS + (began_before ? 0 : 1)) * D;
    }
    for (int c = 0; c < D; ++c) {
      float v = valid ? g[en.row * D + c] * en.w : 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const float u = __shfl_up_sync(FULL, v, 1 << s);
        if (same[s]) v = u + v;
      }
      if (in_carry) v = carry[c] + v;
      if (dst) dst[c] = v;
      const float last = __shfl_sync(FULL, v, 31);
      __syncwarp();
      if (lane == 0) carry[c] = last;
      __syncwarp();
    }
    has_carry = __shfl_sync(FULL, valid && !run_end, 31);
    carry_key = __shfl_sync(FULL, key, 31);
  }
}

// Pass 2: each run that crosses a tile edge, taken by the CTA of the tile
// it begins in: its pieces (that tile's part[1], then part[0] of each
// following tile it reaches) added by a strided sum per thread and a fixed
// tree over the CTA, column by column.
__global__ void __launch_bounds__(THREADS)
segment_combine_kernel(const int* __restrict__ sk, int M, int D, int N,
                       const float* __restrict__ part,
                       float* __restrict__ out) {
  __shared__ float red[THREADS];
  __shared__ int pieces;
  const int ntiles = (M + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < ntiles - 1; t += gridDim.x) {
    const int last = (t + 1) * TILE - 1;   // < M - 1: a tile follows
    const int key = sk[last];
    if (sk[last + 1] != key) continue;               // the run ends here
    if (t > 0 && sk[t * TILE - 1] == key) continue;  // began earlier
    if (threadIdx.x == 0) {
      int lo = last + 1, hi = M;          // the first entry past the run
      while (lo < hi) {
        const int mid = lo + (hi - lo) / 2;
        if (sk[mid] == key) lo = mid + 1;
        else hi = mid;
      }
      pieces = (lo - 1) / TILE - t + 1;
    }
    __syncthreads();
    const int n = pieces;
    for (int c = 0; c < D; ++c) {
      float s = 0.f;
      for (int k = threadIdx.x; k < n; k += THREADS)
        s += part[((int64_t)(t + k) * SLOTS + (k == 0 ? 1 : 0)) * D + c];
      red[threadIdx.x] = s;
      __syncthreads();
#pragma unroll
      for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
      }
      if (threadIdx.x == 0 && key >= 0 && key < N)
        out[(int64_t)key * D + c] = red[0];
    }
    __syncthreads();                      // pieces is written again
  }
}

}  // namespace

// Scratch floats of the segment sums of M entries of D columns.
extern "C" long long epilogue_scratch(int M, int D) {
  return (long long)((M + TILE - 1) / TILE) * SLOTS * D;
}

// E1.  tex (B * H * W, C), x, y (Q,), out (Q, C); Q = B * P.
extern "C" int epilogue_bilinear_forward(const void* tex, const void* x,
                                         const void* y, void* out, int Q,
                                         int P, int H, int W, int C,
                                         void* stream) {
  if (P < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (Q > 0)
    bilinear_forward_kernel<<<(Q + THREADS - 1) / THREADS, THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const float*)tex, (const float*)x, (const float*)y, (float*)out, Q,
        P, H, W, C);
  return (int)cudaGetLastError();
}

// E2, per pixel.  g (Q, C); dx, dy (Q,); keys (4 * Q,) int.
extern "C" int epilogue_bilinear_pixels(const void* tex, const void* x,
                                        const void* y, const void* g,
                                        void* dx, void* dy, void* keys, int Q,
                                        int P, int H, int W, int C,
                                        void* stream) {
  if (P < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (Q > 0)
    bilinear_pixels_kernel<<<(Q + THREADS - 1) / THREADS, THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)tex, (const float*)x, (const float*)y, (const float*)g,
        (float*)dx, (float*)dy, (int*)keys, Q, P, H, W, C);
  return (int)cudaGetLastError();
}

// The segment sums of E2 (taps_q = Q, x and y the pixels') and E3
// (taps_q = 0): out (N, D), zero on entry, gets for each key the sum of
// its entries' values in sorted order.  sk (M,) int sorted keys, perm (M,)
// int64 entry ids, part: epilogue_scratch(M, D) floats.
extern "C" int epilogue_segment_sum(const void* sk, const void* perm, int M,
                                    int D, int N, int taps_q, const void* g,
                                    const void* x, const void* y, void* out,
                                    void* part, void* stream) {
  if (D < 1 || M < 0 || taps_q < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (M + TILE - 1) / TILE;
  segment_pieces_kernel<<<(ntiles + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const int*)sk, (const int64_t*)perm, M, D, N, taps_q, (const float*)g,
      (const float*)x, (const float*)y, (float*)out, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 1)
    segment_combine_kernel<<<ntiles - 1 < COMBINE_CTAS ? ntiles - 1
                                                       : COMBINE_CTAS,
                             THREADS, 0, st>>>(
        (const int*)sk, M, D, N, (const float*)part, (float*)out);
  return (int)cudaGetLastError();
}
