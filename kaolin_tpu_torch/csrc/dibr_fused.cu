// Fused tile-binned DIB-R kernels for Hopper (sm_90a), plain C interface.
//
// Built by kaolin_tpu_torch/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// with dibr_fused_module.cpp (its Python entry points, which allocate the
// outputs and the backward's scratch) and called from
// kaolin_tpu_torch/render/mesh/_fused.py, which builds the inputs
// (build_face_tiles) and holds the plain PyTorch version of each kernel.
// Kernels launch on the caller's stream, never synchronise and never
// allocate; each entry point returns cudaGetLastError().
//
// Shared layout (see _fused.py): faces are spatially sorted and padded to
// chunks of FC = 64 faces; vt (B, nC, FC, NCOL) holds 40 float columns per
// face (affine edge functions, z numerator, validity, vertices, enlarged
// bbox, line coefficients per edge).  The image is cut into tiles of PS = 8
// rows by TW <= 128 columns (TW a multiple of 16); T = nI * nJ tiles,
// padded past H x W.  tile_ranges holds each tile's range of chunks,
// chunk_tranges each chunk's range of tiles.
//
// Both kernels cull finer than the tiles: a face whose enlarged bbox misses
// a block of pixels adds nothing to any of them.  Its soft-mask term is
// p = 0 outside the bbox, and a pixel it covers lies inside its triangle,
// which the bbox contains for any margin >= 0.  The culling tests are
// closed (<=, >=) on pixel centres, so they keep every face the half-open
// per-pixel test can select.
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
constexpr unsigned FULL = 0xffffffffu;

// K1: one CTA per SUB x SUB sub-tile, one pixel per thread
constexpr int SUB = 16;
constexpr int FWD_THREADS = SUB * SUB;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int SCAN_CHUNKS = FWD_THREADS / FC;  // chunks culled per pass
constexpr int BATCH = 128;             // faces staged per pass (20 KB)
constexpr int RING = 512;              // face-id ring, >= BATCH + FWD_THREADS
static_assert(BATCH - 1 + FWD_THREADS + BATCH <= RING, "ring too small");

// K2: one CTA per (chunk, slice, view), one unit of 8 x SW <= UNIT_PX
// pixels at a time
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int UNIT_PX = PS * 32;

struct Affine {                        // pixel centre: x0 = ax*wi + bx, ...
  float ax, bx, ay, by;
};

struct Rect {                          // pixel-centre bounds of a block
  float xlo, xhi, ylo, yhi;
};

// rows r0..r1 and columns c0..c1, inclusive; ay < 0: row r0 has max y
__device__ __forceinline__ Rect pixel_rect(const Affine& a, int r0, int r1,
                                           int c0, int c1) {
  Rect t;
  t.xlo = a.ax * (float)c0 + a.bx;
  t.xhi = a.ax * (float)c1 + a.bx;
  t.yhi = a.ay * (float)r0 + a.by;
  t.ylo = a.ay * (float)r1 + a.by;
  return t;
}

// closed test of a box (xlo, ylo, xhi, yhi) against a block's bounds: the
// chunk bbox (chunk_bbox) and the face's enlarged bbox (vt[..., BB:BB+4])
// share this layout
__device__ __forceinline__ bool box_hits(const float* bb, const Rect& t) {
  return bb[0] <= t.xhi && bb[2] >= t.xlo && bb[1] <= t.yhi &&
         bb[3] >= t.ylo;
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
// _fused_forward).
//
// Bound: operations.  The function needs the cover test and z on the
// (pixel, valid face) pairs where the face can cover the pixel and the
// distance candidates, one expf and the product on the pairs inside the
// face's enlarged bbox (~35 and ~87 flops); its bytes (the face table,
// one int and one float per pixel) are ~15 MB.
//
// Design: one CTA per (16 x 16 sub-tile, view), one pixel per thread.  A
// sub-tile spans one or two tile rows and walks the union [min lo, max hi)
// of their chunk ranges.
//   Cull: 4 chunks per pass, one face per thread.  A chunk whose bbox
//   misses the sub-tile is skipped; a face of a kept chunk enters the face
//   list when its enlarged bbox (closed test) meets the sub-tile.  Warp
//   ballots and popc ranks append the survivors to a ring of sorted ids in
//   ascending order.
//   Evaluate: whenever BATCH ids are waiting (or the range is done), their
//   40 columns are staged in shared memory and every thread runs its pixel
//   against them in list order: cover test and z for valid faces, the
//   distance candidates, expf and the product only where the pixel is in
//   the face's bbox (half-open), a strict `>` on z.
// Each pixel therefore sees the faces that can change its result in the
// same ascending sorted order as a walk over the whole chunk range, and
// every skipped face would have multiplied the product by exactly 1 and
// failed the cover test: face ids and product bits equal those of a full
// walk, and the lowest sorted id wins a z tie, as the TPU kernel's
// per-chunk min-id does.  Pixels past H x W are computed, not written.
__global__ void __launch_bounds__(FWD_THREADS) fused_forward_kernel(
    const int* __restrict__ tile_ranges,   // (B, T, 2)
    const float* __restrict__ chunk_bbox,  // (B, nC, 4)
    const float* __restrict__ vt,          // (B, nC, FC, NCOL)
    int* __restrict__ fid,                 // (B, H, W) sorted id, -1 empty
    float* __restrict__ prod,              // (B, H, W)
    int nC, int T, int H, int W, int nJ, int TW, Affine aff, float eps,
    float inv_sigma, float sentinel, int with_softmask) {
  __shared__ float table[BATCH * NCOL];
  __shared__ int ring[RING];
  __shared__ int warp_count[2][FWD_WARPS];
  const int b = blockIdx.y;
  const int nI = T / nJ, nSJ = nJ * TW / SUB;
  const int r0 = (blockIdx.x / nSJ) * SUB, c0 = (blockIdx.x % nSJ) * SUB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warps tile the sub-tile in 4 x 8 blocks of pixels
  const int hrow = r0 + (warp / 2) * 4 + lane / 8;
  const int wi = c0 + (warp % 2) * 8 + lane % 8;
  const float x0 = aff.ax * (float)wi + aff.bx;
  const float y0 = aff.ay * (float)hrow + aff.by;
  const Rect sub = pixel_rect(aff, r0, r0 + SUB - 1, c0, c0 + SUB - 1);

  int lo = 0, hi = 0;                  // union of the tile rows' ranges
  for (int ti = r0 / PS; ti < min(r0 / PS + SUB / PS, nI); ++ti) {
    const int* r = tile_ranges + ((size_t)b * T + ti * nJ + c0 / TW) * 2;
    if (r[0] >= r[1]) continue;
    lo = lo < hi ? min(lo, r[0]) : r[0];
    hi = max(hi, r[1]);
  }

  const float* vtb = vt + (size_t)b * nC * FC * NCOL;
  const float* cbb = chunk_bbox + (size_t)b * nC * 4;
  float bz = -INFINITY, pr = 1.f;
  int bf = -1;
  int head = 0, tail = 0;              // the ring holds ids [head, tail)
  int pass = 0;
  for (int cs = lo; cs < hi; cs += SCAN_CHUNKS, ++pass) {
    const int ci = cs + threadIdx.x / FC;
    const int sid = ci * FC + threadIdx.x % FC;
    bool keep = false;
    if (ci < hi && box_hits(cbb + (size_t)ci * 4, sub))
      keep = box_hits(vtb + (size_t)sid * NCOL + BB, sub);
    const unsigned m = __ballot_sync(FULL, keep);
    if (lane == 0) warp_count[pass & 1][warp] = __popc(m);
    __syncthreads();
    int rank = tail, total = 0;
#pragma unroll
    for (int w = 0; w < FWD_WARPS; ++w) {
      const int n = warp_count[pass & 1][w];
      rank += w < warp ? n : 0;
      total += n;
    }
    if (keep) ring[(rank + __popc(m & ((1u << lane) - 1u))) % RING] = sid;
    tail += total;

    const bool last = cs + SCAN_CHUNKS >= hi;
    while (tail - head >= BATCH || (last && tail > head)) {
      const int nf = min(tail - head, BATCH);
      __syncthreads();                 // ids appended; last batch consumed
      for (int q = threadIdx.x; q < nf * NCOL; q += FWD_THREADS)
        table[q] = vtb[(size_t)ring[(head + q / NCOL) % RING] * NCOL +
                       q % NCOL];
      __syncthreads();
      for (int k = 0; k < nf; ++k) {
        const float* c = table + k * NCOL;
        if (c[VALID] > 0.f) {
          const float w0 = affine(c, W0, x0, y0);
          const float w1 = affine(c, W1, x0, y0);
          const float w2 = affine(c, W2, x0, y0);
          const float nrm = affine(c, NRM, x0, y0);
          const float s = nrm + (nrm >= 0.f ? eps : -eps);
          if (w0 * s >= 0.f && w1 * s >= 0.f && w2 * s >= 0.f) {
            const float z = affine(c, ZU, x0, y0) / s;
            if (z > bz) {
              bz = z;
              bf = ring[(head + k) % RING];
            }
          }
        }
        if (with_softmask && in_bbox(c, x0, y0)) {
          Candidates cd;
          distance_candidates(c, x0, y0, sentinel, cd);
          pr = pr * (1.f - expf(-inv_sigma * cd.d));
        }
      }
      head += nf;
    }
  }

  if (wi < W && hrow < H) {            // padded pixels are not written
    const size_t o = ((size_t)b * H + hrow) * W + wi;
    fid[o] = bf;
    prod[o] = pr;
  }
}

// ---------------------------------------------------------------------------
// K2: soft-mask gradient w.r.t. the scaled image-space vertices.
//
// Replaces kaolin_tpu/render/mesh/_fused.py::_bwd_kernel (launched by
// _fused_backward).
//
// Bound: bytes.  The function's work is the (face, pixel) pairs inside the
// face's enlarged bbox where g*prod != 0 (background pixels; ~1 M at the
// 512^2 cell, ~125 flops each), far less than reading g*prod, the face
// table and the chunk metadata once and writing the (nC*FC, 6) rows.
//
// Design.  The image is cut into units, a tile's blocks of 8 x SW pixels
// (SW = 32, or 16 where the tile width is not a multiple of 32).
//   fused_backward_units_kernel marks the units that hold a pixel with
//   g*prod != 0: covered pixels have g*prod = 0, so the interior of the
//   mesh drops out here, at one load per pixel.
//   fused_backward_kernel runs one CTA per (chunk, slice s of S, view).
//   The chunk's units are those of its tile range that its bbox meets
//   (closed test) and that are marked; the i-th of them, in order, goes to
//   slice i % S.  At each of its units the CTA lists the pixels with
//   g*prod != 0 and the chunk's faces whose enlarged bbox meets the unit,
//   both ascending.  The (face, pixel) candidates, face-major, go to the 8
//   warps 32 at a time in turn, so a unit's work spreads over the whole
//   CTA however few of the 64 faces reach it.  Each warp queues the pairs
//   inside the face's bbox (half-open, as the plain version) and runs its
//   queue 32 pairs at a time, one per lane, with the plain version's
//   arithmetic: p, dL/dd = -inv_sigma * p * g / (1 - p + 1e-7) to the
//   argmin candidate only (edges e = 0..2 before vertices, the first `== d`
//   wins, an edge only where its foot lies on the segment).  The queue is
//   face-major, so the lanes of one face are neighbours: a segmented
//   shuffle sum adds them, and the face's last lane adds the sum to the
//   warp's row of that face in shared memory.  At the end the CTA adds its
//   8 warps' rows in warp order and writes them, zeros included, to its
//   slot of the scratch (B, nC, S, FC, 6); fused_backward_sum_kernel adds
//   the S slots in slice order.
// No atomics: every sum is taken in an order fixed by the data, so a run
// repeats its bits, and kernel and plain version differ only in that order.

__host__ __device__ __forceinline__ int unit_width(int TW) {
  return TW % 32 == 0 ? 32 : 16;
}

// active (B, U): unit u of view b holds a pixel with g*prod != 0
__global__ void __launch_bounds__(BWD_THREADS) fused_backward_units_kernel(
    const float* __restrict__ gprod,        // (B, H, W)
    int* __restrict__ active,               // (B, U)
    int H, int W, int nJ, int TW) {
  const int u = blockIdx.x, b = blockIdx.y, U = gridDim.x;
  const int SW = unit_width(TW), nsub = TW / SW, t = u / nsub;
  const int hrow = (t / nJ) * PS + threadIdx.x / SW;
  const int wi = (t % nJ) * TW + (u % nsub) * SW + threadIdx.x % SW;
  const bool nz = threadIdx.x < PS * SW && hrow < H && wi < W &&
                  gprod[((size_t)b * H + hrow) * W + wi] != 0.f;
  const int any = __syncthreads_or(nz);
  if (threadIdx.x == 0) active[(size_t)b * U + u] = any;
}

// The gradient of one (face, pixel) pair w.r.t. the face's 6 coordinates.
__device__ __forceinline__ void pair_gradient(const float* f, float x0,
                                              float y0, float g,
                                              float inv_sigma,
                                              float sentinel, float (&v)[6]) {
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
        v[2 * e] = dd * (dB - dC * y2);
        v[2 * e + 1] = dd * (dC * x2 - dA);
        v[2 * n] = dd * (dC * y1 - dB);
        v[2 * n + 1] = dd * (dA - dC * x1);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    if (remaining && cd.cand[3 + w] == cd.d) {
      remaining = false;
      v[2 * w] = dd * 2.f * (f[VX + 2 * w] - x0);
      v[2 * w + 1] = dd * 2.f * (f[VX + 2 * w + 1] - y0);
    }
  }
}

// Run the first n entries (face << 16 | index into the unit's pixel list)
// of a warp's queue, one per lane, and add each face's sum to rows[face].
__device__ __forceinline__ void run_queue(
    const int* queue, int n, const float* table, const int* px,
    const float* gv, int r0, int c0, int SW, const Affine& aff,
    float inv_sigma, float sentinel, float* rows, int lane) {
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int k = -1;
  if (lane < n) {
    const int e = queue[lane];
    const int p = px[e & 0xffff];
    k = e >> 16;
    pair_gradient(table + k * NCOL, aff.ax * (float)(c0 + p % SW) + aff.bx,
                  aff.ay * (float)(r0 + p / SW) + aff.by, gv[e & 0xffff],
                  inv_sigma, sentinel, v);
  }
  // inclusive segmented sums over the lanes of one face (neighbours)
  bool same[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int ko = __shfl_up_sync(FULL, k, 1 << j);
    same[j] = lane >= (1 << j) && ko == k;
  }
  const int knext = __shfl_down_sync(FULL, k, 1);
  const bool last = k >= 0 && (lane == 31 || knext != k);
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    float s = v[m];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float o = __shfl_up_sync(FULL, s, 1 << j);
      if (same[j]) s += o;
    }
    if (last) rows[k * 6 + m] += s;
  }
}

__global__ void __launch_bounds__(BWD_THREADS) fused_backward_kernel(
    const int* __restrict__ chunk_tranges,  // (B, nC, 2)
    const float* __restrict__ chunk_bbox,   // (B, nC, 4)
    const float* __restrict__ vt,           // (B, nC, FC, NCOL)
    const float* __restrict__ gprod,        // (B, H, W)
    const int* __restrict__ active,         // (B, U)
    float* __restrict__ partial,            // (B, nC, S, FC, 6)
    int H, int W, int nJ, int TW, int U, Affine aff, float inv_sigma,
    float sentinel) {
  __shared__ float table[FC * NCOL];
  __shared__ float rows[BWD_WARPS][FC * 6];   // each warp's face sums
  __shared__ int act_px[UNIT_PX];             // the unit's pixels, g != 0
  __shared__ float act_g[UNIT_PX];
  __shared__ int faces[FC];                   // the unit's faces, ascending
  __shared__ int queue[BWD_WARPS][64];        // face << 16 | pixel index
  __shared__ int mine[BWD_THREADS];           // this CTA's units of a pass
  __shared__ int warp_count[BWD_WARPS];
  __shared__ unsigned face_mask[2];
  const int c = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int nC = gridDim.x, S = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int SW = unit_width(TW), nsub = TW / SW;

  const float* cbb = chunk_bbox + ((size_t)b * nC + c) * 4;
  const int* act = active + (size_t)b * U;
  for (int q = threadIdx.x; q < BWD_WARPS * FC * 6; q += BWD_THREADS)
    (&rows[0][0])[q] = 0.f;
  float* my_rows = rows[warp];
  int* my_queue = queue[warp];

  bool staged = false;
  const int lo = chunk_tranges[((size_t)b * nC + c) * 2];
  const int hi = chunk_tranges[((size_t)b * nC + c) * 2 + 1];
  const int units = max(hi - lo, 0) * nsub;
  int seen = 0;                          // the chunk's units before this pass
  for (int u0 = 0; u0 < units; u0 += BWD_THREADS) {
    // this pass: rank the chunk's units u0 .. u0 + 255, keep slice s's
    const int uu = u0 + threadIdx.x;
    int unit = 0;
    bool keep = false;
    if (uu < units) {
      const int t = lo + uu / nsub;
      const int r0 = (t / nJ) * PS, c0 = (t % nJ) * TW + (uu % nsub) * SW;
      unit = t * nsub + uu % nsub;
      keep = box_hits(cbb, pixel_rect(aff, r0, r0 + PS - 1, c0, c0 + SW - 1))
             && act[unit] != 0;
    }
    const unsigned m = __ballot_sync(FULL, keep);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int rank = seen, total = 0;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) {
      const int n = warp_count[w];
      rank += w < warp ? n : 0;
      total += n;
    }
    rank += __popc(m & below);
    // ranks r = s, s + S, ... of this pass, in order
    const int first = seen + ((s - seen % S) % S + S) % S;
    if (keep && rank % S == s) mine[(rank - first) / S] = unit;
    const int count = total + seen > first ? (total + seen - first - 1) / S + 1
                                           : 0;
    seen += total;
    if (count > 0 && !staged) {          // block-uniform
      const float* src = vt + ((size_t)b * nC + c) * FC * NCOL;
      for (int q = threadIdx.x; q < FC * NCOL; q += BWD_THREADS)
        table[q] = src[q];
      staged = true;
    }
    __syncthreads();

    for (int i = 0; i < count; ++i) {
      const int u = mine[i];
      const int t = u / nsub;
      const int r0 = (t / nJ) * PS, c0 = (t % nJ) * TW + (u % nsub) * SW;
      const Rect sub = pixel_rect(aff, r0, r0 + PS - 1, c0, c0 + SW - 1);
      // the unit's pixels with g*prod != 0 and the chunk's faces whose
      // enlarged bbox meets it, both in ascending order
      const int hrow = r0 + threadIdx.x / SW, wi = c0 + threadIdx.x % SW;
      float g = 0.f;
      if (threadIdx.x < PS * SW && hrow < H && wi < W)
        g = gprod[((size_t)b * H + hrow) * W + wi];
      const bool nz = g != 0.f;
      const unsigned mg = __ballot_sync(FULL, nz);
      if (lane == 0) warp_count[warp] = __popc(mg);
      const bool hit = threadIdx.x < FC &&
                       box_hits(table + threadIdx.x * NCOL + BB, sub);
      const unsigned mf = __ballot_sync(FULL, hit);
      if (warp < 2 && lane == 0) face_mask[warp] = mf;
      __syncthreads();
      int r = 0, nact = 0;
#pragma unroll
      for (int w = 0; w < BWD_WARPS; ++w) {
        const int n = warp_count[w];
        r += w < warp ? n : 0;
        nact += n;
      }
      if (nz) {
        r += __popc(mg & below);
        act_px[r] = threadIdx.x;
        act_g[r] = g;
      }
      if (hit) faces[(warp ? __popc(face_mask[0]) : 0) + __popc(mf & below)] =
          threadIdx.x;
      const int nf = __popc(face_mask[0]) + __popc(face_mask[1]);
      __syncthreads();

      // (face, pixel) candidates in face-major order, 32 per warp in turn;
      // each warp queues those inside the face's bbox and runs them
      const int cand = nf * nact;
      int queued = 0;
      for (int c0w = warp * 32; c0w < cand; c0w += BWD_THREADS) {
        const int q = c0w + lane;
        bool in = false;
        int e = 0;
        if (q < cand) {
          const int k = faces[q / nact], a = q % nact;
          const int p = act_px[a];
          in = in_bbox(table + k * NCOL,
                       aff.ax * (float)(c0 + p % SW) + aff.bx,
                       aff.ay * (float)(r0 + p / SW) + aff.by);
          e = k << 16 | a;
        }
        const unsigned mq = __ballot_sync(FULL, in);
        if (in) my_queue[queued + __popc(mq & below)] = e;
        queued += __popc(mq);
        __syncwarp();
        if (queued >= 32) {
          run_queue(my_queue, 32, table, act_px, act_g, r0, c0, SW, aff,
                    inv_sigma, sentinel, my_rows, lane);
          __syncwarp();
          if (lane < queued - 32) my_queue[lane] = my_queue[32 + lane];
          queued -= 32;
          __syncwarp();
        }
      }
      if (queued > 0)
        run_queue(my_queue, queued, table, act_px, act_g, r0, c0, SW, aff,
                  inv_sigma, sentinel, my_rows, lane);
      __syncthreads();                   // the unit's lists are consumed
    }
    __syncthreads();                     // mine and warp_count are reused
  }

  __syncthreads();                       // every warp's rows are done
  float* dst = partial + (((size_t)b * nC + c) * S + s) * FC * 6;
  for (int q = threadIdx.x; q < FC * 6; q += BWD_THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) v += rows[w][q];
    dst[q] = v;
  }
}

// out (B*nC, FC*6) = the sum of partial (B*nC, S, FC*6) over its S slots,
// in slice order.
__global__ void fused_backward_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int S,
                                          int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p =
      partial + (size_t)(i / (FC * 6)) * S * FC * 6 + i % (FC * 6);
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += p[(size_t)s * FC * 6];
  out[i] = v;
}

}  // namespace

extern "C" int dibr_fused_forward(const void* tile_ranges,
                                  const void* chunk_bbox, const void* vt,
                                  void* fid, void* prod, int B, int nC,
                                  int T, int H, int W, int nJ, int TW,
                                  float ax, float bx, float ay, float by,
                                  float eps, float inv_sigma, float sentinel,
                                  int with_softmask, void* stream) {
  if (TW < SUB || TW % SUB != 0 || nJ < 1 || T % nJ != 0)
    return (int)cudaErrorInvalidValue;
  const int nSI = (T / nJ * PS + SUB - 1) / SUB, nSJ = nJ * TW / SUB;
  if (B > 0 && T > 0) {
    fused_forward_kernel<<<dim3(nSI * nSJ, B), FWD_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int*)tile_ranges, (const float*)chunk_bbox, (const float*)vt,
        (int*)fid, (float*)prod, nC, T, H, W, nJ, TW,
        Affine{ax, bx, ay, by}, eps, inv_sigma, sentinel, with_softmask);
  }
  return (int)cudaGetLastError();
}

// active: (B, T * TW / unit_width(TW)) int scratch; partial: (B, nC, S, FC,
// 6) float scratch
extern "C" int dibr_fused_backward(const void* chunk_tranges,
                                   const void* chunk_bbox, const void* vt,
                                   const void* gprod, void* active,
                                   void* partial, void* out, int B, int nC,
                                   int S, int T, int H, int W, int nJ, int TW,
                                   float ax, float bx, float ay, float by,
                                   float inv_sigma, float sentinel,
                                   void* stream) {
  if (TW < 16 || TW % 16 != 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (B > 0 && nC > 0 && T > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int U = T * (TW / unit_width(TW));
    fused_backward_units_kernel<<<dim3(U, B), BWD_THREADS, 0, st>>>(
        (const float*)gprod, (int*)active, H, W, nJ, TW);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fused_backward_kernel<<<dim3(nC, S, B), BWD_THREADS, 0, st>>>(
        (const int*)chunk_tranges, (const float*)chunk_bbox, (const float*)vt,
        (const float*)gprod, (const int*)active, (float*)partial, H, W, nJ,
        TW, U, Affine{ax, bx, ay, by}, inv_sigma, sentinel);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = B * nC * FC * 6;
    fused_backward_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)partial, (float*)out, S, n);
  }
  return (int)cudaGetLastError();
}
