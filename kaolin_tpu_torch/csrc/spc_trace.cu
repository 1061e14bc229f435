// Coherent-ray SPC trace kernel (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel kaolin_tpu/render/spc/raster.py::
// _trace_kernel.  Built by kaolin_tpu_torch/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// and called through ctypes from kaolin_tpu_torch/render/spc/_trace.py,
// which culls the blocks, allocates the outputs (filled with inf / -1 / 0)
// and holds the plain PyTorch version.  The kernel launches on the
// caller's stream, never synchronises and never allocates; the entry point
// returns cudaGetLastError().
//
// One block (CTA) per active ray block: rt <= 32 rays, nb candidate cells
// of the cell table, each a row of cw voxels (x, y, z, local leaf index,
// -1 padding).  For each candidate cell in order the CTA stages the row in
// shared memory; warp w owns rays w, w + 8, w + 16, w + 24 and tests each
// of them against the row 32 voxels at a time.  A ballot and a prefix
// popcount give each hit its rank, so the hits are appended to the ray's
// k-buffer (shared memory) in candidate order, and only the first kbuf are
// kept; the count stays exact.  At the end each warp sorts its rays'
// k-buffers by t_near with a stable rank sort (rank = #entries with a
// smaller t, or an equal t earlier in candidate order) and writes every
// entry straight to its rank in the block's output rows.  Each CTA owns its
// rows: no atomics, the result does not change from run to run.
//
// What bounds it: slab tests, about 30 float operations for each (ray,
// voxel) pair of the block's candidate cells; the cell rows are read once
// per block from device memory (L2-resident for a sphere at level 10) and
// the outputs written once.  The TPU kernel packed hits with a log-shift
// network over vector lanes; here a warp ballot does the packing in one
// instruction.
//
// -fmad=false keeps t0 + side * inv a rounded product and a rounded sum, as
// PyTorch computes it, so t_near and t_far equal the plain version's bit
// for bit.
//
// The kernel is a template on STAGE, for measuring what each part costs
// (the port of scripts/probe_r5_kbisect.py::staged_kernel, which cut the
// TPU kernel at the same places).  STAGE 6 is K3 and compiles to the same
// code as before the template; the others stop early:
//   1  slab test and per-ray count (ballot + popcount);     writes count
//   2  + each hit's rank in the ballot, kept live;           writes count
//   3  + packing: each cell's hits for the ray at ranks 0, 1, ... of a
//      row that the next cell overwrites; the last candidate cell's row is
//      written (t_near only), the wrapper's inf fill pads it
//   4  + the k-buffer append: the first kbuf hits in candidate order,
//      unsorted
//   5  + the rank sort over all kbuf entries, padding included
//   6  + the rank sort over min(count, kbuf) entries only (K3)
// Every stage takes K3's dynamic shared memory, so the stages run at K3's
// occupancy and their differences are work, not residency.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int RPW = 4;                 // rays per warp: rt <= NWARPS * RPW

// an empty asm that reads v: v is computed, and nothing else happens
__device__ __forceinline__ void keep_live(int v) { asm volatile("" ::"r"(v)); }

template <bool EXIT, int STAGE>
__global__ void __launch_bounds__(THREADS)
spc_trace_kernel(const float* __restrict__ rays,
                 const int* __restrict__ cell_rows,
                 const int* __restrict__ block_cells,
                 const int* __restrict__ nb,
                 const long long* __restrict__ block_ids,
                 float* __restrict__ tn_out, float* __restrict__ tf_out,
                 int* __restrict__ pi_out, int* __restrict__ cnt_out,
                 int rt, int cw, int ckmax, int kbuf, float side) {
  extern __shared__ int smem[];
  int* cell = smem;                                      // (4, cw)
  float* ktn = reinterpret_cast<float*>(smem + 4 * cw);  // (rt, kbuf)
  int* kpi = reinterpret_cast<int*>(ktn + rt * kbuf);    // (rt, kbuf)
  float* ktf = reinterpret_cast<float*>(kpi + rt * kbuf);  // (rt, kbuf)

  const int a = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  float ox[RPW], oy[RPW], oz[RPW], ix[RPW], iy[RPW], iz[RPW];
  float sx[RPW], sy[RPW], sz[RPW];
  int cnt[RPW];
  int last[RPW];                       // STAGE 3: hits in the latest cell
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp + q * NWARPS;
    cnt[q] = 0;
    last[q] = 0;
    if (r < rt) {
      const float* ray = rays + ((size_t)a * rt + r) * 6;
      ox[q] = ray[0]; oy[q] = ray[1]; oz[q] = ray[2];
      ix[q] = ray[3]; iy[q] = ray[4]; iz[q] = ray[5];
      sx[q] = side * ix[q]; sy[q] = side * iy[q]; sz[q] = side * iz[q];
    }
  }

  const int nbk = nb[a];
  for (int s = 0; s < nbk; ++s) {
    const int* src = cell_rows + (size_t)block_cells[(size_t)a * ckmax + s]
                                     * 4 * cw;
    __syncthreads();                   // previous row no longer read
    for (int i = threadIdx.x; i < 4 * cw; i += THREADS) cell[i] = src[i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int r = warp + q * NWARPS;
      if (r >= rt) continue;           // warp-uniform
      int in_cell = 0;                 // STAGE 3: the ray's hits in this cell
      for (int base = 0; base < cw; base += 32) {
        const int l = base + lane;
        bool hit = false;
        float tn = 0.f, tf = 0.f;
        int pid = -1;
        if (l < cw) {
          pid = cell[3 * cw + l];
          if (pid >= 0) {
            const float lx = (float)cell[l] * side - 1.0f;
            const float ly = (float)cell[cw + l] * side - 1.0f;
            const float lz = (float)cell[2 * cw + l] * side - 1.0f;
            const float x0 = (lx - ox[q]) * ix[q], x1 = x0 + sx[q];
            const float y0 = (ly - oy[q]) * iy[q], y1 = y0 + sy[q];
            const float z0 = (lz - oz[q]) * iz[q], z1 = z0 + sz[q];
            tn = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
            tf = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
            hit = tf > tn && tf > 0.f && tn > 0.f;
          }
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (STAGE == 2) keep_live(__popc(m & below));
        if (STAGE >= 3 && hit) {
          const int pos = (STAGE == 3 ? in_cell : cnt[q]) + __popc(m & below);
          if (pos < kbuf) {
            ktn[r * kbuf + pos] = tn;
            if (STAGE >= 4) {
              kpi[r * kbuf + pos] = pid;
              if (EXIT) ktf[r * kbuf + pos] = tf;
            }
          }
        }
        cnt[q] += __popc(m);
        if (STAGE == 3) in_cell += __popc(m);
      }
      if (STAGE == 3) last[q] = in_cell;
    }
  }
  __syncwarp();                        // a warp reads only its own rays

  const long long b = block_ids[a];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp + q * NWARPS;
    if (r >= rt) continue;
    const float* kt = ktn + r * kbuf;
    const size_t row = ((size_t)b * rt + r) * kbuf;
    if (STAGE == 3) {
      const int n = min(last[q], kbuf);
      for (int i = lane; i < n; i += 32) tn_out[row + i] = kt[i];
    } else if (STAGE == 4) {
      const int n = min(cnt[q], kbuf);
      for (int i = lane; i < n; i += 32) {
        tn_out[row + i] = kt[i];
        pi_out[row + i] = kpi[r * kbuf + i];
        if (EXIT) tf_out[row + i] = ktf[r * kbuf + i];
      }
    } else if (STAGE >= 5) {
      int n = min(cnt[q], kbuf);
      if (STAGE == 5) {                // pad, then sort all kbuf entries
        for (int i = n + lane; i < kbuf; i += 32) {
          ktn[r * kbuf + i] = INFINITY;
          kpi[r * kbuf + i] = -1;
          if (EXIT) ktf[r * kbuf + i] = INFINITY;
        }
        __syncwarp();
        n = kbuf;
      }
      for (int i = lane; i < n; i += 32) {
        const float ti = kt[i];
        int rank = 0;
        for (int j = 0; j < n; ++j) {
          const float tj = kt[j];      // same address in every lane
          rank += (tj < ti) || (tj == ti && j < i);
        }
        tn_out[row + rank] = ti;
        pi_out[row + rank] = kpi[r * kbuf + i];
        if (EXIT) tf_out[row + rank] = ktf[r * kbuf + i];
      }
    }
    if (lane == 0) cnt_out[(size_t)b * rt + r] = cnt[q];
  }
}

template <int STAGE>
int launch(const void* rays, const void* cell_rows, const void* block_cells,
           const void* nb, const void* block_ids, void* tn_out, void* tf_out,
           void* pi_out, void* cnt_out, int nA, int rt, int cw, int ckmax,
           int kbuf, float side, int with_exit, void* stream) {
  if (rt < 1 || rt > NWARPS * RPW || cw < 1 || kbuf < 1 || ckmax < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * ((size_t)4 * cw +
                                     (size_t)rt * kbuf * (with_exit ? 3 : 2));
  auto kernel = with_exit ? spc_trace_kernel<true, STAGE>
                          : spc_trace_kernel<false, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (nA > 0) {
    kernel<<<nA, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)rays, (const int*)cell_rows, (const int*)block_cells,
        (const int*)nb, (const long long*)block_ids, (float*)tn_out,
        (float*)tf_out, (int*)pi_out, (int*)cnt_out, rt, cw, ckmax, kbuf,
        side);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K3 (stage 6), or the same kernel cut at `stage` 1-5 (see the top of this
// file) for measuring its parts.
extern "C" int spc_trace(const void* rays, const void* cell_rows,
                         const void* block_cells, const void* nb,
                         const void* block_ids, void* tn_out, void* tf_out,
                         void* pi_out, void* cnt_out, int nA, int rt, int cw,
                         int ckmax, int kbuf, float side, int with_exit,
                         int stage, void* stream) {
#define ARGS rays, cell_rows, block_cells, nb, block_ids, tn_out, tf_out, \
    pi_out, cnt_out, nA, rt, cw, ckmax, kbuf, side, with_exit, stream
  switch (stage) {
    case 1: return launch<1>(ARGS);
    case 2: return launch<2>(ARGS);
    case 3: return launch<3>(ARGS);
    case 4: return launch<4>(ARGS);
    case 5: return launch<5>(ARGS);
    case 6: return launch<6>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
