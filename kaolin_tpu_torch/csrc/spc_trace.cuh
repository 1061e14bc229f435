// The coherent-ray SPC trace kernel (K3) for Hopper (sm_90a): the kernel
// template and its launch, included by spc_trace.cu (K3, stage 6) and by
// probes.cu (P3: the same kernel cut at stages 1-6).
//
// Replaces the Pallas TPU kernel kaolin_tpu/render/spc/raster.py::
// _trace_kernel.  The caller (kaolin_tpu_torch/render/spc/_trace.py)
// culls the blocks, allocates the outputs (filled with inf / -1 / 0) and
// holds the plain PyTorch version.  The kernel launches on the caller's
// stream, never synchronises and never allocates; launch() returns
// cudaGetLastError().
//
// One warp per active ray block, one ray per lane (rt <= 32; lanes past rt
// carry a ray that hits nothing).  A block reads nb candidate cells of the
// cell table, each a row of cw slots (x, y, z, local leaf index, -1 for a
// slot without a voxel).  The warps of a CTA share nothing and never wait
// for each other, so a CTA is only a scheduling unit (WARPS blocks), and the
// card holds every block of a level-10 sphere at once.
//
// The walk.  The warp stages a row UNIT slots at a time: every lane
// reads the four integers of its slots (all loads of the unit started before
// any is used), and a ballot and a prefix popcount pack the slots that hold
// a voxel to the front of the warp's buffer in shared memory, in slot
// order, as float corners (float)x * side - 1 and the final pidx, pid +
// pidx_offset.  So a corner is computed once per block and voxel, and the
// tests never see a slot without a voxel, wherever a row's holes are.  The
// buffer is padded with voxels at +inf (no ray hits them) to a multiple of
// UNROLL.  Then every lane tests its ray against the packed voxels,
// UNROLL at a time: each voxel is one broadcast read of shared memory,
// and the slab tests of a step are independent, so they overlap within a
// lane.  A lane that hits appends the
// hit at position count of its ray's own output row (device memory; the
// first kbuf are kept, the count stays exact): candidate order is the
// order of the loop, there is no ballot, no rank and no barrier in it, and
// the output row is the k-buffer, so shared memory does not grow with rt
// or kbuf.  Hits are rare (under 1 % of the tests at a level-10 sphere), so
// the appends of a step sit behind one branch.
//
// The sort.  At the end the warp takes its rays in turn: it reads the ray's
// min(count, kbuf) entries back from the output row (L2) into its buffer,
// ranks each by t_near (rank = #entries with a smaller t, or an equal t
// earlier in candidate order: a stable sort), one entry per lane, and writes
// it to its rank in the same row.  Each warp owns its rows: no atomics, the
// result does not change from run to run.
//
// What bounds it: slab tests, 18 float operations for each (ray, voxel) pair
// of the block's candidate cells; the cell rows are read once per block
// from device memory (L2-resident for a sphere at level 10) and the outputs
// written once.  The TPU kernel packed hits with a log-shift network over
// vector lanes; with one ray per lane there is nothing to pack.
//
// -fmad=false keeps every product and sum of the slab test rounded on its
// own, as PyTorch computes it, so t_near and t_far equal the plain
// version's bit for bit (see slab() for the one place where the kernel
// takes another route to the same bits).
//
// The kernel is a template on STAGE, for measuring what each part costs
// (the port of scripts/probe_r5_kbisect.py::staged_kernel, which cut the
// TPU kernel at the same places; probes.cu instantiates the stages).
// STAGE 6 is K3; the others stop early:
//   1  slab test and per-ray count;                          writes count
//   2  + each hit's rank among its ray's hits, kept live;    writes count
//   3  + packing: each cell's hits for the ray at ranks 0, 1, ... of the
//      ray's output row, which the next cell overwrites; the last candidate
//      cell's hits stay (t_near only), inf after them
//   4  + the k-buffer append: the first kbuf hits in candidate order,
//      unsorted
//   5  + the rank sort over all kbuf entries, padding included
//   6  + the rank sort over min(count, kbuf) entries only (K3)
// Every stage takes K3's dynamic shared memory and CTA shape, so the
// stages run at K3's occupancy and their differences are work, not
// residency.
//
// The shape (THREADS, MAX_RT, UNIT, UNROLL, MIN_CTAS below) and warp_bytes()
// are mirrored in the wrapper (_THREADS, _MAX_RT, _smem_bytes), which refuses
// what the kernel cannot take before it launches.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 64;            // per CTA
constexpr int WARPS = THREADS / 32;    // ray blocks per CTA
constexpr int MIN_CTAS = 8;            // per SM at least: caps the registers
constexpr int MAX_RT = 32;             // rays per block: one per lane
constexpr int UNIT = 256;              // slots staged at once
constexpr int CHUNKS = UNIT / 32;      // slots per lane and unit
constexpr int UNROLL = 4;              // voxels per step of the test loop
constexpr unsigned FULL = 0xffffffffu;

// an empty asm that reads v: v is computed, and nothing else happens
__device__ __forceinline__ void keep_live(int v) { asm volatile("" ::"r"(v)); }

// A warp's buffer in dynamic shared memory: the staged unit (UNIT voxels and
// the padding), and after the walk the sort's kbuf entries (t_near, pidx, and
// t_far with exit depths).
__host__ __device__ constexpr size_t warp_bytes(int kbuf, bool with_exit) {
  const size_t unit = (size_t)(UNIT + UNROLL) * sizeof(float4);
  const size_t sort = (size_t)kbuf * 4 * (with_exit ? 3 : 2);
  return ((unit > sort ? unit : sort) + 15) & ~(size_t)15;
}

// A ray: origin, 1 / direction, and per axis the step s = side / direction
// split by its sign: n = s where s < 0, else -0; p = s where s >= 0, else -0.
struct Ray {
  float ox, oy, oz, ix, iy, iz, nx, ny, nz, px, py, pz;
};

__device__ __forceinline__ void split_step(float s, float& n, float& p) {
  n = s < 0.f ? s : -0.f;
  p = s < 0.f ? -0.f : s;
}

// The slab test of one voxel corner against one ray: entry and exit depths.
// Per axis the plain version takes t0 = (corner - o) * inv, t1 = t0 + s and
// their min and max.  For finite values t0 + s >= t0 exactly when s >= 0
// (a rounded sum is monotone) and t0 + -0 is t0 bit for bit, so the min is
// t0 + n and the max is t0 + p: two sums on the float pipe for one sum and
// a min and a max, which run at half its rate.  The wrapper's rays are
// finite (|1 / direction| <= 1e12).
__device__ __forceinline__ void slab(const float4& v, const Ray& r, float& tn,
                                     float& tf) {
  const float x0 = (v.x - r.ox) * r.ix;
  const float y0 = (v.y - r.oy) * r.iy;
  const float z0 = (v.z - r.oz) * r.iz;
  tn = fmaxf(fmaxf(x0 + r.nx, y0 + r.ny), z0 + r.nz);
  tf = fminf(fminf(x0 + r.px, y0 + r.py), z0 + r.pz);
}

template <bool EXIT, int STAGE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
spc_trace_kernel(const float* __restrict__ rays,
                 const int* __restrict__ cell_rows,
                 const int* __restrict__ block_cells,
                 const int* __restrict__ nb,
                 const long long* __restrict__ block_ids,
                 float* tn_out, float* tf_out, int* pi_out,
                 int* __restrict__ cnt_out,
                 int nA, int rt, int cw, int ckmax, int kbuf, float side,
                 int off) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int a = blockIdx.x * WARPS + warp;
  if (a >= nA) return;                 // warps share nothing: no barrier below
  float4* unit = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem) + warp * warp_bytes(kbuf, EXIT));

  // this lane's ray; a lane past rt gets one that hits nothing (t_near < 0
  // at every finite corner)
  Ray r = {3e38f, 3e38f, 3e38f, 1.f, 1.f, 1.f, -0.f, -0.f, -0.f, 0.f, 0.f, 0.f};
  if (lane < rt) {
    const float* src = rays + ((size_t)a * rt + lane) * 6;
    r.ox = src[0]; r.oy = src[1]; r.oz = src[2];
    r.ix = src[3]; r.iy = src[4]; r.iz = src[5];
    split_step(side * r.ix, r.nx, r.px);
    split_step(side * r.iy, r.ny, r.py);
    split_step(side * r.iz, r.nz, r.pz);
  }
  const long long b = block_ids[a];
  const size_t row0 = (size_t)b * rt * kbuf;     // the block's output rows
  const size_t row = row0 + (size_t)lane * kbuf;   // this lane's ray's
  int cnt = 0;
  int in_cell = 0, most = 0;           // STAGE 3: hits in this cell, the most

  const int nbk = nb[a];
  const int* ids = block_cells + (size_t)a * ckmax;
  int my_id = 0;                       // candidate cell s - s % 32 + lane
  for (int s = 0; s < nbk; ++s) {
    if ((s & 31) == 0) my_id = s + lane < nbk ? ids[s + lane] : 0;
    const int* src =
        cell_rows + (size_t)__shfl_sync(FULL, my_id, s & 31) * 4 * cw;
    if (STAGE == 3) {
      most = max(most, in_cell);
      in_cell = 0;
    }
    for (int c0 = 0; c0 < cw; c0 += UNIT) {
      // stage slots [c0, c0 + UNIT) of the row: the voxels among them
      int vx[CHUNKS], vy[CHUNKS], vz[CHUNKS], vp[CHUNKS];
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int l = c0 + c * 32 + lane;
        vp[c] = -1;
        if (l < cw) {
          vx[c] = src[l]; vy[c] = src[cw + l]; vz[c] = src[2 * cw + l];
          vp[c] = src[3 * cw + l];
        }
      }
      __syncwarp();                    // the previous unit is tested
      int n = 0;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        if (c0 + c * 32 >= cw) break;  // warp-uniform
        const bool live = vp[c] >= 0;
        const unsigned m = __ballot_sync(FULL, live);
        if (live) {
          unit[n + __popc(m & below)] = make_float4(
              (float)vx[c] * side - 1.0f, (float)vy[c] * side - 1.0f,
              (float)vz[c] * side - 1.0f, __int_as_float(vp[c] + off));
        }
        n += __popc(m);
      }
      if (lane < UNROLL) {             // a voxel at +inf is hit by no ray
        unit[n + lane] = make_float4(INFINITY, INFINITY, INFINITY,
                                     __int_as_float(-1));
      }
      __syncwarp();

      // test this lane's ray against the n voxels, UNROLL at a time
      for (int j = 0; j < n; j += UNROLL) {
        bool hit[UNROLL], any = false;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          float tn, tf;
          slab(unit[j + k], r, tn, tf);      // same address in every lane
          // tf > tn and tn > 0 give tf > 0, the hit rule's third term
          hit[k] = tf > tn && tn > 0.f;
          any |= hit[k];
        }
        if (!any) continue;            // most steps miss
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          if (!hit[k]) continue;
          const int pos = STAGE == 3 ? in_cell : cnt;
          if (STAGE == 2) keep_live(pos);
          if (STAGE >= 3 && pos < kbuf) {
            // a hit is rare: its voxel is read and its depths are computed
            // again here, so that the loop above keeps only the flags
            const float4 v = unit[j + k];
            float tn, tf;
            slab(v, r, tn, tf);
            tn_out[row + pos] = tn;
            if (STAGE >= 4) {
              pi_out[row + pos] = __float_as_int(v.w);
              if (EXIT) tf_out[row + pos] = tf;
            }
          }
          ++cnt;
          if (STAGE == 3) ++in_cell;
        }
      }
    }
  }

  if (STAGE == 3 && lane < rt) {       // inf after the last cell's hits
    const int n = min(max(most, in_cell), kbuf);
    for (int i = in_cell; i < n; ++i) tn_out[row + i] = INFINITY;
  }
  if (STAGE >= 5) {
    // the warp's buffer now holds the sort's entries: (3, kbuf), t_far's
    // only with EXIT
    float* st = reinterpret_cast<float*>(unit);
    int* sp = reinterpret_cast<int*>(st + kbuf);
    float* sf = st + 2 * kbuf;
    for (int q = 0; q < rt; ++q) {
      int n = __shfl_sync(FULL, min(cnt, kbuf), q);
      if (STAGE == 6 && n <= 1) continue;          // warp-uniform
      const size_t rq = row0 + (size_t)q * kbuf;
      __syncwarp();                    // the row's appends and the previous
      //                                  ray's sort are done
      for (int i = lane; i < n; i += 32) {
        st[i] = __ldcg(tn_out + rq + i);
        sp[i] = __ldcg(pi_out + rq + i);
        if (EXIT) sf[i] = __ldcg(tf_out + rq + i);
      }
      if (STAGE == 5) {                // pad, then sort all kbuf entries
        for (int i = n + lane; i < kbuf; i += 32) {
          st[i] = INFINITY;
          sp[i] = -1;
          if (EXIT) sf[i] = INFINITY;
        }
        n = kbuf;
      }
      __syncwarp();
      for (int i = lane; i < n; i += 32) {
        const float ti = st[i];
        int rank = 0;
        for (int j = 0; j < n; ++j) {
          const float tj = st[j];      // same address in every lane
          rank += (tj < ti) || (tj == ti && j < i);
        }
        tn_out[rq + rank] = ti;
        pi_out[rq + rank] = sp[i];
        if (EXIT) tf_out[rq + rank] = sf[i];
      }
    }
  }
  if (lane < rt) cnt_out[(size_t)b * rt + lane] = cnt;
}

template <int STAGE>
int launch(const void* rays, const void* cell_rows, const void* block_cells,
           const void* nb, const void* block_ids, void* tn_out, void* tf_out,
           void* pi_out, void* cnt_out, int nA, int rt, int cw, int ckmax,
           int kbuf, float side, int with_exit, int pidx_offset,
           void* stream) {
  if (rt < 1 || rt > MAX_RT || cw < 1 || kbuf < 1 || ckmax < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = WARPS * warp_bytes(kbuf, with_exit != 0);
  auto kernel = with_exit ? spc_trace_kernel<true, STAGE>
                          : spc_trace_kernel<false, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (nA > 0) {
    kernel<<<(nA + WARPS - 1) / WARPS, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)rays, (const int*)cell_rows, (const int*)block_cells,
        (const int*)nb, (const long long*)block_ids, (float*)tn_out,
        (float*)tf_out, (int*)pi_out, (int*)cnt_out, nA, rt, cw, ckmax, kbuf,
        side, pidx_offset);
  }
  return (int)cudaGetLastError();
}

}  // namespace
