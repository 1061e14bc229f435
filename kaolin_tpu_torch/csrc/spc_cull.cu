// SPC beam culling kernel for Hopper (sm_90a), plain C interface: the first
// stage of the 'mosaic' engine's culling, the super-tile and block beam
// tests and their ordered first-k packs.
//
// It replaces no Pallas kernel: the JAX package culls in jnp inside
// kaolin_tpu/render/spc/raster.py::_raster_trace_mosaic (:710).  The port's
// plain version, kaolin_tpu_torch/render/spc/raster.py::
// _cull_candidates_torch, runs the same tests as some fifty PyTorch passes
// over (nS, Mc) and (nB, cs) temporaries of 100-200 MB each at a 1M-ray
// frame; this kernel computes what it returns, bit for bit, in one launch.
// Built by kaolin_tpu_torch/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// with spc_cull_module.cpp (its Python entry point: the input test, the
// outputs, the launch) and called from raster.py::_cull_candidates_cuda.
// The kernel launches on the caller's stream, never synchronises and never
// allocates; the entry point returns cudaGetLastError().
//
// Inputs: the cell bounds blo, bhi (Mc + 1, 3), the last row the dump row;
// origins and directions o, d (nB, rt, 3), nB = 64 * nS.  Outputs: n_b
// (nB,) int64, each block's candidate count over its super-tile's whole
// list; blk_ids (nB, ck_max) int32, the first ck_max candidates' cell ids in
// list order, padded with Mc; sat, a byte set where a super-tile has more
// than cs candidate cells or a block more than ck_max (the entry point
// zeroes it before the launch).
//
// One CTA per super-tile (64 blocks of rt rays), in three steps:
// 1. the beams.  Each warp takes blocks w, w + WARPS, ...: a lane per ray,
//    the min and max of the block's origins and directions by shuffles,
//    kept in shared memory; the super-tile's are the min and max over its
//    64 blocks.  min and max are exact (NaN propagates, as in torch's amin
//    and amax), so these are _beam_bounds' boxes.
// 2. the super-tile's list.  The CTA walks the cells 0..Mc-1 in order,
//    THREADS at a time: a thread tests one cell against the super-tile's
//    beam (beam_meets), a ballot and a popcount per warp and a scan of the
//    warps' counts in shared memory give each passing cell its rank, and
//    the first cs are kept.  The walk stops once more than cs have passed:
//    the list is then full and the super-tile saturated.  The rest of the
//    list is padded with Mc and the dump row's bounds.
// 3. the blocks' lists.  Each warp takes its blocks again and tests every
//    slot of the list against the block's beam, a lane per slot, 32 at a
//    time (padding slots against the dump row, as the plain version does: a
//    beam whose direction box holds 0 on every axis meets it); a ballot
//    packs the first ck_max passing ids in slot order, and n_b counts every
//    pass.
//
// The list lives in shared memory (LIST_BYTES a slot: the id and the cell's
// bounds) where it fits, cs <= ~8,180; else its ids go to an (nS, cs) int32
// scratch in device memory (written and read by the same CTA, across a
// barrier) and the bounds are read from blo and bhi.  One launch either way.
//
// What bounds it: bytes.  The rays are read once (nB * rt * 24 B, 25 MB at
// 1M rays) and blk_ids written once (nB * ck_max * 4 B, 25 MB at ck_max
// 192): ~15 us at 3.35 TB/s.  The tests, nS * Mc + nB * cs (~25M at the SPC
// benchmark's 1M rays, cs 512 and ~16k cells), take ~40 float operations
// and up to six IEEE divisions each; the cell bounds (Mc * 24 B) are read by
// every CTA, from L2.  The plain version writes each test's dozen
// temporaries to device memory and reads them back; here they stay in
// registers, and the lists in shared memory.  What is left is the tests'
// instruction throughput and latency (on an H100 at 700 W the whole launch
// takes ~0.15 ms at those shapes, ~0.22 ms without the early exit below), so
// a warp stops testing a cell or a slot once no lane's answer can be yes.
//
// beam_meets runs raster.py::_beam_chunk_test's operations in its order:
// the two subtractions, the quotient where the direction bound is not 0
// (IEEE division, __fdiv_rn: the plain version's r / where(d == 0, 1, d)
// where its where() keeps the quotient), the max and min over the axes, the
// feasibility terms, tlo <= thi and thi > 0.  No product is added, so
// -fmad=false changes nothing here; it is every kernel's flag.
//
// MAX_RT is K3's (render/spc/_trace.py: _MAX_RT), which the wrapper reads
// to refuse what the kernel cannot take before it launches; the entry point
// (spc_cull_module.cpp) tests every shape; the tests read MAX_SMEM and
// LIST_BYTES to choose a list that does not fit in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // per CTA: one super-tile
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS = 64;             // ray blocks per super-tile
constexpr int MAX_RT = 32;             // rays per block: one per lane
constexpr int MAX_SMEM = 232448;       // shared memory a CTA can use (H100)
constexpr int LIST_BYTES = 4 + 24;     // a list slot: id, lo and hi
constexpr unsigned FULL = 0xffffffffu;

// A beam: the interval box of its rays' origins and directions.
struct Beam {
  float olo[3], ohi[3], dlo[3], dhi[3];
};

// The CTA's static shared memory: the blocks' beams, the super-tile's, the
// warps' pass counts.
struct Shared {
  Beam beam[BLOCKS + 1];
  int warp_n[WARPS];
};

// min and max that give NaN where either operand is NaN, as torch's amin,
// amax, minimum and maximum do; exact otherwise.  One instruction each
// (min.NaN / max.NaN, sm_80 and later).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// raster.py::_beam_chunk_test: can a ray with origin in [b.olo, b.ohi] and
// direction in [b.dlo, b.dhi] meet the box [lo, hi] at some t > 0?  Called
// by the whole warp; a lane that is not ``live`` answers no.  The answer can
// only go from yes to no as axes are added (feas only loses terms, tlo only
// grows, thi only shrinks, a NaN stays), so the warp stops once every lane's
// answer is no.
__device__ __forceinline__ bool beam_meets(const Beam& b, const float* lo,
                                           const float* hi, bool live) {
  bool feas = live;
  float tlo = -INFINITY, thi = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float r1 = hi[a] - b.olo[a];     // t * dlo <= r1
    const float r2 = lo[a] - b.ohi[a];     // t * dhi >= r2
    const float dl = b.dlo[a], dh = b.dhi[a];
    float ub_a = INFINITY, lb_a = 0.f, lb_b = 0.f, ub_b = INFINITY;
    if (dl > 0.f) ub_a = __fdiv_rn(r1, dl);
    if (dl < 0.f) lb_a = __fdiv_rn(r1, dl);
    if (dh > 0.f) lb_b = __fdiv_rn(r2, dh);
    if (dh < 0.f) ub_b = __fdiv_rn(r2, dh);
    feas = feas && (dl != 0.f || r1 >= 0.f) && (dh != 0.f || r2 <= 0.f);
    tlo = max_nan(tlo, max_nan(lb_a, lb_b));
    thi = min_nan(thi, min_nan(ub_a, ub_b));
    if (a < 2 && !__any_sync(FULL, feas && tlo <= thi && thi > 0.f))
      return false;
  }
  return feas && tlo <= thi && thi > 0.f;
}

__host__ __device__ constexpr size_t list_bytes(int cs) {
  return (size_t)cs * LIST_BYTES;
}

__host__ __device__ constexpr bool list_fits(int cs) {
  return list_bytes(cs) <= (size_t)MAX_SMEM - sizeof(Shared);
}

template <bool SMEM_LIST>
__global__ void __launch_bounds__(THREADS, 4)
spc_cull_kernel(const float* __restrict__ blo, const float* __restrict__ bhi,
                const float* __restrict__ o, const float* __restrict__ d,
                long long* __restrict__ n_b, int* __restrict__ blk_ids,
                bool* sat, int* scratch, int rt, int Mc, int cs,
                int ck_max) {
  __shared__ Shared sh;
  extern __shared__ int list[];        // SMEM_LIST: ids[cs], lo[3 cs], hi[3 cs]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int blk0 = blockIdx.x * BLOCKS;

  // 1. the blocks' beams, a lane per ray; then the super-tile's
  for (int k = warp; k < BLOCKS; k += WARPS) {
    Beam b;
    const bool live = lane < rt;
    const size_t r = ((size_t)(blk0 + k) * rt + lane) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ov = live ? o[r + a] : 0.f;
      const float dv = live ? d[r + a] : 0.f;
      b.olo[a] = live ? ov : INFINITY;
      b.ohi[a] = live ? ov : -INFINITY;
      b.dlo[a] = live ? dv : INFINITY;
      b.dhi[a] = live ? dv : -INFINITY;
    }
#pragma unroll
    for (int m = 16; m; m >>= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b.olo[a] = min_nan(b.olo[a], __shfl_xor_sync(FULL, b.olo[a], m));
        b.ohi[a] = max_nan(b.ohi[a], __shfl_xor_sync(FULL, b.ohi[a], m));
        b.dlo[a] = min_nan(b.dlo[a], __shfl_xor_sync(FULL, b.dlo[a], m));
        b.dhi[a] = max_nan(b.dhi[a], __shfl_xor_sync(FULL, b.dhi[a], m));
      }
    }
    if (lane == 0) sh.beam[k] = b;
  }
  __syncthreads();
  if (threadIdx.x < 12) {              // olo, ohi, dlo, dhi: 3 values each
    const int e = threadIdx.x;
    const bool is_min = (e / 3) % 2 == 0;
    float v = reinterpret_cast<const float*>(&sh.beam[0])[e];
    for (int k = 1; k < BLOCKS; ++k) {
      const float x = reinterpret_cast<const float*>(&sh.beam[k])[e];
      v = is_min ? min_nan(v, x) : max_nan(v, x);
    }
    reinterpret_cast<float*>(&sh.beam[BLOCKS])[e] = v;
  }
  __syncthreads();

  // 2. the super-tile's list: the first cs cells its beam meets, in order
  const Beam sup = sh.beam[BLOCKS];
  int* ids = SMEM_LIST ? list : scratch + (size_t)blockIdx.x * cs;
  float* llo = reinterpret_cast<float*>(list + cs);
  float* lhi = llo + 3 * cs;
  int count = 0;                       // the same in every thread
  for (int c0 = 0; c0 < Mc && count <= cs; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = c < Mc ? blo[3 * c + a] : 0.f;
      hi[a] = c < Mc ? bhi[3 * c + a] : 0.f;
    }
    const bool pass = beam_meets(sup, lo, hi, c < Mc);
    const unsigned m = __ballot_sync(FULL, pass);
    if (lane == 0) sh.warp_n[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int n = sh.warp_n[w];
      before += w < warp ? n : 0;
      total += n;
    }
    const int pos = count + before + __popc(m & below);
    if (pass && pos < cs) {
      ids[pos] = c;
      if (SMEM_LIST) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          llo[3 * pos + a] = lo[a];
          lhi[3 * pos + a] = hi[a];
        }
      }
    }
    count += total;
    __syncthreads();                   // warp_n is written again
  }
  for (int j = min(count, cs) + threadIdx.x; j < cs; j += THREADS) {
    ids[j] = Mc;
    if (SMEM_LIST) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        llo[3 * j + a] = blo[3 * Mc + a];
        lhi[3 * j + a] = bhi[3 * Mc + a];
      }
    }
  }
  if (count > cs && threadIdx.x == 0) *sat = true;
  __syncthreads();

  // 3. each block's list: the first ck_max slots its beam meets, in order
  for (int k = warp; k < BLOCKS; k += WARPS) {
    const Beam b = sh.beam[k];
    const int blk = blk0 + k;
    int* out = blk_ids + (size_t)blk * ck_max;
    int n = 0;
    for (int j0 = 0; j0 < cs; j0 += 32) {
      const int j = j0 + lane;
      const int id = j < cs ? ids[j] : Mc;
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = SMEM_LIST ? llo[3 * min(j, cs - 1) + a] : blo[3 * id + a];
        hi[a] = SMEM_LIST ? lhi[3 * min(j, cs - 1) + a] : bhi[3 * id + a];
      }
      const bool pass = beam_meets(b, lo, hi, j < cs);
      const unsigned m = __ballot_sync(FULL, pass);
      const int pos = n + __popc(m & below);
      if (pass && pos < ck_max) out[pos] = id;
      n += __popc(m);
    }
    for (int p = min(n, ck_max) + lane; p < ck_max; p += 32) out[p] = Mc;
    if (lane == 0) {
      n_b[blk] = n;
      if (n > ck_max) *sat = true;
    }
  }
}

}  // namespace

// Scratch ints per super-tile the launch needs: 0 where the list fits in
// shared memory, else cs.
extern "C" long long spc_cull_scratch(int cs) {
  return list_fits(cs) ? 0 : cs;
}

// The culling of nS super-tiles into n_b, blk_ids and sat (see the top of
// this file); scratch holds nS * spc_cull_scratch(cs) ints.  The entry
// point has tested the shapes: 1 <= rt <= MAX_RT, Mc, cs, ck_max >= 0.
extern "C" int spc_cull(const void* blo, const void* bhi, const void* o,
                        const void* d, void* n_b, void* blk_ids, void* sat,
                        void* scratch, int nS, int rt, int Mc, int cs,
                        int ck_max, void* stream) {
  if (!list_fits(cs) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(sat, 0, 1, st);
  if (err != cudaSuccess || nS == 0) return (int)err;
  const bool fits = list_fits(cs);
  auto kernel = fits ? spc_cull_kernel<true> : spc_cull_kernel<false>;
  const size_t smem = fits ? list_bytes(cs) : 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nS, THREADS, smem, st>>>(
      (const float*)blo, (const float*)bhi, (const float*)o, (const float*)d,
      (long long*)n_b, (int*)blk_ids, (bool*)sat, (int*)scratch, rt, Mc, cs,
      ck_max);
  return (int)cudaGetLastError();
}
