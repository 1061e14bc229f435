// Designs of the probe kernel P2 (o = 2 x over 4 KB steps of float32) that
// kaolin_tpu_torch/probes/p2_designs.py times against the package's kernel
// (csrc/probes.cu::dummy_kernel: a CTA per step, a bulk load and a bulk
// store through shared memory) and torch.mul.  Not part of the package's
// build: the probe compiles this file on its own with the package's nvcc
// flags.  Each design equals 2 x bit for bit.
//
//  0  a CTA per step, 16-byte loads and stores (the port's first P2)
//  1  a CTA per step, 16-byte streaming loads and stores (__ldcs, __stcs)
//  2  persistent CTAs (the occupancy query's grid), 16-byte loads, a
//     grid-stride loop
//  3  persistent, streaming hints, one float4 in flight a thread
//  4  persistent, streaming hints, four float4s in flight a thread
//  5-7  persistent, a ring of S = 2, 3, 4 tiles of 4 KB: bulk load, double
//     in place, bulk store; a slot is reloaded once its store has read it
//  8  persistent, a ring of 2 tiles of 16 KB
//  9  persistent, a ring of 4 tiles of 4 KB filled by bulk loads, 16-byte
//     stores from registers
// 10-12  2, 4, 8 consecutive 4 KB tiles a CTA through a ring of 2, 2, 4

#include <cuda_runtime.h>

#include <cstdint>

#include "../csrc/tma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE4 = THREADS;          // one step: 4 KB

__device__ __forceinline__ float4 twice(float4 v) {
  v.x *= 2.f; v.y *= 2.f; v.z *= 2.f; v.w *= 2.f;
  return v;
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS)
step_kernel(const float4* __restrict__ x, float4* __restrict__ o,
            unsigned total4) {
  const unsigned e = blockIdx.x * TILE4 + threadIdx.x;
  if (e >= total4) return;
  if (STREAM) __stcs(o + e, twice(__ldcs(x + e)));
  else o[e] = twice(x[e]);
}

template <bool STREAM, int U>
__global__ void __launch_bounds__(THREADS)
persistent_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                  unsigned total4) {
  const unsigned stride = gridDim.x * THREADS;
  unsigned e = blockIdx.x * THREADS + threadIdx.x;
  for (; e + (U - 1) * stride < total4; e += U * stride) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = STREAM ? __ldcs(x + e + u * stride)
                                              : x[e + u * stride];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (STREAM) __stcs(o + e + u * stride, twice(v[u]));
      else o[e + u * stride] = twice(v[u]);
    }
  }
  for (; e < total4; e += stride) {
    if (STREAM) __stcs(o + e, twice(__ldcs(x + e)));
    else o[e] = twice(x[e]);
  }
}

// Tiles of F x 4 KB through a ring of S slots.  CH == 0: persistent CTAs,
// tile k of CTA b is b + k * gridDim.x; CH > 0: CTA b takes the CH tiles
// b * CH .. b * CH + CH - 1.  STORE_BULK: the tile goes back by a bulk
// store and its slot is reloaded once that store has read it; else by
// 16-byte stores from registers, the slot reloaded after the CTA's barrier.
template <int S, int F, int CH, bool STORE_BULK>
__global__ void __launch_bounds__(THREADS)
ring_kernel(const float4* __restrict__ x, float4* __restrict__ o,
            unsigned total4) {
  constexpr int T4 = THREADS * F;
  __shared__ __align__(128) float4 slot[S][T4];
  __shared__ __align__(8) uint64_t full[S];
  const unsigned tiles = (total4 + T4 - 1) / T4;
  const unsigned first = CH ? blockIdx.x * CH : blockIdx.x;
  const unsigned step = CH ? 1 : gridDim.x;
  if (first >= tiles) return;
  const unsigned count =
      CH ? min((unsigned)CH, tiles - first)
         : (tiles - first + step - 1) / step;
  auto tile = [&](unsigned k) { return first + k * step; };
  auto len = [&](unsigned t) { return min((unsigned)T4, total4 - t * T4); };
  auto fill = [&](int s, unsigned k) {
    const unsigned t = tile(k);
    tma::arrive_expect_tx(&full[s], len(t) * 16);
    tma::load(slot[s], x + (size_t)t * T4, len(t) * 16, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) tma::barrier_init(&full[s], 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < S && s < (int)count; ++s) fill(s, s);
  for (unsigned k = 0; k < count; ++k) {
    const unsigned t = tile(k), n = len(t);
    const int s = k % S;
    tma::wait(&full[s], (k / S) & 1);
    float4 v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const unsigned i = threadIdx.x + f * THREADS;
      if (i < n) v[f] = twice(slot[s][i]);
      if (STORE_BULK && i < n) slot[s][i] = v[f];
    }
    tma::fence_proxy_async();
    __syncthreads();
    if (STORE_BULK) {
      if (threadIdx.x == 0) {
        tma::store(o + (size_t)t * T4, slot[s], n * 16);
        tma::commit();
        if (k >= 1 && k - 1 + S < count) {
          tma::wait_store_read<1>();     // tile k - 1's store read its slot
          fill((k - 1) % S, k - 1 + S);
        }
      }
    } else {
      if (threadIdx.x == 0 && k + S < count) fill(s, k + S);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const unsigned i = threadIdx.x + f * THREADS;
        if (i < n) o[(size_t)t * T4 + i] = v[f];
      }
    }
  }
  if (STORE_BULK && threadIdx.x == 0) tma::wait_store<0>();
}

using Kernel = void (*)(const float4*, float4*, unsigned);

struct Design {
  Kernel kernel;
  int tiles_per_cta;                   // 0: persistent
  int tile4;                           // float4s a tile
};

const Design kDesigns[] = {
    {step_kernel<false>, 1, TILE4},
    {step_kernel<true>, 1, TILE4},
    {persistent_kernel<false, 1>, 0, TILE4},
    {persistent_kernel<true, 1>, 0, TILE4},
    {persistent_kernel<true, 4>, 0, TILE4},
    {ring_kernel<2, 1, 0, true>, 0, TILE4},
    {ring_kernel<3, 1, 0, true>, 0, TILE4},
    {ring_kernel<4, 1, 0, true>, 0, TILE4},
    {ring_kernel<2, 4, 0, true>, 0, 4 * TILE4},
    {ring_kernel<4, 1, 0, false>, 0, TILE4},
    {ring_kernel<2, 1, 2, true>, 2, TILE4},
    {ring_kernel<2, 1, 4, true>, 4, TILE4},
    {ring_kernel<4, 1, 8, true>, 8, TILE4},
};
constexpr int kCount = sizeof(kDesigns) / sizeof(kDesigns[0]);

}  // namespace

extern "C" int p2_design_count() { return kCount; }

// The grid design ``which`` launches for ``total4`` float4s (0 on error).
extern "C" unsigned p2_design_grid(int which, unsigned total4) {
  if (which < 0 || which >= kCount) return 0;
  const Design& d = kDesigns[which];
  const unsigned tiles = (total4 + d.tile4 - 1) / d.tile4;
  if (d.tiles_per_cta > 0)
    return (tiles + d.tiles_per_cta - 1) / d.tiles_per_cta;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, d.kernel,
                                                    THREADS, 0) !=
          cudaSuccess)
    return 0;
  const unsigned grid = (unsigned)(sms * per_sm);
  return tiles < grid ? tiles : grid;
}

extern "C" int p2_design(int which, const void* x, void* o, unsigned total4,
                         unsigned grid, void* stream) {
  if (which < 0 || which >= kCount || grid == 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kDesigns[which].kernel;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float4*)x,
                                                     (float4*)o, total4);
  return (int)cudaGetLastError();
}
