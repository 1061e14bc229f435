// Probe kernels P1, P2 and P3 for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas TPU probes scripts/probe_r5_mosaic3.py::kA..kH (P1,
// launched by call2d) and scripts/probe_r5_stages.py::dummy_kernel (P2).
// The TPU probes asked what Mosaic could compile for K3 (loops with a bound
// read at run time, DMAs of table rows into scratch, lane and row rolls)
// and what one grid step costs.  Here the same functions answer what each
// costs on the card: the row copies of K3's cell staging, through shared
// memory by the copy engine (kB) or straight into registers (kC, kD), and
// an elementwise pipeline through shared memory (P2).  Built by
// kaolin_tpu_torch/_cuda.py (nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false) with probes_module.cpp, the Python entry points that
// kaolin_tpu_torch/probes/_kernels.py (which holds the plain PyTorch
// versions) calls.  Kernels launch on the caller's stream, never
// synchronise and never allocate; each C entry point returns
// cudaGetLastError().
//
// Every function here moves a few bytes per operation, so each is bound by
// device memory (or, at the probes' small shapes, by launch latency);
// -fmad=false and sums in the probes' order make each kernel equal to its
// plain version bit for bit.  kE..kH keep one CTA per block b of the
// probe's grid (the TPU's grid step), 256 threads.  The others are shaped
// for the card: kA runs one thread per float4 over a grid that fills the
// SMs; kB a CTA per bag whose rows the copy engine (TMA, csrc/tma.cuh)
// streams through a ring of shared-memory slots; kC and kD a CTA per (bag,
// 64 float4 columns) with rows loaded into registers in batches; P2 a CTA
// per 4 KB tile, a bulk load and a bulk store through shared memory.  P3
// (probe_r5_kbisect.py) instantiates spc_trace.cuh's K3 at stages 1-6.

#include <cuda_runtime.h>

#include <cstdint>

#include "spc_trace.cuh"
#include "tma.cuh"

namespace {

constexpr int CTA_THREADS = 256;
constexpr int MAXV = 4;                // float4s per thread: rows <= 4096 floats

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
}

// kA: out[b] = x[b] added nb = nbs[b * nbs_stride] times, from 0, in a loop
// whose bound is read at run time.  Rows of n4 float4s; one thread per
// float4 (a 16-byte load and store), KA_THREADS a CTA, a grid-stride loop
// over the flat (b, i) index on a grid that fills every SM.  A thread reads
// the count of b once, when its loop enters b.  The add chain is unrolled
// over the probes' counts (<= KA_UNROLL) with an exit at the count, and
// goes on in a loop past it; it stays repeated addition (x * nb rounds
// differently).
constexpr int KA_THREADS = 128;
constexpr int KA_UNROLL = 8;

__global__ void __launch_bounds__(KA_THREADS)
dyn_loop_kernel(const int* __restrict__ nbs, int nbs_stride,
                const float4* __restrict__ x, float4* __restrict__ out,
                unsigned n4, unsigned total4) {
  unsigned b_cur = ~0u;
  int count = 0;
  for (unsigned e = blockIdx.x * KA_THREADS + threadIdx.x; e < total4;
       e += gridDim.x * KA_THREADS) {
    const unsigned b = e / n4;
    if (b != b_cur) {
      b_cur = b;
      count = __ldg(nbs + (size_t)b * nbs_stride);
    }
    const float4 v = __ldg(x + e);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < KA_UNROLL; ++j) {
      if (j >= count) break;
      add4(acc, v);
    }
    for (int j = KA_UNROLL; j < count; ++j) add4(acc, v);
    out[e] = acc;
  }
}

// kB: out[b] = sum over j < ck of table row ids[b, j] (rows of n floats,
// n % 4 == 0), summed in j order from 0: the TPU's double-buffered
// make_async_copy of table rows as a ring of KB_SLOTS row slots in shared
// memory, filled by the copy engine.  A CTA takes one bag: warp 0 is the
// producer, the other warps the consumers, one float4 of a row a thread
// (rows of up to MAXV x CTA_THREADS float4s loop).  Each slot has a `full`
// barrier (one arrival plus the row's bytes) and an `empty` barrier (one
// arrival per consumer warp).  The producer's lane 0 takes the bag's row
// ids from the warp's registers (32 loaded at once), waits until slot j %
// KB_SLOTS is empty, arms its full barrier with the row's bytes and issues
// one bulk copy of the row; the consumers wait on full[j % KB_SLOTS] with
// the parity of the slot's use, add the row and release the slot.  At K3's
// staging shape (rows of 3 KB) nine CTAs fit an SM, 216 KB of rows in
// flight.  The row reads are what bound it: a bag of CK rows reads CK rows
// from L2 or device memory, a table row once per bag that names it.
constexpr int KB_SLOTS = 8;
constexpr int KB_BARRIERS = 128;        // bytes before the slots: 2 x 8 barriers

__global__ void __launch_bounds__(32 + CTA_THREADS)
row_ring_kernel(const int* __restrict__ ids, int ck,
                const float4* __restrict__ table, float4* __restrict__ out,
                int n4) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring);
  uint64_t* empty = full + KB_SLOTS;
  float4* slot = reinterpret_cast<float4*>(ring + KB_BARRIERS);
  const int consumers = blockDim.x - 32;           // a multiple of 32
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const uint32_t bytes = (uint32_t)n4 * sizeof(float4);
  if (threadIdx.x == 0) {
    for (int s = 0; s < KB_SLOTS; ++s) {
      tma::barrier_init(&full[s], 1);
      tma::barrier_init(&empty[s], consumers / 32);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {                          // the producer warp
    const int* row_ids = ids + (size_t)b * ck;
    for (int j0 = 0; j0 < ck; j0 += 32) {
      const int mine = j0 + lane < ck ? __ldg(row_ids + j0 + lane) : 0;
      const int cnt = min(32, ck - j0);
      for (int u = 0; u < cnt; ++u) {
        const int id = __shfl_sync(0xffffffffu, mine, u);
        if (lane == 0) {
          const int j = j0 + u, s = j % KB_SLOTS;
          if (j >= KB_SLOTS) tma::wait(&empty[s], (j / KB_SLOTS - 1) & 1);
          tma::arrive_expect_tx(&full[s], bytes);
          tma::load(slot + (size_t)s * n4, table + (size_t)id * n4, bytes,
                    &full[s]);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x - 32;
  float4 acc[MAXV];
#pragma unroll
  for (int v = 0; v < MAXV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < ck; ++j) {
    const int s = j % KB_SLOTS;
    tma::wait(&full[s], (j / KB_SLOTS) & 1);
    const float4* row = slot + (size_t)s * n4;
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int i = t + v * consumers;
      if (i < n4) add4(acc[v], row[i]);
    }
    __syncwarp();
    if (lane == 0) tma::arrive(&empty[s]);
  }
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    const int i = t + v * consumers;
    if (i < n4) out[(size_t)b * n4 + i] = acc[v];
  }
}

// kD: out[b] = sum over j < count of table row ids[b, j], count =
// nbs[b * nbs_stride] clamped to [0, ck] (kC: nbs null, count = ck), summed
// in j order from 0.  A CTA
// takes one bag b and KD_COLS float4 columns of its rows (grid (nb,
// ceil(n4 / KD_COLS))), one column a thread, so the script's 64 bags of 256
// float4s make 256 CTAs and K3's staging shape (4,452 bags of 192) 13,356.
// Rows go straight into registers, KD_BATCH at a time, and the next batch
// is loaded before the current one is added: a bag of <= KD_BATCH rows has
// every row in flight before its first add, a longer one keeps up to 2 x
// KD_BATCH loads in flight.  No shared memory, so no attribute to set.
constexpr int KD_COLS = 64;
constexpr int KD_BATCH = 8;

__device__ __forceinline__ void load_rows(float4 (&r)[KD_BATCH],
                                          const float4* __restrict__ col,
                                          const int* __restrict__ row_ids,
                                          int j0, int count, int n4) {
  int id[KD_BATCH];
#pragma unroll
  for (int u = 0; u < KD_BATCH; ++u)
    id[u] = j0 + u < count ? __ldg(row_ids + j0 + u) : 0;
#pragma unroll
  for (int u = 0; u < KD_BATCH; ++u)
    if (j0 + u < count) r[u] = __ldg(col + (size_t)id[u] * n4);
}

__global__ void __launch_bounds__(KD_COLS)
bag_sum_kernel(const int* __restrict__ ids, int ck,
               const int* __restrict__ nbs, int nbs_stride,
               const float4* __restrict__ table, float4* __restrict__ out,
               int n4) {
  const int b = blockIdx.x;
  const int i = blockIdx.y * KD_COLS + threadIdx.x;
  if (i >= n4) return;
  const int count =
      nbs ? min(max(__ldg(nbs + (size_t)b * nbs_stride), 0), ck) : ck;
  const int* row_ids = ids + (size_t)b * ck;
  const float4* col = table + i;
  float4 cur[KD_BATCH], nxt[KD_BATCH];
#pragma unroll
  for (int u = 0; u < KD_BATCH; ++u)
    cur[u] = nxt[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  load_rows(cur, col, row_ids, 0, count, n4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < count; j0 += KD_BATCH) {
    if (j0 + KD_BATCH < count)
      load_rows(nxt, col, row_ids, j0 + KD_BATCH, count, n4);
#pragma unroll
    for (int u = 0; u < KD_BATCH; ++u)
      if (j0 + u < count) add4(acc, cur[u]);
#pragma unroll
    for (int u = 0; u < KD_BATCH; ++u) cur[u] = nxt[u];
  }
  out[(size_t)b * n4 + i] = acc;
}

// kE..kH: out[b] = x[b] + a shifted copy of x[b], an (R, C) tile staged in
// shared memory.  op 0: roll by s along lanes, out[r, c] = x[r, c] +
// x[r, (c - s) mod C] (kE, kF); op 1: shift left by s along lanes, zero
// fill, x[r, c] + (x[r, c + s] if c + s < C else 0) (kG); op 2: roll by s
// along rows, x[r, c] + x[(r - s) mod R, c] (kH).
__global__ void __launch_bounds__(CTA_THREADS)
shift_kernel(const float* __restrict__ x, float* __restrict__ out, int R,
             int C, int op, int s) {
  extern __shared__ float tile[];      // (R, C)
  const int n = R * C;
  const size_t base = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += CTA_THREADS) tile[i] = x[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += CTA_THREADS) {
    const int r = i / C, c = i % C;
    float y;
    if (op == 0) {
      y = tile[r * C + ((c - s) % C + C) % C];
    } else if (op == 1) {
      y = c + s < C ? tile[i + s] : 0.f;
    } else {
      y = tile[(((r - s) % R + R) % R) * C + c];
    }
    out[base + i] = tile[i] + y;
  }
}

// P2: o = 2 x over total4 float4s, the TPU's per-step pipeline (a DMA of
// the step in, the multiply, a DMA out) on the copy engine.  One CTA per
// tile of P2_TILE4 float4s (4 KB: one (8, 128) step of the probe; the last
// tile may be part of one): thread 0 arms the tile's barrier with its bytes
// and issues one bulk load into shared memory; the 256 threads wait on the
// barrier, double their float4 in place, fence the writes for the copy
// engine and meet at __syncthreads(); thread 0 writes the tile back with
// one bulk store and waits until it is done.  The CTAs an
// SM holds (eight) are the pipeline's stages, and the block scheduler
// starts them in tile order, so the tiles in flight lie side by side in
// device memory.  Persistent CTAs that walk the tiles through a ring of 2-4
// slots, bulk loads with register stores, and 16-byte streaming loads and
// stores on the persistent grid were each 4-6 % slower on the H100 (PERF.md
// §6).  Bound by device memory: each float4 read once, written once.
constexpr int P2_TILE4 = CTA_THREADS;

__global__ void __launch_bounds__(CTA_THREADS)
dummy_kernel(const float4* __restrict__ x, float4* __restrict__ o,
             unsigned total4) {
  __shared__ __align__(128) float4 tile[P2_TILE4];
  __shared__ __align__(8) uint64_t full;
  const size_t base = (size_t)blockIdx.x * P2_TILE4;
  const unsigned n = min((unsigned)P2_TILE4, total4 - (unsigned)base);
  const uint32_t bytes = n * (uint32_t)sizeof(float4);
  if (threadIdx.x == 0) {
    tma::barrier_init(&full, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma::arrive_expect_tx(&full, bytes);
    tma::load(tile, x + base, bytes, &full);
  }
  tma::wait(&full, 0);
  if (threadIdx.x < n) {
    float4 v = tile[threadIdx.x];
    v.x *= 2.f; v.y *= 2.f; v.z *= 2.f; v.w *= 2.f;
    tile[threadIdx.x] = v;
  }
  tma::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma::store(o + base, tile, bytes);
    tma::commit();
    tma::wait_store<0>();
  }
}

// Set once per process: kA's grid (every SM full of its CTAs) and the
// shared memory kB may take (the card's opt-in limit, so no launch needs
// cudaFuncSetAttribute).  Queried on the current device.
struct Setup {
  cudaError_t err = cudaSuccess;
  unsigned ka_grid = 0;
  size_t row_sum_smem = 0;
};

const Setup& setup() {
  static const Setup s = [] {
    Setup r;
    int dev = 0, sms = 0, per_sm = 0, optin = 0;
    if ((r.err = cudaGetDevice(&dev)) != cudaSuccess ||
        (r.err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, dyn_loop_kernel, KA_THREADS, 0)) != cudaSuccess ||
        (r.err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (r.err = cudaFuncSetAttribute(
             row_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             optin)) != cudaSuccess)
      return r;
    r.ka_grid = (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
    r.row_sum_smem = (size_t)optin;
    return r;
  }();
  return s;
}

}  // namespace

extern "C" int probe_dyn_loop(const void* nbs, int nbs_stride, const void* x,
                              void* out, int nb, int n, void* stream) {
  if (nb < 0 || (nb > 0 && (n < 4 || n % 4 != 0)) ||
      (unsigned long long)nb * (n / 4) >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  const Setup& s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  const unsigned n4 = n / 4, total4 = (unsigned)nb * n4;
  const unsigned blocks = (total4 + KA_THREADS - 1) / KA_THREADS;
  if (total4 > 0)
    dyn_loop_kernel<<<blocks < s.ka_grid ? blocks : s.ka_grid, KA_THREADS,
                      0, (cudaStream_t)stream>>>(
        (const int*)nbs, nbs_stride, (const float4*)x, (float4*)out, n4,
        total4);
  return (int)cudaGetLastError();
}

extern "C" int probe_row_sum(const void* ids, int ck, const void* table,
                             void* out, int nb, int n, void* stream) {
  if (nb < 0 || (nb > 0 && (n < 4 || n % 4 != 0)) ||
      n / 4 > MAXV * CTA_THREADS || ck < 1)
    return (int)cudaErrorInvalidValue;
  const Setup& s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  const int n4 = n / 4;
  const int warps = (n4 + 31) / 32;
  const int consumers = warps * 32 < CTA_THREADS ? warps * 32 : CTA_THREADS;
  const size_t smem = KB_BARRIERS + sizeof(float4) * (size_t)KB_SLOTS * n4;
  if (smem > s.row_sum_smem) return (int)cudaErrorInvalidValue;
  if (nb > 0)
    row_ring_kernel<<<nb, 32 + consumers, smem, (cudaStream_t)stream>>>(
        (const int*)ids, ck, (const float4*)table, (float4*)out, n4);
  return (int)cudaGetLastError();
}

extern "C" int probe_bag_sum(const void* ids, int ck, const void* nbs,
                             int nbs_stride, const void* table, void* out,
                             int nb, int n, void* stream) {
  const int n4 = n / 4;
  if (nb < 0 || (nb > 0 && (n < 4 || n % 4 != 0)) || ck < 1 ||
      (n4 + KD_COLS - 1) / KD_COLS > 65535)
    return (int)cudaErrorInvalidValue;
  if (nb > 0)
    bag_sum_kernel<<<dim3(nb, (n4 + KD_COLS - 1) / KD_COLS), KD_COLS, 0,
                     (cudaStream_t)stream>>>(
        (const int*)ids, ck, (const int*)nbs, nbs_stride,
        (const float4*)table, (float4*)out, n4);
  return (int)cudaGetLastError();
}

extern "C" int probe_shift(const void* x, void* out, int nb, int R, int C,
                           int op, int s, void* stream) {
  if (R < 1 || C < 1 || op < 0 || op > 2 || s < 0 ||
      (size_t)R * C * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (nb > 0)
    shift_kernel<<<nb, CTA_THREADS, sizeof(float) * R * C,
                   (cudaStream_t)stream>>>((const float*)x, (float*)out, R, C,
                                           op, s);
  return (int)cudaGetLastError();
}

extern "C" int probe_dummy(const void* x, void* out, int nsteps, int n,
                           void* stream) {
  if (nsteps < 0 || (nsteps > 0 && (n < 4 || n % 4 != 0)) ||
      (unsigned long long)nsteps * (n / 4) >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned total4 = (unsigned)nsteps * (n / 4);
  if (total4 > 0)
    dummy_kernel<<<(total4 + P2_TILE4 - 1) / P2_TILE4, CTA_THREADS, 0,
                   (cudaStream_t)stream>>>((const float4*)x, (float4*)out,
                                           total4);
  return (int)cudaGetLastError();
}

// P3: K3 cut at `stage` 1-6 (spc_trace.cuh); the arguments as spc_trace's.
extern "C" int probe_trace_stage(const void* rays, const void* cell_rows,
                                 const void* block_cells, const void* nb,
                                 const void* block_ids, void* tn_out,
                                 void* tf_out, void* pi_out, void* cnt_out,
                                 int nA, int rt, int cw, int ckmax, int kbuf,
                                 float side, int with_exit, int pidx_offset,
                                 int stage, void* stream) {
  constexpr decltype(&launch<6>) kStages[] = {launch<1>, launch<2>, launch<3>,
                                              launch<4>, launch<5>, launch<6>};
  if (stage < 1 || stage > 6) return (int)cudaErrorInvalidValue;
  return kStages[stage - 1](rays, cell_rows, block_cells, nb, block_ids,
                            tn_out, tf_out, pi_out, cnt_out, nA, rt, cw, ckmax,
                            kbuf, side, with_exit, pidx_offset, stream);
}
