// Probe kernels P1 and P2 for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas TPU probes scripts/probe_r5_mosaic3.py::kA..kH (P1,
// launched by call2d) and scripts/probe_r5_stages.py::dummy_kernel (P2).
// The TPU probes asked what Mosaic could compile for K3 (loops with a bound
// read at run time, DMAs of table rows into scratch, lane and row rolls)
// and what one grid step costs.  Here the same functions answer what each
// costs on the card: the row copies of K3's cell staging, single and
// double buffered, and the cost of one CTA.  Built by
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
// plain version bit for bit.  kB, kC, kE..kH and P2 keep one CTA per block
// b of the probe's grid (the TPU's grid step), 256 threads.  kA and kD are
// shaped for the card instead: kA runs one thread per float4 over a grid
// that fills the SMs, kD a CTA per (bag, 64 float4 columns) with every row
// of a short bag loaded before its first add.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
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

__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kB, kC: out[b] = sum over j < ck of table row ids[b, j] (rows of n
// floats, n % 4 == 0), summed in j order from 0.  Each row is copied into
// shared memory with cp.async (16 bytes a thread) and added from there:
// SLOTS == 2 (kB) copies row j + 1 into the other slot while row j is added;
// SLOTS == 1 (kC) waits for each copy.  A thread adds only the float4s it
// copied itself, so the copies need waits but no barrier.
template <int SLOTS>
__global__ void __launch_bounds__(THREADS)
row_sum_kernel(const int* __restrict__ ids, int ck,
               const float4* __restrict__ table, float4* __restrict__ out,
               int n4) {
  extern __shared__ float4 slot[];     // (SLOTS, n4)
  const int b = blockIdx.x;
  const int* row_ids = ids + (size_t)b * ck;
  float4 acc[MAXV];
#pragma unroll
  for (int v = 0; v < MAXV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);

  auto issue = [&](int j, int s) {
    const float4* src = table + (size_t)row_ids[j] * n4;
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int i = threadIdx.x + v * THREADS;
      if (i < n4) copy16(slot + s * n4 + i, src + i);
    }
    commit();
  };

  if (SLOTS == 2) issue(0, 0);
  for (int j = 0; j < ck; ++j) {
    const int s = SLOTS == 2 ? (j & 1) : 0;
    if (SLOTS == 2) {
      if (j + 1 < ck) {
        issue(j + 1, s ^ 1);
        wait_groups<1>();              // row j is in, row j + 1 in flight
      } else {
        wait_groups<0>();
      }
    } else {
      issue(j, 0);
      wait_groups<0>();
    }
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int i = threadIdx.x + v * THREADS;
      if (i < n4) {
        const float4 r = slot[s * n4 + i];
        acc[v].x += r.x; acc[v].y += r.y; acc[v].z += r.z; acc[v].w += r.w;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    const int i = threadIdx.x + v * THREADS;
    if (i < n4) out[(size_t)b * n4 + i] = acc[v];
  }
}

// kD: out[b] = sum over j < count of table row ids[b, j], count =
// nbs[b * nbs_stride] clamped to [0, ck], summed in j order from 0.  A CTA
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
  const int count = min(max(__ldg(nbs + (size_t)b * nbs_stride), 0), ck);
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
__global__ void __launch_bounds__(THREADS)
shift_kernel(const float* __restrict__ x, float* __restrict__ out, int R,
             int C, int op, int s) {
  extern __shared__ float tile[];      // (R, C)
  const int n = R * C;
  const size_t base = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += THREADS) tile[i] = x[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS) {
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

// P2: o = 2 x, one CTA per grid step of n4 float4s: per-CTA cost.
__global__ void __launch_bounds__(THREADS)
dummy_kernel(const float4* __restrict__ x, float4* __restrict__ o, int n4) {
  const size_t base = (size_t)blockIdx.x * n4;
  for (int i = threadIdx.x; i < n4; i += THREADS) {
    float4 v = x[base + i];
    v.x *= 2.f; v.y *= 2.f; v.z *= 2.f; v.w *= 2.f;
    o[base + i] = v;
  }
}

// Set once per process: kA's grid (every SM full of its CTAs) and the
// shared memory kB and kC may take (the card's opt-in limit, so no launch
// needs cudaFuncSetAttribute).  Queried on the current device.
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
             row_sum_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             optin)) != cudaSuccess ||
        (r.err = cudaFuncSetAttribute(
             row_sum_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
                             void* out, int nb, int n, int slots,
                             void* stream) {
  if (nb < 0 || (nb > 0 && (n < 4 || n % 4 != 0)) ||
      n / 4 > MAXV * THREADS || ck < 1 || (slots != 1 && slots != 2))
    return (int)cudaErrorInvalidValue;
  const Setup& s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  const int n4 = n / 4;
  const size_t smem = sizeof(float4) * (size_t)slots * n4;
  if (smem > s.row_sum_smem) return (int)cudaErrorInvalidValue;
  auto kernel = slots == 2 ? row_sum_kernel<2> : row_sum_kernel<1>;
  if (nb > 0)
    kernel<<<nb, THREADS, smem, (cudaStream_t)stream>>>(
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
    shift_kernel<<<nb, THREADS, sizeof(float) * R * C,
                   (cudaStream_t)stream>>>((const float*)x, (float*)out, R, C,
                                           op, s);
  return (int)cudaGetLastError();
}

extern "C" int probe_dummy(const void* x, void* out, int nsteps, int n,
                           void* stream) {
  if (nsteps < 0 || (nsteps > 0 && (n < 4 || n % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (nsteps > 0)
    dummy_kernel<<<nsteps, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (float4*)out, n / 4);
  return (int)cudaGetLastError();
}

