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
// -O3 -fmad=false) and called through ctypes from
// kaolin_tpu_torch/probes/_kernels.py, which holds the plain PyTorch
// versions.  Kernels launch on the caller's stream, never synchronise and
// never allocate; each entry point returns cudaGetLastError().
//
// One CTA per block b of the probe's grid (the TPU's grid step), 256
// threads.  Every function here moves a few bytes per operation, so each
// is bound by device memory (or, at the probes' small shapes, by launch
// and per-CTA cost); -fmad=false and sums in the probes' order make each
// kernel equal to its plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXV = 4;                // float4s per thread: rows <= 4096 floats

// kA: out[b] = x[b] added nb = nbs[b * nbs_stride] times, from 0, in a loop
// whose bound is read at run time.
__global__ void __launch_bounds__(THREADS)
dyn_loop_kernel(const int* __restrict__ nbs, int nbs_stride,
                const float* __restrict__ x, float* __restrict__ out, int n) {
  const size_t base = (size_t)blockIdx.x * n;
  const int nb = nbs[(size_t)blockIdx.x * nbs_stride];
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float xi = x[base + i];
    float acc = 0.f;
    for (int j = 0; j < nb; ++j) acc += xi;
    out[base + i] = acc;
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

// kB, kC, kD: out[b] = sum over j < count of table row ids[b, j] (rows of n
// floats, n % 4 == 0), summed in j order from 0.  Each row is copied into
// shared memory with cp.async (16 bytes a thread) and added from there:
// SLOTS == 2 (kB) copies row j + 1 into the other slot while row j is added;
// SLOTS == 1 (kC, kD) waits for each copy.  count is ck, or nbs[b *
// nbs_stride] when DYN (kD).  A thread adds only the float4s it copied
// itself, so the copies need waits but no barrier.
template <int SLOTS, bool DYN>
__global__ void __launch_bounds__(THREADS)
row_sum_kernel(const int* __restrict__ ids, int ck,
               const int* __restrict__ nbs, int nbs_stride,
               const float4* __restrict__ table, float4* __restrict__ out,
               int n4) {
  extern __shared__ float4 slot[];     // (SLOTS, n4)
  const int b = blockIdx.x;
  const int count = DYN ? nbs[(size_t)b * nbs_stride] : ck;
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

  if (SLOTS == 2 && count > 0) issue(0, 0);
  for (int j = 0; j < count; ++j) {
    const int s = SLOTS == 2 ? (j & 1) : 0;
    if (SLOTS == 2) {
      if (j + 1 < count) {
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

}  // namespace

extern "C" int probe_dyn_loop(const void* nbs, int nbs_stride, const void* x,
                              void* out, int nb, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (nb > 0)
    dyn_loop_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)nbs, nbs_stride, (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_row_sum(const void* ids, int ck, const void* nbs,
                             int nbs_stride, const void* table, void* out,
                             int nb, int n, int slots, int dyn,
                             void* stream) {
  if (n < 4 || n % 4 != 0 || n / 4 > MAXV * THREADS || ck < 1 ||
      (slots != 1 && slots != 2) || (dyn && slots != 1))
    return (int)cudaErrorInvalidValue;
  const int n4 = n / 4;
  const size_t smem = sizeof(float4) * (size_t)slots * n4;
  auto kernel = slots == 2 ? row_sum_kernel<2, false>
              : dyn ? row_sum_kernel<1, true> : row_sum_kernel<1, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    kernel<<<nb, THREADS, smem, (cudaStream_t)stream>>>(
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
  if (n < 4 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (nsteps > 0)
    dummy_kernel<<<nsteps, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (float4*)out, n / 4);
  return (int)cudaGetLastError();
}
