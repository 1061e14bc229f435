// The span marks of kaolin_tpu_torch/utils/profiler.py::span: for each
// span that marks the card, two empty kernels, kt_span_begin_<slug> and
// kt_span_end_<slug> (the span's name with '.' as '_'), launched <<<1, 1>>>
// on the current stream at the span's entry and exit.  They read and write
// nothing; in a profiler's trace every device op between a begin mark and
// its end mark, in stream order, belongs to the span, also in a CUDA
// graph's replay.  The Python entry points are in spans_module.cpp.
//
// KT_SPANS is the fixed list of slugs, in the order of profiler.SPANS (a
// mark's id is its index there); a CPU test holds the two in step.

#include <cuda_runtime.h>

#define KT_SPANS(X)                                                         \
  X(dibr_select)                                                            \
  X(dibr_render)                                                            \
  X(autograd_backward)                                                      \
  X(optim_step)                                                             \
  X(parallel_all_reduce)                                                    \
  X(spc_frame)                                                              \
  X(spc_cull)                                                               \
  X(spc_order)                                                              \
  X(spc_gather)                                                             \
  X(spc_trace)                                                              \
  X(dibr_sg)                                                                \
  X(dibr_sg_backward)

#define KT_MARK_KERNELS(slug)                                               \
  extern "C" __global__ void kt_span_begin_##slug() {}                      \
  extern "C" __global__ void kt_span_end_##slug() {}
KT_SPANS(KT_MARK_KERNELS)
#undef KT_MARK_KERNELS

namespace {

#define KT_MARK_ROW(slug)                                                   \
  {(const void*)kt_span_begin_##slug, (const void*)kt_span_end_##slug},
const void* const kMarks[][2] = {KT_SPANS(KT_MARK_ROW)};
#undef KT_MARK_ROW

constexpr int kCount = (int)(sizeof(kMarks) / sizeof(kMarks[0]));

}  // namespace

// Loads every mark kernel on the current device (a lazily loaded module
// is otherwise loaded at its first launch, which may fall in a capture);
// returns the cudaError.
extern "C" int spans_load() {
  cudaFuncAttributes attr;
  for (int k = 0; k < kCount; ++k)
    for (int end = 0; end < 2; ++end) {
      const cudaError_t rc = cudaFuncGetAttributes(&attr, kMarks[k][end]);
      if (rc != cudaSuccess) return (int)rc;
    }
  return 0;
}

// Launches span ``id``'s begin (end = 0) or end (end = 1) mark on
// ``stream``; returns the cudaError.
extern "C" int spans_mark(int id, int end, void* stream) {
  if (id < 0 || id >= kCount || end < 0 || end > 1)
    return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(kMarks[id][end], dim3(1), dim3(1), nullptr, 0,
                               (cudaStream_t)stream);
}
