// Python entry points of E1-E3: the extension module ``epilogue``, built
// with epilogue.cu by kaolin_tpu_torch/_cuda.py::load_module and called by
// kaolin_tpu_torch/render/mesh/_sample.py and kaolin_tpu_torch/ops/
// _scatter.py.
//
// Each entry point tests its inputs, allocates the outputs and the
// scratch with PyTorch's allocator, and launches on the stream it
// is given, all in C++.  The backwards order their ids with PyTorch's
// stable sort (at::sort(stable=true), a radix sort on the card: the one
// library step of E2 and E3, on the current stream, which is the stream
// given); the sums are epilogue.cu's.  On the stream that torch.cuda.graph
// captures, the allocations come from the graph's pool and the launches
// are recorded.
//
// Each returns the outputs.  An input the kernels do not take raises
// ValueError naming it (ext.h); a refused launch raises RuntimeError with
// the cudaError, and PyTorch's errors pass through as PyTorch raises them.

#include "ext.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/sort.h>
#include <ATen/ops/zeros.h>

extern "C" {
long long epilogue_scratch(int M, int D);
int epilogue_bilinear_forward(const void* tex, const void* x, const void* y,
                              void* out, int Q, int P, int H, int W, int C,
                              void* stream);
int epilogue_bilinear_pixels(const void* tex, const void* x, const void* y,
                             const void* g, void* dx, void* dy, void* keys,
                             int Q, int P, int H, int W, int C, void* stream);
int epilogue_segment_sum(const void* sk, const void* perm, int M, int D,
                         int N, int taps_q, const void* g, const void* x,
                         const void* y, void* out, void* part, void* stream);
}

namespace {

// args[k..k+2] as the texture's (H, W) and the pixels per view P and
// args[k+3] as the stream, or false.
bool sample_args(PyObject* const* args, int k, int* H, int* W, int* P,
                 void** stream) {
  return ext::int_arg(args, k, H) && ext::int_arg(args, k + 1, W) &&
         ext::int_arg(args, k + 2, P) && ext::stream_arg(args, k + 3, stream);
}

// tex (B * H * W, C), x and y (Q,) with Q = B * P, all float32 on x's
// device; sets Q, C, or false with ValueError set.
bool sample_inputs(const at::Tensor& tex, const at::Tensor& x,
                   const at::Tensor& y, int H, int W, int P, int64_t* Q,
                   int64_t* C) {
  if (!ext::ranked(tex, "tex_rows", 2) || !ext::ranked(x, "x", 1))
    return false;
  *Q = x.size(0);
  *C = tex.size(1);
  if (H < 1 || W < 1 || P < 1 || *Q % P != 0 || *C < 1)
    return ext::fail("bilinear sample: texture %d x %d, P = %d pixels a view "
                     "and C = %lld channels must be at least 1, and x's %lld "
                     "pixels a multiple of P", H, W, P, (long long)*C,
                     (long long)*Q);
  const auto dev = x.get_device();
  return ext::shaped(tex, "tex_rows", at::kFloat, dev, {*Q / P * H * W, *C}) &&
         ext::shaped(x, "x", at::kFloat, dev, {*Q}) &&
         ext::shaped(y, "y", at::kFloat, dev, {*Q}) &&
         ((4 * *Q < INT_MAX && *Q * *C < INT_MAX) ||
          ext::fail("bilinear sample: 4 * %lld taps and %lld samples, but "
                    "the kernels index with ints: fewer than 2^31",
                    (long long)*Q, (long long)(*Q * *C)));
}

// The segment sums into out (N, D) (zero) of M entries with keys ``keys``.
bool segment_sum(const at::Tensor& keys, int64_t D, int64_t N, int taps_q,
                 const at::Tensor& g, const at::Tensor* x,
                 const at::Tensor* y, at::Tensor& out, void* stream) {
  const int M = (int)keys.numel();
  auto sorted = at::sort(keys, /*stable=*/true, 0, false);
  const at::Tensor& sk = std::get<0>(sorted);
  const at::Tensor& perm = std::get<1>(sorted);
  at::Tensor part =
      at::empty({(int64_t)epilogue_scratch(M, (int)D)}, g.options());
  return ext::launch_ok(
      epilogue_segment_sum(sk.data_ptr(), perm.data_ptr(), M, (int)D, (int)N,
                           taps_q, g.data_ptr(), x ? x->data_ptr() : nullptr,
                           y ? y->data_ptr() : nullptr, out.data_ptr(),
                           part.data_ptr(), stream),
      "segment_pieces_kernel");
}

// sample(tex, x, y, H, W, P, stream) -> (Q, C) float32 (E1)
PyObject* py_sample(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int H, W, P;
  void* stream;
  if (!ext::args_ok(nargs, 7, "sample") ||
      !sample_args(args, 3, &H, &W, &P, &stream))
    return nullptr;
  const at::Tensor* tex = ext::tensor(args, 0);
  const at::Tensor* x = ext::tensor(args, 1);
  const at::Tensor* y = ext::tensor(args, 2);
  if (!tex || !x || !y) return nullptr;
  int64_t Q, C;
  if (!sample_inputs(*tex, *x, *y, H, W, P, &Q, &C)) return nullptr;
  at::Tensor out = at::empty({Q, C}, x->options());
  if (!ext::launch_ok(
          epilogue_bilinear_forward(tex->data_ptr(), x->data_ptr(),
                                    y->data_ptr(), out.data_ptr(), (int)Q, P,
                                    H, W, (int)C, stream),
          "bilinear_forward_kernel"))
    return nullptr;
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

// sample_backward(tex, x, y, g, H, W, P, stream)
//   -> (dT (B * H * W, C), dx (Q,), dy (Q,)) float32 (E2)
PyObject* py_sample_backward(PyObject*, PyObject* const* args,
                             Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int H, W, P;
  void* stream;
  if (!ext::args_ok(nargs, 8, "sample_backward") ||
      !sample_args(args, 4, &H, &W, &P, &stream))
    return nullptr;
  const at::Tensor* tex = ext::tensor(args, 0);
  const at::Tensor* x = ext::tensor(args, 1);
  const at::Tensor* y = ext::tensor(args, 2);
  const at::Tensor* g = ext::tensor(args, 3);
  if (!tex || !x || !y || !g) return nullptr;
  int64_t Q, C;
  if (!sample_inputs(*tex, *x, *y, H, W, P, &Q, &C) ||
      !ext::shaped(*g, "g", at::kFloat, x->get_device(), {Q, C}))
    return nullptr;
  at::Tensor dx = at::empty({Q}, x->options());
  at::Tensor dy = at::empty({Q}, x->options());
  at::Tensor keys = at::empty({4 * Q}, x->options().dtype(at::kInt));
  at::Tensor dt = at::zeros({tex->size(0), C}, x->options());
  if (!ext::launch_ok(
          epilogue_bilinear_pixels(tex->data_ptr(), x->data_ptr(),
                                   y->data_ptr(), g->data_ptr(),
                                   dx.data_ptr(), dy.data_ptr(),
                                   keys.data_ptr(), (int)Q, P, H, W, (int)C,
                                   stream),
          "bilinear_pixels_kernel") ||
      !segment_sum(keys, C, tex->size(0), (int)Q, *g, x, y, dt, stream))
    return nullptr;
  PyObject* a = THPVariable_Wrap(std::move(dt));
  PyObject* b = a ? THPVariable_Wrap(std::move(dx)) : nullptr;
  PyObject* c = b ? THPVariable_Wrap(std::move(dy)) : nullptr;
  PyObject* out = c ? PyTuple_Pack(3, a, b, c) : nullptr;
  Py_XDECREF(a);
  Py_XDECREF(b);
  Py_XDECREF(c);
  return out;
  END_HANDLE_TH_ERRORS
}

// scatter_rows(g, idx, N, stream) -> (N, D) float32 (E3):
// g (P, D) float32, idx (P,) int32 on g's device
PyObject* py_scatter_rows(PyObject*, PyObject* const* args,
                          Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int N;
  void* stream;
  if (!ext::args_ok(nargs, 4, "scatter_rows") ||
      !ext::int_arg(args, 2, &N) || !ext::stream_arg(args, 3, &stream))
    return nullptr;
  const at::Tensor* g = ext::tensor(args, 0);
  const at::Tensor* idx = ext::tensor(args, 1);
  if (!g || !idx || !ext::ranked(*g, "g", 2)) return nullptr;
  const int64_t P = g->size(0), D = g->size(1);
  if (N < 0 || D < 1)
    return PyErr_Format(PyExc_ValueError, "scatter_rows: N = %d rows must be "
                        "at least 0 and D = %lld columns at least 1", N,
                        (long long)D);
  const auto dev = g->get_device();
  if (!ext::shaped(*g, "g", at::kFloat, dev, {P, D}) ||
      !ext::shaped(*idx, "idx", at::kInt, dev, {P}))
    return nullptr;
  if ((int64_t)N * D >= INT_MAX)
    return PyErr_Format(PyExc_ValueError, "scatter_rows: %d rows of %lld "
                        "columns, but the kernels index with ints: fewer "
                        "than 2^31 elements", N, (long long)D);
  at::Tensor out = at::zeros({N, D}, g->options());
  if (!segment_sum(*idx, D, N, 0, *g, nullptr, nullptr, out, stream))
    return nullptr;
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"sample", (PyCFunction)(void (*)(void))py_sample, METH_FASTCALL,
     "sample(tex, x, y, H, W, P, stream) -> out (E1)"},
    {"sample_backward", (PyCFunction)(void (*)(void))py_sample_backward,
     METH_FASTCALL,
     "sample_backward(tex, x, y, g, H, W, P, stream) -> (dT, dx, dy) (E2)"},
    {"scatter_rows", (PyCFunction)(void (*)(void))py_scatter_rows,
     METH_FASTCALL, "scatter_rows(g, idx, N, stream) -> out (E3)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "epilogue",
                       "Launches of the DIB-R epilogue kernels E1-E3.", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_epilogue(void) { return PyModule_Create(&kModule); }
