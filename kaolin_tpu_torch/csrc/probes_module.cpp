// Python entry points of the probe kernels P1 and P2: the extension module
// ``probes``, built with probes.cu by kaolin_tpu_torch/_cuda.py::load_module
// and called by kaolin_tpu_torch/probes/_kernels.py.
//
// At the probes' shapes a kernel runs ~2 us on the device, less than the
// host spends to launch it from Python.  So each entry point takes the
// wrapper's tensors and the stream, makes the wrapper's input test,
// allocates the output with PyTorch's allocator and launches, all in C++:
// the host work of one PyTorch op, where ctypes, a test in Python and
// torch.empty_like cost more (PERF.md §6).  Only PyTorch's tensor and
// Python-binding headers are included, so the build takes seconds.
//
// Each returns the output, or None for inputs that fail the test (the
// wrapper then raises the precise error); a refused launch raises
// RuntimeError with the cudaError, and PyTorch's errors (an allocation
// that fails) pass through as PyTorch raises them.

#include "ext.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>

extern "C" {
int probe_dyn_loop(const void* nbs, int nbs_stride, const void* x, void* out,
                   int nb, int n, void* stream);
int probe_row_sum(const void* ids, int ck, const void* table, void* out,
                  int nb, int n, void* stream);
int probe_bag_sum(const void* ids, int ck, const void* nbs, int nbs_stride,
                  const void* table, void* out, int nb, int n, void* stream);
int probe_shift(const void* x, void* out, int nb, int R, int C, int op, int s,
                void* stream);
int probe_dummy(const void* x, void* out, int nsteps, int n, void* stream);
}

namespace {

// The wrappers' test of one input: a contiguous, 16-byte aligned ``dtype``
// tensor of ``ndim`` dims (any for -1, at least 1) on CUDA device ``dev``,
// with fewer than 2^31 elements (the kernels index with ints).
bool ok(const at::Tensor& t, at::ScalarType dtype, int64_t ndim,
        c10::DeviceIndex dev) {
  return t.scalar_type() == dtype && t.is_cuda() && t.get_device() == dev &&
         (ndim < 0 ? t.dim() >= 1 : t.dim() == ndim) && t.is_contiguous() &&
         t.numel() < INT_MAX &&
         (reinterpret_cast<uintptr_t>(t.data_ptr()) & 15) == 0;
}

// Floats in one row t[b] (0 for no rows).
int row(const at::Tensor& t) {
  const int64_t nb = t.size(0);
  return nb ? (int)(t.numel() / nb) : 0;
}

PyObject* launched(int rc, const char* entry, at::Tensor&& out) {
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "probe kernel %s failed to launch: cudaError %d", entry, rc);
    return nullptr;
  }
  return THPVariable_Wrap(std::move(out));
}

// dyn_loop(nbs, x, stream): kA, out[b] = x[b] added nbs[b, 0] times.
PyObject* py_dyn_loop(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  void* stream;
  if (!ext::args_ok(nargs, 3, "dyn_loop") ||
      !ext::stream_arg(args, 2, &stream))
    return nullptr;
  const at::Tensor* nbs = ext::tensor(args, 0);
  const at::Tensor* x = ext::tensor(args, 1);
  if (!nbs || !x) return nullptr;
  const auto dev = x->get_device();
  if (!ok(*x, at::kFloat, -1, dev) || !ok(*nbs, at::kInt, 2, dev) ||
      nbs->size(0) != x->size(0) || nbs->size(1) < 1 || row(*x) % 4)
    Py_RETURN_NONE;
  at::Tensor out = at::empty_like(*x);
  return launched(probe_dyn_loop(nbs->data_ptr(), (int)nbs->size(1),
                                 x->data_ptr(), out.data_ptr(),
                                 (int)x->size(0), row(*x), stream),
                  "dyn_loop", std::move(out));
  END_HANDLE_TH_ERRORS
}

// The row sums' shared test: ids (nb, 1, CK) int32, table rows shaped like
// x[b] float32, x (only its shape is read) on the same device.
bool rows_ok(const at::Tensor& ids, const at::Tensor& table,
             const at::Tensor& x) {
  const auto dev = x.get_device();
  return x.is_cuda() && x.dim() >= 1 && x.numel() < INT_MAX &&
         ok(ids, at::kInt, 3, dev) && ok(table, at::kFloat, -1, dev) &&
         ids.size(0) == x.size(0) && ids.size(1) == 1 &&
         table.sizes().slice(1) == x.sizes().slice(1) && row(x) % 4 == 0;
}

// row_sum(ids, table, x, stream): kB, every row through the TMA ring.
PyObject* py_row_sum(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  void* stream;
  if (!ext::args_ok(nargs, 4, "row_sum") ||
      !ext::stream_arg(args, 3, &stream))
    return nullptr;
  const at::Tensor* ids = ext::tensor(args, 0);
  const at::Tensor* table = ext::tensor(args, 1);
  const at::Tensor* x = ext::tensor(args, 2);
  if (!ids || !table || !x) return nullptr;
  if (!rows_ok(*ids, *table, *x)) Py_RETURN_NONE;
  at::Tensor out = at::empty(x->sizes(), table->options());
  return launched(probe_row_sum(ids->data_ptr(), (int)ids->size(2),
                                table->data_ptr(), out.data_ptr(),
                                (int)x->size(0), row(*x), stream),
                  "row_sum", std::move(out));
  END_HANDLE_TH_ERRORS
}

// bag_sum(nbs, ids, table, x, stream): kD, the first nbs[b, 0] rows; kC
// with nbs None, all CK rows.
PyObject* py_bag_sum(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  void* stream;
  if (!ext::args_ok(nargs, 5, "bag_sum") ||
      !ext::stream_arg(args, 4, &stream))
    return nullptr;
  const at::Tensor* nbs =
      args[0] == Py_None ? nullptr : ext::tensor(args, 0);
  const at::Tensor* ids = ext::tensor(args, 1);
  const at::Tensor* table = ext::tensor(args, 2);
  const at::Tensor* x = ext::tensor(args, 3);
  if ((!nbs && args[0] != Py_None) || !ids || !table || !x) return nullptr;
  if (!rows_ok(*ids, *table, *x) ||
      (nbs && (!ok(*nbs, at::kInt, 2, x->get_device()) ||
               nbs->size(0) != x->size(0) || nbs->size(1) < 1)))
    Py_RETURN_NONE;
  at::Tensor out = at::empty(x->sizes(), table->options());
  return launched(probe_bag_sum(ids->data_ptr(), (int)ids->size(2),
                                nbs ? nbs->data_ptr() : nullptr,
                                nbs ? (int)nbs->size(1) : 0,
                                table->data_ptr(), out.data_ptr(),
                                (int)x->size(0), row(*x), stream),
                  "bag_sum", std::move(out));
  END_HANDLE_TH_ERRORS
}

// shift(x, op, s, stream): kE..kH on x (nb, R, C).
PyObject* py_shift(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int op, s;
  void* stream;
  if (!ext::args_ok(nargs, 4, "shift") || !ext::int_arg(args, 1, &op) ||
      !ext::int_arg(args, 2, &s) || !ext::stream_arg(args, 3, &stream))
    return nullptr;
  const at::Tensor* x = ext::tensor(args, 0);
  if (!x) return nullptr;
  if (!ok(*x, at::kFloat, 3, x->get_device())) Py_RETURN_NONE;
  at::Tensor out = at::empty_like(*x);
  return launched(probe_shift(x->data_ptr(), out.data_ptr(), (int)x->size(0),
                              (int)x->size(1), (int)x->size(2), op, s,
                              stream),
                  "shift", std::move(out));
  END_HANDLE_TH_ERRORS
}

// dummy(x, stream): P2, 2 x, x[b] a multiple of 4 floats.
PyObject* py_dummy(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  void* stream;
  if (!ext::args_ok(nargs, 2, "dummy") || !ext::stream_arg(args, 1, &stream))
    return nullptr;
  const at::Tensor* x = ext::tensor(args, 0);
  if (!x) return nullptr;
  if (!ok(*x, at::kFloat, -1, x->get_device()) || row(*x) % 4)
    Py_RETURN_NONE;
  at::Tensor out = at::empty_like(*x);
  return launched(probe_dummy(x->data_ptr(), out.data_ptr(), (int)x->size(0),
                              row(*x), stream),
                  "dummy", std::move(out));
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"dyn_loop", (PyCFunction)(void (*)(void))py_dyn_loop, METH_FASTCALL,
     "dyn_loop(nbs, x, stream) -> out or None (kA)"},
    {"row_sum", (PyCFunction)(void (*)(void))py_row_sum, METH_FASTCALL,
     "row_sum(ids, table, x, stream) -> out or None (kB)"},
    {"bag_sum", (PyCFunction)(void (*)(void))py_bag_sum, METH_FASTCALL,
     "bag_sum(nbs or None, ids, table, x, stream) -> out or None (kD, kC)"},
    {"shift", (PyCFunction)(void (*)(void))py_shift, METH_FASTCALL,
     "shift(x, op, s, stream) -> out or None (kE..kH)"},
    {"dummy", (PyCFunction)(void (*)(void))py_dummy, METH_FASTCALL,
     "dummy(x, stream) -> out or None (P2)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "probes",
                       "Launches of the probe kernels P1 and P2.", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_probes(void) { return PyModule_Create(&kModule); }
