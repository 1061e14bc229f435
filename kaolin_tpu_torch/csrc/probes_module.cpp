// Python entry points of the probe kernels P1, P2 and P3: the extension
// module ``probes``, built with probes.cu by kaolin_tpu_torch/_cuda.py::
// load_module and called by kaolin_tpu_torch/probes/_kernels.py.
//
// At the probes' shapes a kernel runs ~2 us on the device, less than the
// host spends to launch it from Python.  So each entry point takes the
// wrapper's tensors and the stream, tests the inputs, allocates the output
// with PyTorch's allocator and launches, all in C++: the host work of one
// PyTorch op, where ctypes, a test in Python and torch.empty_like cost
// more (PERF.md §6).  Only PyTorch's tensor and Python-binding headers are
// included, so the build takes seconds.
//
// Each returns the output (P3: whether it launched, as K3's entry).  An
// input the kernel does not take raises ValueError naming it; a refused
// launch raises RuntimeError with the cudaError, and PyTorch's errors (an
// allocation that fails) pass through as PyTorch raises them.

#include "spc_trace_entry.h"

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
int probe_trace_stage(const void* rays, const void* cell_rows,
                      const void* block_cells, const void* nb,
                      const void* block_ids, void* tn_out, void* tf_out,
                      void* pi_out, void* cnt_out, int nA, int rt, int cw,
                      int ckmax, int kbuf, float side, int with_exit,
                      int pidx_offset, int stage, void* stream);
}

namespace {

// Floats in one row t[b] (0 for no rows).
int row(const at::Tensor& t) {
  const int64_t nb = t.size(0);
  return nb ? (int)(t.numel() / nb) : 0;
}

// The test of one input: a contiguous, 16-byte aligned ``dtype`` tensor of
// ``ndim`` dims (any for -1, at least 1) on CUDA device ``dev``, with fewer
// than 2^31 elements (the kernels index with ints), or false with
// ValueError set.
bool ok(const at::Tensor& t, const char* name, at::ScalarType dtype,
        int64_t ndim, c10::DeviceIndex dev) {
  return ext::ranked(t, name, ndim >= 0 ? ndim : t.dim() ? t.dim() : 1) &&
         ext::shaped(t, name, dtype, dev, t.sizes()) &&
         ((reinterpret_cast<uintptr_t>(t.data_ptr()) & 15) == 0 ||
          ext::fail("%s: expected a 16-byte aligned tensor", name));
}

// nbs (nb, >= 1) int32 on ``dev`` (its column 0 is read), or false with
// ValueError set.
bool counts_ok(const at::Tensor& nbs, int64_t nb, c10::DeviceIndex dev) {
  return ok(nbs, "nbs", at::kInt, 2, dev) &&
         ((nbs.size(0) == nb && nbs.size(1) >= 1) ||
          ext::fail("nbs: expected %lld rows of at least one count, got %s",
                    (long long)nb, ext::tuple(nbs.sizes()).c_str()));
}

// x[b] a multiple of 4 floats (the kernels move float4s), or false with
// ValueError set.
bool rows_of_4(const at::Tensor& x, const char* entry) {
  return row(x) % 4 == 0 ||
         ext::fail("%s: x[b] must hold a multiple of 4 floats, got x %s",
                   entry, ext::tuple(x.sizes()).c_str());
}

PyObject* launched(int rc, const char* entry, at::Tensor&& out) {
  return ext::launch_ok(rc, entry) ? THPVariable_Wrap(std::move(out))
                                   : nullptr;
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
  if (!ok(*x, "x", at::kFloat, -1, dev) || !counts_ok(*nbs, x->size(0), dev) ||
      !rows_of_4(*x, "dyn_loop"))
    return nullptr;
  at::Tensor out = at::empty_like(*x);
  return launched(probe_dyn_loop(nbs->data_ptr(), (int)nbs->size(1),
                                 x->data_ptr(), out.data_ptr(),
                                 (int)x->size(0), row(*x), stream),
                  "dyn_loop", std::move(out));
  END_HANDLE_TH_ERRORS
}

// The row sums' shared test: ids (nb, 1, CK) int32, table rows shaped like
// x[b] float32, x (only its shape is read) on the same device; or false
// with ValueError set.
bool rows_ok(const at::Tensor& ids, const at::Tensor& table,
             const at::Tensor& x, const char* entry) {
  const auto dev = x.get_device();
  if (!x.is_cuda() || x.dim() < 1 || x.numel() >= INT_MAX)
    return ext::fail("x: expected a CUDA tensor of at least one dim in fewer "
                     "than 2^31 elements, got %s on %s",
                     ext::tuple(x.sizes()).c_str(), x.device().str().c_str());
  return ok(ids, "ids", at::kInt, 3, dev) &&
         ok(table, "table", at::kFloat, -1, dev) && rows_of_4(x, entry) &&
         ((ids.size(0) == x.size(0) && ids.size(1) == 1 &&
           table.sizes().slice(1) == x.sizes().slice(1)) ||
          ext::fail("%s: ids must be (%lld, 1, CK) and table rows shaped "
                    "like x[b]; got x %s, ids %s, table %s", entry,
                    (long long)x.size(0), ext::tuple(x.sizes()).c_str(),
                    ext::tuple(ids.sizes()).c_str(),
                    ext::tuple(table.sizes()).c_str()));
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
  if (!rows_ok(*ids, *table, *x, "row_sum")) return nullptr;
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
  if (!rows_ok(*ids, *table, *x, "bag_sum") ||
      (nbs && !counts_ok(*nbs, x->size(0), x->get_device())))
    return nullptr;
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
  if (!ok(*x, "x", at::kFloat, 3, x->get_device())) return nullptr;
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
  if (!ok(*x, "x", at::kFloat, -1, x->get_device()) ||
      !rows_of_4(*x, "dummy"))
    return nullptr;
  at::Tensor out = at::empty_like(*x);
  return launched(probe_dummy(x->data_ptr(), out.data_ptr(), (int)x->size(0),
                              row(*x), stream),
                  "dummy", std::move(out));
  END_HANDLE_TH_ERRORS
}

// trace_stage(rays, cell_rows, block_cells, nb, block_ids, t_near, t_far,
//             pidx, count, kbuf, side, with_exit, pidx_offset, stage,
//             stream) -> True or False: P3, K3's entry with a stage.
PyObject* py_trace_stage(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  k3::Args a;
  int stage;
  void* stream;
  if (!ext::args_ok(nargs, 15, "trace_stage") || !k3::read(args, &a) ||
      !ext::int_arg(args, 13, &stage) || !ext::stream_arg(args, 14, &stream))
    return nullptr;
  if (stage < 1 || stage > 6)
    return PyErr_Format(PyExc_ValueError, "trace_stage: stage must be 1-6, "
                        "got %d", stage);
  if (a.nA == 0) Py_RETURN_FALSE;
  void* const* p = a.p;
  if (!ext::launch_ok(
          probe_trace_stage(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                            p[8], a.nA, a.rt, a.cw, a.ckmax, a.kbuf, a.side,
                            a.with_exit, a.pidx_offset, stage, stream),
          "spc_trace_kernel"))
    return nullptr;
  Py_RETURN_TRUE;
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"dyn_loop", (PyCFunction)(void (*)(void))py_dyn_loop, METH_FASTCALL,
     "dyn_loop(nbs, x, stream) -> out (kA)"},
    {"row_sum", (PyCFunction)(void (*)(void))py_row_sum, METH_FASTCALL,
     "row_sum(ids, table, x, stream) -> out (kB)"},
    {"bag_sum", (PyCFunction)(void (*)(void))py_bag_sum, METH_FASTCALL,
     "bag_sum(nbs or None, ids, table, x, stream) -> out (kD, kC)"},
    {"shift", (PyCFunction)(void (*)(void))py_shift, METH_FASTCALL,
     "shift(x, op, s, stream) -> out (kE..kH)"},
    {"dummy", (PyCFunction)(void (*)(void))py_dummy, METH_FASTCALL,
     "dummy(x, stream) -> out (P2)"},
    {"trace_stage", (PyCFunction)(void (*)(void))py_trace_stage, METH_FASTCALL,
     "trace_stage(rays, cell_rows, block_cells, nb, block_ids, t_near, "
     "t_far, pidx, count, kbuf, side, with_exit, pidx_offset, stage, stream) "
     "-> launched (P3)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "probes",
                       "Launches of the probe kernels P1, P2 and P3.", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_probes(void) { return PyModule_Create(&kModule); }
